"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the public entry points, in phases,
one line each: the stable u32 key-value sort
``vkradixsort_tpu_torch.sort_pairs(keys, arange)`` on its default route (the
merge engine), the same call on ``backend="radix_tiled"``, and the
one-launch ``backend="fused"`` sort of a small array.

  1. probe the card (``nvidia-smi`` name and power limit);
  2. build the kernels from the sources in this checkout;
  3. hold each kernel bitwise against its plain PyTorch version on the card:
     the tile sort on tiles with heavy ties and a ragged last tile, the
     merge-path kernel on every level of a 1e6-element sort, the histogram
     and destination kernels and the fused sort on ragged sizes, ties, keys
     equal to the dtype's maximum and both key widths;
  4. the merge path: sort 1e6 pairs exactly against numpy's stable argsort,
     then 1e8 pairs with an exact check on the device, counting each
     kernel's launches;
  5. the radix_tiled path: the same at 1e6 and 1e8 (4 histogram and 4
     destination launches), with each pass's histogram and destination
     kernels held bitwise against their plain versions on that sort's own
     intermediate keys, and timed beside them, with the pass's index
     widening and scatter, and the peak device memory of the sort;
  6. the fused path at N = 32768: u32 pairs, then u64 keys with a u64
     payload, one launch each, bitwise against numpy, and timed;
  7. at the merge path's shapes, 1e6 and 1e8 pairs: hold the tile sort and
     every merge level bitwise against their plain versions on the same
     inputs and time both (CUDA events), and time the whole sort through
     the merge, radix_tiled and ``torch.sort`` routes, in turns.

Any failure raises and exits non-zero. The second-to-last line is a JSON
object describing each kernel: its launches on its main path, its largest
error against its plain version, its time, its plain version's time, the
least time the card could take (``bound_ms``: bytes moved over 3.35 TB/s)
and, where one PyTorch call computes the same function, that call's time,
all summed over the launches of one main-path run. The last is the run's
JSON result. Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

import vkradixsort_tpu_torch as vt
from vkradixsort_tpu_torch.ops import fused, histogram, kernels, merge, radix_tiled, reference
from vkradixsort_tpu_torch.ops.common import _MIN32, NUM_BINS, bits_view, cdiv, extract_digit
from vkradixsort_tpu_torch.utils.timing import measure_seconds_per_call

SEED = 0xBE7C
N_SMALL = 1_000_000
N_MAIN = 100_000_000
N_FUSED = 1 << 15
REPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events, after one
    untimed call."""
    fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float) -> float:
    """Least time the card takes to move ``nbytes`` of device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got: list, want: list) -> int:
    """Largest |kernel - plain| over all planes (int64); 0 when bitwise equal."""
    err = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        g, w = bits_view(g), bits_view(w)
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()))
    return err


def random_u32(dev, n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)


def check_stable_kv(keys_in: torch.Tensor, keys_out: torch.Tensor, vals_out: torch.Tensor) -> None:
    """Exact check of a stable sort of (keys_in, arange) on the device: keys
    non-decreasing, values a permutation of arange that maps keys_in onto
    keys_out, and values increasing within every run of equal keys. Together
    these admit exactly one answer, the stable sort."""
    n = keys_in.numel()
    k = keys_out.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    v = vals_out.view(torch.int32).to(torch.int64)
    if not bool((k[1:] >= k[:-1]).all()):
        raise AssertionError("output keys are not non-decreasing")
    if not bool(((v >= 0) & (v < n)).all()):
        raise AssertionError("output values leave [0, n)")
    seen = torch.zeros(n, dtype=torch.bool, device=v.device)
    seen[v] = True
    if not bool(seen.all()):
        raise AssertionError("output values are not a permutation of arange")
    if not torch.equal(keys_in.view(torch.int32)[v], keys_out.view(torch.int32)):
        raise AssertionError("keys_in[values_out] != keys_out")
    tie = k[1:] == k[:-1]
    if not bool((v[1:] > v[:-1])[tie].all()):
        raise AssertionError("equal keys are out of input order")


def check_numpy_kv(keys: np.ndarray, vals: np.ndarray, out_k, out_v, what: str) -> None:
    perm = np.argsort(keys, kind="stable")
    if not (np.array_equal(bits_view(out_k).cpu().numpy().view(keys.dtype), keys[perm])
            and np.array_equal(bits_view(out_v).cpu().numpy().view(vals.dtype), vals[perm])):
        raise AssertionError(f"{what} disagrees with np.argsort(kind='stable')")


def radix_keys(rng, n: int, dtype, kind: str) -> np.ndarray:
    """Keys for the radix kernels: "ties" (13 values, every byte alike),
    "max" (a fifth equal to the dtype's maximum) or "uniform"."""
    hi = np.iinfo(dtype).max
    if kind == "uniform":
        return rng.integers(0, int(hi), size=n, dtype=dtype, endpoint=True)
    keys = rng.integers(0, 13, size=n).astype(dtype)
    keys *= dtype(0x01010101 if dtype == np.uint32 else 0x0101010101010101)
    if kind == "max":
        keys[rng.random(n) < 0.2] = hi
    return keys


def compare_radix_kernels(dev, rng) -> dict:
    """The histogram, destination and fused kernels against their plain
    versions on ragged sizes, ties, dtype-max keys and both key widths."""
    err = {"histogram": 0, "radix_dest": 0, "fused": 0}
    for n, tile, dtype, kind in [(5 * 2048 + 17, 2048, np.uint32, "ties"),
                                 (300_001, 2048, np.uint64, "max"),
                                 (3001, 100, np.uint32, "max"),
                                 (1, 2048, np.uint64, "uniform")]:
        keys = torch.from_numpy(radix_keys(rng, n, dtype, kind)).to(dev)
        for shift in range(0, 8 * keys.element_size(), 8):
            hist = histogram.tile_histograms(keys, shift, tile)
            e_hist = max_abs_err([hist], [histogram.tile_histograms_plain(keys, shift, tile)])
            base = reference.exclusive_bin_offsets(hist)
            e_dest = max_abs_err([radix_tiled.tile_destinations(keys, shift, tile, base)],
                                 [radix_tiled.tile_destinations_plain(keys, shift, tile, base)])
            err["histogram"] = max(err["histogram"], e_hist)
            err["radix_dest"] = max(err["radix_dest"], e_dest)
        phase("compare", f"histogram + radix_dest n={n} tile={tile} {np.dtype(dtype).name} "
                         f"{kind}, every pass: max_abs_err {err['histogram']} / "
                         f"{err['radix_dest']}")
    for n, kdt, vdt, kind in [(N_FUSED, np.uint32, np.uint32, "ties"),
                              (N_FUSED - 5, np.uint64, np.uint64, "max"),
                              (1000, np.uint64, None, "uniform"),
                              (33, np.uint32, np.float32, "max")]:
        keys = torch.from_numpy(radix_keys(rng, n, kdt, kind)).to(dev)
        vals = None if vdt is None else torch.from_numpy(
            rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(vdt)).to(dev)
        got, want = fused.sort_fused(keys, vals), fused.sort_fused_plain(keys, vals)
        e = max_abs_err([x for x in got if x is not None], [x for x in want if x is not None])
        err["fused"] = max(err["fused"], e)
        phase("compare", f"fused n={n} keys {np.dtype(kdt).name} payload "
                         f"{None if vdt is None else np.dtype(vdt).name} {kind}: max_abs_err {e}")
    if any(err.values()):
        raise AssertionError(f"radix kernels disagree with their plain versions: {err}")
    return err


def radix_main_path(dev, rng, smi: str) -> tuple:
    """The radix_tiled path: 1e6 pairs against numpy, then 1e8 pairs through
    the public entry point with launch counts and peak memory, then each of
    the 1e8 sort's passes by hand: histogram and destination kernels
    bitwise against their plain versions on the pass's own keys, and timed
    beside them, with ``torch.bincount`` over the precomputed composite
    index as the histogram's library yardstick and the pass's index
    widening and scatter. Returns (launches, stats)."""
    small = rng.integers(0, 1 << 32, size=N_SMALL, dtype=np.uint32)
    sk, sv = vt.sort_pairs(torch.from_numpy(small).to(dev),
                           torch.arange(N_SMALL, dtype=torch.int32, device=dev).view(torch.uint32),
                           backend="radix_tiled")
    check_numpy_kv(small, np.arange(N_SMALL, dtype=np.uint32), sk, sv, "1e6 radix_tiled sort")
    phase("slice", f"sort_pairs n={N_SMALL} backend=radix_tiled: bitwise equal to numpy's "
                   "stable argsort")

    keys = random_u32(dev, N_MAIN, SEED)
    values = torch.arange(N_MAIN, dtype=torch.int32, device=dev).view(torch.uint32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    histogram.tile_histograms.launches = 0
    radix_tiled.tile_destinations.launches = 0
    out_k, out_v = vt.sort_pairs(keys, values, backend="radix_tiled")
    torch.cuda.synchronize()
    launches = {"histogram": histogram.tile_histograms.launches,
                "radix_dest": radix_tiled.tile_destinations.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    check_stable_kv(keys, out_k, out_v)
    phase("slice", f"sort_pairs n={N_MAIN} backend=radix_tiled: exact stable sort on the device; "
                   f"launches {launches}, expected 4 and 4; peak device memory {peak / 1e9:.3f} GB "
                   f"({before / 1e9:.3f} GB of it allocated before the call)")
    if launches != {"histogram": 4, "radix_dest": 4}:
        raise AssertionError(f"the radix_tiled path did not run through the kernels: {launches}")
    del out_k, out_v

    tile = vt.SortConfig().chunk
    nt = cdiv(N_MAIN, tile)
    st = {k: 0.0 for k in ("histogram", "histogram_plain", "histogram_library", "radix_dest",
                           "radix_dest_plain", "widen", "scatter")}
    err = {"histogram": 0, "radix_dest": 0}
    cur_k, cur_v = keys, values
    for shift in range(0, 32, 8):
        hist = histogram.tile_histograms(cur_k, shift, tile)
        err["histogram"] = max(err["histogram"], max_abs_err(
            [hist], [histogram.tile_histograms_plain(cur_k, shift, tile)]))
        base = reference.exclusive_bin_offsets(hist)
        dest = radix_tiled.tile_destinations(cur_k, shift, tile, base)
        err["radix_dest"] = max(err["radix_dest"], max_abs_err(
            [dest], [radix_tiled.tile_destinations_plain(cur_k, shift, tile, base)]))
        st["histogram"] += time_ms(lambda: histogram.tile_histograms(cur_k, shift, tile))
        st["histogram_plain"] += time_ms(
            lambda: histogram.tile_histograms_plain(cur_k, shift, tile), reps=3)
        composite = (torch.arange(N_MAIN, device=dev) // tile) * NUM_BINS + extract_digit(cur_k,
                                                                                         shift)
        st["histogram_library"] += time_ms(
            lambda: torch.bincount(composite, minlength=nt * NUM_BINS))
        del composite
        st["radix_dest"] += time_ms(lambda: radix_tiled.tile_destinations(cur_k, shift, tile, base))
        st["radix_dest_plain"] += time_ms(
            lambda: radix_tiled.tile_destinations_plain(cur_k, shift, tile, base), reps=3)
        st["widen"] += time_ms(lambda: dest.to(torch.int64))
        d64 = dest.to(torch.int64)
        st["scatter"] += time_ms(lambda: (reference.scatter(cur_k, d64),
                                          reference.scatter(cur_v, d64)))
        cur_k, cur_v = reference.scatter(cur_k, d64), reference.scatter(cur_v, d64)
        del d64, dest, base, hist
    check_stable_kv(keys, cur_k, cur_v)
    phase("compare", f"n={N_MAIN} tile={tile}, the 4 passes of the radix_tiled sort on their own "
                     f"keys: histogram max_abs_err {err['histogram']}, radix_dest max_abs_err "
                     f"{err['radix_dest']}; the passes by hand give the exact stable sort")
    if any(err.values()):
        raise AssertionError(f"radix kernels disagree with their plain versions at 1e8: {err}")
    phase("time", f"n={N_MAIN} radix_tiled, 4 passes summed: histogram {st['histogram']:.3f} ms "
                  f"(plain {st['histogram_plain']:.3f}, bincount {st['histogram_library']:.3f}); "
                  f"radix_dest {st['radix_dest']:.3f} ms (plain {st['radix_dest_plain']:.3f}); "
                  f"int32->int64 widening of dest {st['widen']:.3f} ms; scatter of keys and "
                  f"values {st['scatter']:.3f} ms [{smi}]")
    st["err"] = err
    st["peak_gb"] = peak / 1e9
    return launches, st


def fused_main_path(dev, rng, smi: str) -> tuple:
    """The fused path at N = 32768: u32 pairs and u64 keys with a u64
    payload through ``sort_pairs(backend="fused")``, one launch each,
    bitwise against numpy; then the kernel timed beside its plain version
    and ``torch.sort(stable=True)`` plus the payload's gather. Returns
    (launches of the u32 call, stats)."""
    calls = []
    for kdt, vdt in [(np.uint32, np.uint32), (np.uint64, np.uint64)]:
        keys = radix_keys(rng, N_FUSED, kdt, "uniform") >> kdt(3)  # some ties
        vals = rng.integers(0, np.iinfo(vdt).max, size=N_FUSED, dtype=vdt, endpoint=True)
        tk, tv = torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev)
        torch.cuda.synchronize()
        fused.sort_fused.launches = 0
        ok, ov = vt.sort_pairs(tk, tv, backend="fused")
        torch.cuda.synchronize()
        calls.append(fused.sort_fused.launches)
        check_numpy_kv(keys, vals, ok, ov, f"fused sort of {np.dtype(kdt).name} pairs")
    phase("slice", f"sort_pairs n={N_FUSED} backend=fused, u32 kv and u64 keys with a u64 payload: "
                   f"bitwise equal to numpy's stable argsort; launches {calls}, expected [1, 1]")
    if calls != [1, 1]:
        raise AssertionError(f"the fused path did not run through its kernel once: {calls}")

    keys = random_u32(dev, N_FUSED, SEED + 1)
    values = torch.arange(N_FUSED, dtype=torch.int32, device=dev).view(torch.uint32)
    got, want = fused.sort_fused(keys, values), fused.sort_fused_plain(keys, values)
    err = max_abs_err(list(got), list(want))
    if err:
        raise AssertionError(f"fused kernel disagrees with its plain version: {err}")

    def library():
        s, perm = torch.sort(keys.view(torch.int32) ^ _MIN32, stable=True)
        return s, values.view(torch.int32)[perm]

    st = {"fused": time_ms(lambda: fused.sort_fused(keys, values), reps=20),
          "fused_plain": time_ms(lambda: fused.sort_fused_plain(keys, values)),
          "fused_library": time_ms(library, reps=20), "err": err}
    phase("time", f"n={N_FUSED} u32 kv: fused {st['fused']:.4f} ms (plain "
                  f"{st['fused_plain']:.4f}, torch.sort + gather {st['fused_library']:.4f}); "
                  f"max_abs_err {err} [{smi}]")
    return calls[0], st


def time_main_path(dev, n: int, smi: str):
    """The merge path's kernels at ``n`` random u32 pairs, at the shapes the
    sort gives them: the tile sort of (key, value) planes at the default
    tile, then every merge level. Each is held bitwise against its plain
    version on the same inputs and timed beside it, and the tile sort beside
    ``torch.sort`` of the same rows carrying positions; then the whole
    stable kv sort is timed through the merge, radix_tiled and torch.sort
    routes, in turns. Raises if a kernel disagrees. Returns ({kernel: ms},
    {kernel: plain ms}, {kernel: max_abs_err}, tilesort library ms, merge
    levels), merge levels summed."""
    keys = random_u32(dev, n, SEED + n)
    values = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    tile = merge.default_tile(1, dev)
    planes = [keys.view(torch.int32) ^ _MIN32, values.view(torch.int32)]
    cur = merge.tilesort(planes, 1, tile)
    err = {"tilesort": max_abs_err(cur, merge.tilesort_plain(planes, 1, tile)), "mergepath": 0}
    ms = {"tilesort": time_ms(lambda: merge.tilesort(planes, 1, tile)), "mergepath": 0.0}
    plain_ms = {"tilesort": time_ms(lambda: merge.tilesort_plain(planes, 1, tile)),
                "mergepath": 0.0}
    rows = merge._padded(planes[0], cdiv(n, tile) * tile).view(-1, tile)
    library_ms = time_ms(lambda: torch.sort(rows, dim=1, stable=True))
    del rows
    level_ms = []
    run = tile
    while run < n:
        nxt = merge.mergepath_level(cur, 1, run)
        e = max_abs_err(nxt, merge.mergepath_level_plain(cur, 1, run))
        err["mergepath"] = max(err["mergepath"], e)
        k_ms = time_ms(lambda: merge.mergepath_level(cur, 1, run), reps=3)
        ms["mergepath"] += k_ms
        plain_ms["mergepath"] += time_ms(lambda: merge.mergepath_level_plain(cur, 1, run), reps=3)
        level_ms.append(round(k_ms, 3))
        cur, run = nxt, run * 2
    del cur, planes
    phase("compare", f"n={n} tile={tile}: tilesort max_abs_err {err['tilesort']}; "
                     f"mergepath {len(level_ms)} levels (runs {tile} to {run // 2}) "
                     f"max_abs_err {err['mergepath']}")
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions at n={n}: {err}")
    phase("time", f"n={n} tile={tile}: tilesort {ms['tilesort']:.3f} ms "
                  f"(plain {plain_ms['tilesort']:.3f}, torch.sort of the rows {library_ms:.3f}); "
                  f"mergepath {len(level_ms)} levels {ms['mergepath']:.3f} ms "
                  f"(plain {plain_ms['mergepath']:.3f}); per level ms {level_ms} [{smi}]")

    def route(backend):
        return lambda k, v: vt.sort_pairs(k, v, backend=backend)

    e2e = {"merge": [], "radix_tiled": [], "torch.sort": []}
    for name, backend in [("torch.sort", "tiled"), ("merge", "merge"),
                          ("radix_tiled", "radix_tiled"), ("radix_tiled", "radix_tiled"),
                          ("merge", "merge"), ("torch.sort", "tiled")]:
        e2e[name].append(measure_seconds_per_call(route(backend), keys, values, reps=REPS) * 1e3)
    for name, runs in e2e.items():
        phase("time", f"sort_pairs n={n} stable u32 kv via {name}: "
                      f"{' / '.join(f'{t:.3f}' for t in runs)} ms "
                      f"({n / (min(runs) / 1e3) / 1e6:.1f} M pairs/s best) [{smi}]")
    return ms, plain_ms, err, library_ms, len(level_ms)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = vt.GPUContext(dev).info
    phase("probe", f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}; {info}")
    if torch.cuda.device_count() != 1:
        raise RuntimeError(f"chip_smoke.py runs on one card and reports it; "
                           f"{torch.cuda.device_count()} are visible (set CUDA_VISIBLE_DEVICES)")

    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.load()
    phase("build", f"{time.perf_counter() - t0:.2f} s -> {lib.name}")

    # --- 3. each kernel against its plain version, bitwise, on the card
    rng = np.random.default_rng(SEED)
    err = {"tilesort": 0, "mergepath": 0}
    main_tile = merge.default_tile(1, dev)
    for nck, ncarry, n, tile in [(1, 1, 9 * main_tile + 777, main_tile),
                                 (1, 0, 3 * main_tile + 5, main_tile),
                                 (2, 2, 5 * 4096 + 1, 4096)]:
        keys = [rng.integers(-4, 4, size=n).astype(np.int32) for _ in range(nck)]
        keys[0][rng.random(n) < 0.1] = np.iinfo(np.int32).max  # keys equal to the pad
        planes = [torch.from_numpy(x).to(dev) for x in keys]
        planes += [torch.from_numpy(rng.integers(-(2**31), 2**31, size=n).astype(np.int32)).to(dev)
                   for _ in range(ncarry)]
        e = max_abs_err(merge.tilesort(planes, nck, tile), merge.tilesort_plain(planes, nck, tile))
        err["tilesort"] = max(err["tilesort"], e)
        phase("compare", f"tilesort nck={nck} ncarry={ncarry} n={n} tile={tile}: max_abs_err {e}")
    keys = torch.from_numpy(rng.integers(0, 1000, size=N_SMALL).astype(np.int32)).to(dev)
    vals = torch.arange(N_SMALL, dtype=torch.int32, device=dev)
    planes = merge.tilesort([keys, vals], 1, main_tile)
    run, levels = main_tile, 0
    while run < N_SMALL:
        got = merge.mergepath_level(planes, 1, run)
        e = max_abs_err(got, merge.mergepath_level_plain(planes, 1, run))
        err["mergepath"] = max(err["mergepath"], e)
        planes, run, levels = got, run * 2, levels + 1
    phase("compare", f"mergepath n={N_SMALL} tile={main_tile}: {levels} levels, "
                     f"max_abs_err {err['mergepath']}")
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions: {err}")
    err.update(compare_radix_kernels(dev, rng))

    # --- 4. the merge path through the public API
    small = rng.integers(0, 1 << 32, size=N_SMALL, dtype=np.uint32)
    sk, sv = vt.sort_pairs(torch.from_numpy(small).to(dev),
                           torch.arange(N_SMALL, device=dev).to(torch.int32).view(torch.uint32),
                           backend="merge")
    check_numpy_kv(small, np.arange(N_SMALL, dtype=np.uint32), sk, sv, "1e6 sort_pairs")
    phase("slice", f"sort_pairs n={N_SMALL} backend=merge: bitwise equal to numpy's stable argsort")

    keys = random_u32(dev, N_MAIN, SEED)
    values = torch.arange(N_MAIN, dtype=torch.int32, device=dev).view(torch.uint32)
    torch.cuda.synchronize()
    merge.tilesort.launches = 0
    merge.mergepath_level.launches = 0
    out_k, out_v = vt.sort_pairs(keys, values)
    torch.cuda.synchronize()
    launches = {"tilesort": merge.tilesort.launches, "mergepath": merge.mergepath_level.launches}
    nlev = math.ceil(math.log2(N_MAIN / main_tile))
    check_stable_kv(keys, out_k, out_v)
    phase("slice", f"sort_pairs n={N_MAIN} (default route): exact stable sort on the device; "
                   f"launches {launches}, expected tilesort 1 and mergepath {nlev}")
    if launches != {"tilesort": 1, "mergepath": nlev}:
        raise AssertionError(f"the main path did not run through the kernels: {launches}")
    del out_k, out_v, keys, values

    # --- 5. and 6. the radix_tiled and fused paths
    radix_launches, rst = radix_main_path(dev, rng, smi)
    launches.update(radix_launches)
    launches["fused"], fst = fused_main_path(dev, rng, smi)
    for k in ("histogram", "radix_dest"):
        err[k] = max(err[k], rst["err"][k])
    err["fused"] = max(err["fused"], fst["err"])

    # --- 7. times: merge kernels beside their plain versions, the routes in turns
    for n in (N_SMALL, N_MAIN):
        ms, plain_ms, e, tilesort_library_ms, nlevels = time_main_path(dev, n, smi)
        err = {k: max(err[k], e.get(k, 0)) for k in err}

    nt = cdiv(N_MAIN, vt.SortConfig().chunk)
    hist_bytes = 4 * (4 * N_MAIN + 4 * NUM_BINS * nt)  # keys in, table out; 4 passes
    dest_bytes = 4 * (4 * N_MAIN + 4 * NUM_BINS * nt + 4 * N_MAIN)  # keys and base in, dest out
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "tilesort", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/tilesort.cu",
         "replaces": "vkradixsort_tpu/ops/merge.py:311", "launches": launches["tilesort"],
         "max_abs_err": err["tilesort"], "ms": ms["tilesort"], "plain_ms": plain_ms["tilesort"],
         "bound_ms": bound_ms(16 * N_MAIN), "bound_by": "bytes",
         "library_ms": tilesort_library_ms},
        {"name": "mergepath", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/mergepath.cu",
         "replaces": "vkradixsort_tpu/ops/merge.py:655", "launches": launches["mergepath"],
         "max_abs_err": err["mergepath"], "ms": ms["mergepath"],
         "plain_ms": plain_ms["mergepath"], "bound_ms": bound_ms(16 * N_MAIN * nlevels),
         "bound_by": "bytes", "library_ms": None},
        {"name": "histogram", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/histogram.cu",
         "replaces": "vkradixsort_tpu/ops/histogram.py:54", "launches": launches["histogram"],
         "max_abs_err": err["histogram"], "ms": rst["histogram"],
         "plain_ms": rst["histogram_plain"], "bound_ms": bound_ms(hist_bytes),
         "bound_by": "bytes", "library_ms": rst["histogram_library"]},
        {"name": "radix_dest", "route": "cuda",
         "source": "vkradixsort_tpu_torch/csrc/radix_dest.cu",
         "replaces": "vkradixsort_tpu/ops/radix_tiled.py:86", "launches": launches["radix_dest"],
         "max_abs_err": err["radix_dest"], "ms": rst["radix_dest"],
         "plain_ms": rst["radix_dest_plain"], "bound_ms": bound_ms(dest_bytes),
         "bound_by": "bytes", "library_ms": None},
        {"name": "fused", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/fused.cu",
         "replaces": "vkradixsort_tpu/ops/fused.py:158", "launches": launches["fused"],
         "max_abs_err": err["fused"], "ms": fst["fused"], "plain_ms": fst["fused_plain"],
         "bound_ms": bound_ms(16 * N_FUSED), "bound_by": "bytes",
         "library_ms": fst["fused_library"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
