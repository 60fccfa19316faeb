"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the stable u32 key-value sort
``vkradixsort_tpu_torch.sort_pairs(keys, arange)``, through its public entry
point, in phases, one line each:

  1. probe the card (``nvidia-smi`` name and power limit);
  2. build the kernels from the sources in this checkout;
  3. hold each kernel bitwise against its plain PyTorch version on the card:
     the tile sort on tiles with heavy ties and a ragged last tile, the
     merge-path kernel on every level of a 1e6-element sort;
  4. sort 1e6 pairs exactly against numpy's stable argsort, then 1e8 pairs
     with an exact check on the device, counting each kernel's launches;
  5. at the main path's shapes, 1e6 and 1e8 pairs: hold the tile sort and
     every merge level bitwise against their plain versions on the same
     inputs and time both (CUDA events), and time the whole sort beside
     ``torch.sort(stable=True)`` carrying the payload; the kernel line
     reports the times at 1e8 and the largest error of all comparisons.

Any failure raises and exits non-zero. The second-to-last line is a JSON
object describing each kernel; the last is the run's JSON result. Without a
CUDA device, or without the package beside it, it exits non-zero and prints
no result.
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
from vkradixsort_tpu_torch.ops import kernels, merge
from vkradixsort_tpu_torch.ops.common import _MIN32
from vkradixsort_tpu_torch.utils.timing import measure_seconds_per_call

SEED = 0xBE7C
N_SMALL = 1_000_000
N_MAIN = 100_000_000
REPS = 5


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


def max_abs_err(got: list, want: list) -> int:
    """Largest |kernel - plain| over all planes (int64); 0 when bitwise equal."""
    err = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()))
    return err


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


def time_main_path(dev, n: int, smi: str):
    """The main path's kernels at ``n`` random u32 pairs, at the shapes the
    sort gives them: the tile sort of (key, value) planes at the default
    tile, then every merge level. Each is held bitwise against its plain
    version on the same inputs and timed beside it; then the whole stable kv
    sort is timed beside torch.sort. Raises if a kernel disagrees. Returns
    ({kernel: ms}, {kernel: plain ms}, {kernel: max_abs_err}), merge levels
    summed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    values = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    tile = merge.default_tile(1, dev)
    planes = [keys.view(torch.int32) ^ _MIN32, values.view(torch.int32)]
    cur = merge.tilesort(planes, 1, tile)
    err = {"tilesort": max_abs_err(cur, merge.tilesort_plain(planes, 1, tile)), "mergepath": 0}
    ms = {"tilesort": time_ms(lambda: merge.tilesort(planes, 1, tile)), "mergepath": 0.0}
    plain_ms = {"tilesort": time_ms(lambda: merge.tilesort_plain(planes, 1, tile)),
                "mergepath": 0.0}
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
                  f"(plain {plain_ms['tilesort']:.3f}); mergepath {len(level_ms)} levels "
                  f"{ms['mergepath']:.3f} ms (plain {plain_ms['mergepath']:.3f}); "
                  f"per level ms {level_ms} [{smi}]")

    def merge_engine(k, v):
        return vt.sort_pairs(k, v, backend="merge")

    def library(k, v):
        return vt.sort_pairs(k, v, backend="tiled")

    e2e = {"merge": [], "torch.sort": []}
    for name, fn in [("torch.sort", library), ("merge", merge_engine), ("merge", merge_engine),
                     ("torch.sort", library)]:
        e2e[name].append(measure_seconds_per_call(fn, keys, values, reps=REPS) * 1e3)
    for name, runs in e2e.items():
        phase("time", f"sort_pairs n={n} stable u32 kv via {name}: "
                      f"{' / '.join(f'{t:.3f}' for t in runs)} ms "
                      f"({n / (min(runs) / 1e3) / 1e6:.1f} M pairs/s best) [{smi}]")
    return ms, plain_ms, err


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

    # --- 4. the slice through the public API
    small = rng.integers(0, 1 << 32, size=N_SMALL, dtype=np.uint32)
    sk, sv = vt.sort_pairs(torch.from_numpy(small).to(dev),
                           torch.arange(N_SMALL, device=dev).to(torch.int32).view(torch.uint32),
                           backend="merge")
    perm = np.argsort(small, kind="stable")
    if not (np.array_equal(sk.cpu().numpy(), small[perm])
            and np.array_equal(sv.cpu().numpy(), perm.astype(np.uint32))):
        raise AssertionError("1e6 sort_pairs disagrees with np.argsort(kind='stable')")
    phase("slice", f"sort_pairs n={N_SMALL} backend=merge: bitwise equal to numpy's stable argsort")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    keys = torch.randint(-(2**31), 2**31, (N_MAIN,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
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
    del out_k, out_v

    # --- 5. times: kernels beside their plain versions, the sort beside torch.sort
    del keys, values
    for n in (N_SMALL, N_MAIN):
        ms, plain_ms, e = time_main_path(dev, n, smi)
        err = {k: max(err[k], e[k]) for k in err}
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "tilesort", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/tilesort.cu",
         "replaces": "vkradixsort_tpu/ops/merge.py:311", "launches": launches["tilesort"],
         "max_abs_err": err["tilesort"], "ms": ms["tilesort"], "plain_ms": plain_ms["tilesort"]},
        {"name": "mergepath", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/mergepath.cu",
         "replaces": "vkradixsort_tpu/ops/merge.py:655", "launches": launches["mergepath"],
         "max_abs_err": err["mergepath"], "ms": ms["mergepath"],
         "plain_ms": plain_ms["mergepath"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
