"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; the JSON lines last
    python3 chip_smoke.py --routes   # the route measurements alone

Drives the port's main paths through the public entry points, in phases,
one line each: the stable u32 key-value sort
``vkradixsort_tpu_torch.sort_pairs(keys, arange)`` on ``backend="merge"``
and on ``backend="radix_tiled"`` (one of them the default route at 1e8,
``engine/config.ROUTE_TABLE``), the one-launch ``backend="fused"`` sort of
a small array, ``backend="bitonic"`` and ``backend="samplesort"``, and the
distributed sort ``parallel.distributed.sort_sharded`` over 8 logical
shards of the card, over NCCL and along each axis of a 2 x 4 grid of
logical shards, and the dispatcher's other paths
(u64 Zipf kv, argsort, ``stable=False`` kv) on their default routes. The
1e8 sorts' outputs are also checked on the host, bitwise, against the
port's native host runtime (``vkradixsort_tpu_torch.native``), as the JAX
package's bench checks its 1e8 sort.

  1. probe the card (``nvidia-smi`` name and power limit);
  2. build the kernels from the sources in this checkout, and the host
     runtime with ``g++`` (the run fails without it: its numpy fallback is
     no oracle at 1e8);
  3. hold each kernel bitwise against its plain PyTorch version on the card:
     the tile sort on tiles with heavy ties and a ragged last tile, the
     merge-path kernel on every level of a 1e6-element sort, both at three
     compare planes too (u64 keys with ties and dtype-max keys, and a gidx
     plane, ragged, 0-2 carries), the histogram
     kernel, the rank-and-scatter kernel in both its modes (destinations
     only; keys and payloads of 0, 1, 2, 4 and 8 bytes moved), the onesweep
     sort's digit histogram and every pass and the fused sort on ragged
     sizes, ties, keys equal to the dtype's maximum, tiles taken in one
     round and in two, and both key widths;
  4. the merge path: sort 1e6 pairs exactly against numpy's stable argsort,
     then 1e8 pairs with an exact check on the device, counting each
     kernel's launches;
 4b. the merge path past the kernels' two carry planes: 1e8 u32 keys with
     a float32 and a u64 payload, and with three int32 payloads (a local
     index through the kernels, then a gather a payload), keys on the host
     whole and in 16 windows and every payload on the device, bitwise
     against the host runtime's stable argsort, tile-sort and merge-path
     launches counted, timed in turns against ``backend="tiled"``;
  5. the radix_tiled path: the same at 1e6 and 1e8 (the onesweep sort: 1
     digit-histogram and 4 pass launches, none of the per-pass API's); the 1e8
     sort's whole output on the host, bitwise against the host runtime's
     stable argsort (keys against ``keys[perm]``, values against ``perm``),
     and in ``bench.py``'s 16 windows of 1024, both ends included; the
     oracle's time at 1e8 and 1e7 beside numpy's stable argsort at 1e7,
     with the host's CPU model; a profiler
     trace of the 1e8 sort (its kernels by name: one digit histogram and 4
     onesweep passes; no torch indexing or scatter, no dtype conversion),
     the peak device memory and the time of the sort; the onesweep sort by
     kernel: the digit histogram and each pass bitwise against their plain
     versions on the pass's own input and timed beside their bounds, their
     plain versions and the pass's library answer (a stable ``torch.sort``
     of its 8-bit digit and the gathers of keys and values, bitwise equal),
     with the pass kernel's shape and blocks resident on each SM; then the
     per-pass API (the JAX package's twins, off the sort route): each
     pass's histogram kernel and both modes of the rank-and-scatter kernel
     held bitwise against their plain versions on that sort's own
     intermediate keys and timed beside them (histogram, scan,
     rank-and-scatter, per pass), with the same library answer, and its
     chunk swept (2048 to 16384, the kernels by pass);
  6. the fused path at N = 32768: u32 pairs, then u64 keys with a u64
     payload, one launch each, bitwise against numpy, and timed steadied
     (batches of 100 back-to-back calls) beside ``torch.sort`` plus the
     payload's gather;
  7. at the merge path's shapes, 1e6 and 1e8 pairs: hold the tile sort and
     every merge level bitwise against their plain versions on the same
     inputs and time both (CUDA events) and beside ``torch.sort`` of the
     same tiles and run pairs, each merge level's ms and TB/s, and time the
     whole sort through the merge, radix_tiled and ``torch.sort`` routes, in
     turns; then the tile sweep at 1e8 (tile-sort tile 8192 against 16384,
     the kernel alone and the whole ``sort_pairs`` in turns; results
     bitwise equal across tiles); the merge kernel's output tile (2048, 4096
     and 8192, where it fits) summed over every level of a 1e8 sort at 1,
     2, 3 and 4 planes (u32 keys; u32 kv; u32 kv with two payloads and u64
     keys; u64 keys with a u64 payload), results bitwise equal across
     tiles; the co-rank mirror ``coranks_plain``
     against the merge kernel's own splits at one 1e8 level; at
     n = 2^31 + 4097 (one key plane) the tile sort's last tiles and one
     merge level's last run pairs bitwise against their plain versions run
     on those slices alone; and the onesweep sort at n = 2^31 - 1 (u32 keys
     n - 1 - i to arange, bitwise);
  8. the bitonic path: its kernels bitwise against their plain version on
     ragged sizes below one tile, one tile, sizes that need global groups
     and levels that end on every remainder of their global distances
     modulo the group size, ties, dtype-max keys, u64 keys and several
     payloads, each with the launch counts ``bitonic.plan`` gives; then
     ``backend="bitonic"`` at its size contract (u32 keys at 2^22, stable
     u32 kv at 1,398,101, u64 keys with a u64 payload at 838,860), bitwise
     against numpy with every launch counted; the in-block tile swept (8192
     against 16384) at the three shapes; the kernels timed steadied at the
     kv shape, and by part (first in-block pass, later in-block passes,
     global groups, gather); the whole sorts beside ``torch.sort`` in
     turns;
  9. the samplesort path: the placement kernel bitwise against its plain
     version on a small case and on the 1e8 kv sort's own rows, starts and
     lengths, and timed there; a forced-overflow sort (the flat fallback);
     ``backend="samplesort"`` kv and keys at 1e8 (exact on the device) and
     u64 keys at 1e6 (bitwise against numpy), one placement launch each, so
     no fallback; the whole sorts beside ``torch.sort`` in turns;
 10. the crossovers behind ``ROUTE_TABLE``: stable u32 kv with one 4-byte
     payload and u32 keys alone through ``torch.sort`` (tiled), merge and
     radix_tiled, and kv with two 4-byte payloads through tiled and merge,
     at 2^16 to 2^26 and 1e8, in turns in this one process, each beside the
     engine the table picks; then the dispatcher's other operations the same
     way through tiled, merge and radix_tiled: u32 argsort, ``stable=False``
     u32 kv (beside the kv row, which it reads), and on u64 keys, full-width
     uniform and Zipf (BASELINE.json config 4), keys alone, kv with one
     4-byte payload and argsort; and (10c) the crossovers behind
     the kvw, kvw64 and kv2 rows (``wide_crossovers``: tiled against
     radix_tiled with the benchmark's five lineitem columns, three 4-byte
     columns, two, and one of 1, 2 or 8 bytes, on u32 and u64 keys, uniform
     and Zipf), one payload of
     1, 2, 4 or 8 bytes carried through the onesweep passes against sorted
     as positions and gathered (``carry_or_gather``, behind
     ``radix_tiled.CARRY_MAX_BYTES``), and the column gather
     (``gather_parts``: the lineitem set at 1e8 bitwise its plain version,
     beside its bound, its plain version and torch's indexing a column, and
     one and eight columns of each width);
 11. the distributed sort: ``sort_sharded`` over ``LocalMesh([cuda:0] *
     8)`` at 1e8 stable u32 kv, overlap_chunks 1 and 2, local engine "xla"
     and "merge", each exact on the device with no overflow, balance <=
     1.25, its tile-sort and merge-path launches (exactly as many as its
     local sorts need) and peak memory, the device ms by step (a profiler
     trace of the body's ``vkrs/sort_sharded/<step>`` spans) beside one
     ``sort_pairs``; on the merge runs, the tile sort and every merge level
     bitwise against their plain versions on the very planes the run gives
     the merge engine (a shard's local sort and its final sort, default
     tiles and output tiles); ``dryrun_multichip(8)`` on the card; u64 Zipf
     kv at 1e7 on the merge engine (three compare planes) against numpy,
     its merge inputs checked the same way; ``GroupMesh`` on NCCL at world
     size 1 at 1e8, exact, and ``GroupMesh2D((1, 1))`` along "chip" there
     (a process group for its row and its column), bitwise equal to it;
     the tile sort and merge levels at two and three
     compare planes on one 1.25e7 shard, bitwise against their plain
     versions and timed; and
     the crossovers behind ``ROUTE_TABLE["dist_local"]``: the local (key,
     gidx) sort with one payload through "xla" and "merge", 2^16 to 2^24
     (u32 keys) and 2^26 (u64 keys), in turns;
11b. the distributed sort along one axis of a 2-D mesh: ``GPUContext.mesh_2d``
     ((1, 1), and its ValueError for a card too many), then 1e8 stable u32
     kv over ``LocalMesh2D([[cuda:0] * 4] * 2)`` along "chip" (P = 4, 2
     replicas) and "host" (P = 2, 4 replicas) on the default local engine
     (merge): every replica exact on the device with no overflow and
     balance <= 1.25, every replica bitwise equal to ``sort_sharded`` over
     ``LocalMesh([cuda:0] * P)`` (padded shards, counts, flags), tile-sort
     and merge-path launches exactly replicas x the 1-D run's, the kernels
     against their plain versions on the planes the 2-D run gives them,
     device ms of the whole call beside the 1-D sort, peak memory; counts
     and flags of one replica's shape, (P,), and ``gather_sorted`` without
     ``mesh=`` bitwise equal to the ``mesh=`` form and to the host
     runtime's stable argsort;
 12. the dispatcher's other paths at 1e8 through the public entry points on
     their default routes, each exact on the device with its kernel
     launches counted and timed beside ``torch.sort``: stable kv of u64 Zipf
     keys (BASELINE.json config 4 at the bench size), argsort of u32 and of
     u64 Zipf keys, ``stable=False`` u32 kv, and stable kv of uniform u64
     keys with the five lineitem columns (row kvw64: every column bitwise
     the tiled route's answer), the kv sorts' keys also on
     the host, whole and in 16 windows, bitwise against the host runtime's
     radix oracle sort; then each of the 8 passes of the per-pass API's
     sort of the u64 Zipf keys, and of uniform u64 keys, on the sort's own
     intermediate keys: the histogram and rank-and-scatter kernels bitwise
     against their plain versions, timed beside their bounds, with the share
     of the pass's most common digit; and the onesweep sort of the same keys
     by kernel, as in phase 5;
 13. the reference's own fixtures from the host runtime (1e6 mt19937 keys
     in its 28-bit range, and the descending sequence) through
     ``sort_pairs`` on the default route and on radix_tiled, bitwise
     against the oracle, and the seconds the host checks added to the run;
 14. the port's benchmark, ``python -m vkradixsort_tpu_torch.bench`` at
     1e8, as a subprocess: exit code 0, exactly one JSON line on stdout
     with the contract's four keys and a value above 0, its 1e8 sort's
     kernel launches (from its stderr) those of the default route, and its
     value beside N over phase 5's radix_tiled sort.

With ``--routes`` it runs only the measurements behind the ROUTE_TABLE rows
(phase 10c, ``route_crossovers`` of phase 10, ``dist_local_crossovers`` of
phase 11, ``radix_passes_u64`` of phase 12, the onesweep's parts on u64 keys
included), for repeated runs, and prints no JSON
line. Any failure raises and exits non-zero. The second-to-last line is a JSON
object describing each kernel: its launches on its main path, its largest
error against its plain version, its time, its plain version's time, the
least time the card could take (``bound_ms``: the larger of the bytes moved
over the card's HBM peak in ``sortbench/peaks.json`` and, for the bitonic
network, its compares over 67 T/s) and,
where one PyTorch call computes the same function, that call's time, all
summed over the launches of one main-path run (the tile-sort and merge-path
entries also carry their launches in the distributed sort's C = 1 merge
run, along each axis of phase 11b's 2-D mesh and in phase 4b's wide
payload sorts, and their ms at two and three compare planes on one
shard); the
bitonic and fused entries also quote their times before their redesign and the radix_dest
entry the parts it replaced (destinations, widening, torch scatter), from
PERF.md, as text; the histogram and radix_dest entries (the per-pass API,
off the sort route) and the digit_histograms and onesweep_pass entries (the
sort route) add their ms on the 1e8 u64 Zipf sort with its bound, and on
uniform u64 keys, and their launches in phase 14's benchmark run; the
gather_columns entry (no TPU kernel: it moves a wide payload set after
radix_tiled's sort of positions) takes its launches from phase 12's
lineitem sort on its default route, its ms from the lineitem set at 1e8
through a random permutation, and adds its ms by width and column count. The last is the run's JSON
result. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import vkradixsort_tpu_torch as vt
from vkradixsort_tpu_torch import native
from vkradixsort_tpu_torch.engine.config import route_for
from vkradixsort_tpu_torch.ops import (
    bitonic,
    fused,
    gather,
    histogram,
    kernels,
    merge,
    radix_tiled,
    reference,
    samplesort,
    segsort,
)
from vkradixsort_tpu_torch.ops.common import (
    _MIN32,
    NUM_BINS,
    bits_view,
    cdiv,
    extract_digit,
    positions,
    take,
)
from vkradixsort_tpu_torch.utils import profiling
from vkradixsort_tpu_torch.utils.fixtures import make_keys
from vkradixsort_tpu_torch.utils.timing import measure_seconds_per_call

SEED = 0xBE7C
N_SMALL = 1_000_000
N_MAIN = 100_000_000
N_FUSED = 1 << 15
N_BITONIC_KEYS = 1 << 22  # the bitonic engine's size contract at one plane,
N_BITONIC_KV = 1_398_101  # at three (stable u32 kv)
N_BITONIC_KV64 = 838_860  # and at five (u64 keys, u64 payload)
N_ORACLE_SMALL = 10_000_000  # where numpy's stable argsort is timed beside the oracle
ORACLE_WINDOWS, ORACLE_WIDTH = 16, 1024  # bench.py's window gate
REPS = 5
PEAKS = pathlib.Path(__file__).resolve().parent / "sortbench" / "peaks.json"
PLAIN_OPS_PER_S = 67e12  # H100 SXM 32-bit arithmetic outside the tensor cores (data sheet)
# this script's names for the kernel wrappers' launch counters (launch.<wrapper>)
LAUNCH = {"tilesort": "tilesort", "mergepath": "mergepath_level", "histogram": "tile_histograms",
          "radix_scatter": "tile_scatter", "radix_dest": "tile_destinations",
          "digit_histograms": "digit_histograms", "onesweep": "onesweep_pass",
          "fused": "sort_fused", "placement": "place_runs", "gather_columns": "gather_columns"}


def launches_since(before: dict, *kernels_: str) -> dict:
    """The launches of each of ``kernels_`` (keys of :data:`LAUNCH`) since the
    counter snapshot ``before`` (``profiling.counters()``)."""
    moved = profiling.since(before)
    return {k: moved.get("launch." + LAUNCH[k], 0) for k in kernels_}


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


def time_batched_ms(fn, calls: int = 100, batches: int = 5) -> float:
    """Steady device milliseconds of one ``fn()``: the median over
    ``batches`` of ``calls`` back-to-back calls between one event pair,
    divided by ``calls``, after one untimed call. At small sizes a single
    call's time is mostly launch noise; a batch is what a caller that sorts
    many small arrays sees."""
    fn()
    pairs = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / calls for s, e in pairs)


@functools.cache
def hbm_bytes_per_s() -> float:
    """The card's device-memory peak, from the benchmark's table of peaks
    (:data:`PEAKS`); a card not listed there fails the run."""
    name = torch.cuda.get_device_name(0)
    peak = json.loads(PEAKS.read_text()).get(name, {}).get("hbm_bytes_per_s")
    if peak is None:
        raise SystemExit(f"no hbm_bytes_per_s for {name!r} in {PEAKS}")
    return peak


def bound_ms(nbytes: float) -> float:
    """Least time the card takes to move ``nbytes`` of device memory."""
    return nbytes / hbm_bytes_per_s() * 1e3


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


def check_kv(keys_in: torch.Tensor, keys_out: torch.Tensor, vals_out: torch.Tensor,
             stable: bool = True) -> None:
    """Exact check of a sort of (keys_in, arange) on the device, u32 or u64
    keys, in their signed-order view: keys non-decreasing, values a
    permutation of arange that maps keys_in onto keys_out, and, when
    ``stable``, values increasing within every run of equal keys. Together
    these admit exactly one answer, the stable sort; without the last, every
    valid unstable answer."""
    n = keys_in.numel()
    k = segsort.to_signed_order(keys_out)
    v = bits_view(vals_out).to(torch.int64)
    if not bool((k[1:] >= k[:-1]).all()):
        raise AssertionError("output keys are not non-decreasing")
    if not bool(((v >= 0) & (v < n)).all()):
        raise AssertionError("output values leave [0, n)")
    seen = torch.zeros(n, dtype=torch.bool, device=v.device)
    seen[v] = True
    if not bool(seen.all()):
        raise AssertionError("output values are not a permutation of arange")
    if not torch.equal(bits_view(keys_in)[v], bits_view(keys_out)):
        raise AssertionError("keys_in[values_out] != keys_out")
    tie = k[1:] == k[:-1]
    if stable and not bool((v[1:] > v[:-1])[tie].all()):
        raise AssertionError("equal keys are out of input order")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors of one dtype (torch compares no
    unsigned tensors on the card)."""
    return a.dtype == b.dtype and torch.equal(bits_view(a), bits_view(b))


def check_numpy_kv(keys: np.ndarray, vals: np.ndarray, out_k, out_v, what: str) -> None:
    perm = np.argsort(keys, kind="stable")
    if not (np.array_equal(bits_view(out_k).cpu().numpy().view(keys.dtype), keys[perm])
            and np.array_equal(bits_view(out_v).cpu().numpy().view(vals.dtype), vals[perm])):
        raise AssertionError(f"{what} disagrees with np.argsort(kind='stable')")


def host_bits(x: torch.Tensor) -> np.ndarray:
    """A 4- or 8-byte tensor's bits on the host, as numpy's unsigned dtype
    of that width."""
    b = bits_view(x).cpu().numpy()
    return b.view(np.uint32 if b.itemsize == 4 else np.uint64)


def host_cpu() -> str:
    """The host's CPU model, with its vendor, family, model number and clock
    (``/proc/cpuinfo``; a sandboxed host may report the name as unknown),
    and ``os.cpu_count()``."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            if not key.strip():
                break  # the first processor's block ends at a blank line
            fields.setdefault(key.strip(), value.strip())
    cpu = ", ".join(f"{k} {fields.get(k, '?')}" for k in ("vendor_id", "cpu family", "model",
                                                          "cpu MHz"))
    return f"{fields.get('model name', '?')} ({cpu}), os.cpu_count() {os.cpu_count()}"


def require_equal(what: str, got: np.ndarray, want: np.ndarray) -> None:
    """Raise unless ``got`` equals ``want`` bitwise (the host runtime's
    ``first_mismatch``, the reference's testSort)."""
    i = native.first_mismatch(got, want)
    if i != -1:
        raise AssertionError(f"{what}: first mismatch at {i}: {got[i]} against {want[i]}")


def oracle_windows(what: str, got_k, want_k, got_v=None, want_v=None) -> None:
    """bench.py's gate (``window_oracle_checks``): 16 windows of 1024, the
    first and the last included, keys (and values) bitwise."""
    n = got_k.size
    starts = np.sort(np.random.default_rng(SEED).integers(0, n - ORACLE_WIDTH,
                                                          size=ORACLE_WINDOWS))
    starts[0], starts[-1] = 0, n - ORACLE_WIDTH
    for s in starts.tolist():
        w = slice(s, s + ORACLE_WIDTH)
        require_equal(f"{what}, key window [{w.start}, {w.stop})", got_k[w], want_k[w])
        if got_v is not None:
            require_equal(f"{what}, value window [{w.start}, {w.stop})", got_v[w], want_v[w])


def oracle_main_path(keys, out_k, out_v, route: str, smi: str) -> float:
    """The 1e8 stable u32 kv sort of phase 5 on the host: its whole output
    bitwise against the host runtime's stable argsort (keys against
    ``keys[perm]``, values against ``perm``) and in bench.py's 16 windows;
    then the oracle's time at 1e8 and 1e7 beside numpy's stable argsort at
    1e7. Returns the seconds it took."""
    t0 = time.perf_counter()
    keys_h, got_k, got_v = host_bits(keys), host_bits(out_k), host_bits(out_v)
    copy_s = time.perf_counter() - t0
    t = time.perf_counter()
    perm = native.oracle_argsort(keys_h)
    argsort_s = time.perf_counter() - t
    t = time.perf_counter()
    want_k = keys_h[perm]
    what = f"sort_pairs n={keys_h.size} stable u32 kv on {route}"
    require_equal(f"{what}, keys", got_k, want_k)
    require_equal(f"{what}, values", got_v, perm)
    oracle_windows(what, got_k, want_k, got_v, perm)
    check_s = time.perf_counter() - t
    phase("oracle", f"{what}: the whole output bitwise equal to the host runtime's stable "
                    f"argsort, keys and values, and in bench.py's {ORACLE_WINDOWS} windows of "
                    f"{ORACLE_WIDTH}; device-to-host copies {copy_s:.3f} s, oracle_argsort "
                    f"{argsort_s:.3f} s, gather and compares {check_s:.3f} s")
    del got_k, got_v, want_k, perm
    small = keys_h[:N_ORACLE_SMALL]
    t = time.perf_counter()
    perm = native.oracle_argsort(small)
    small_s = time.perf_counter() - t
    t = time.perf_counter()
    np_perm = np.argsort(small, kind="stable")
    numpy_s = time.perf_counter() - t
    require_equal(f"oracle_argsort n={small.size} against numpy's", perm,
                  np_perm.astype(np.uint32))
    phase("oracle", f"host stable argsort of uniform u32 keys: oracle_argsort n={keys_h.size} "
                    f"{argsort_s:.3f} s, n={small.size} {small_s:.3f} s; np.argsort(kind="
                    f"'stable') n={small.size} {numpy_s:.3f} s ({numpy_s / small_s:.1f}x the "
                    f"oracle), equal [host: {host_cpu()}] [{smi}]")
    return time.perf_counter() - t0


def oracle_sorted_keys(what: str, keys, out_k, smi: str) -> float:
    """The sorted keys of a 1e8 sort, whole and in bench.py's windows,
    bitwise against the host runtime's radix oracle sort of its input keys.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    keys_h, got_k = host_bits(keys), host_bits(out_k)
    t = time.perf_counter()
    want = native.oracle_sort(keys_h, "radix")
    sort_s = time.perf_counter() - t
    require_equal(f"{what}, keys", got_k, want)
    oracle_windows(what, got_k, want)
    total = time.perf_counter() - t0
    phase("oracle", f"{what} n={keys_h.size}: sorted keys bitwise equal to oracle_sort(keys, "
                    f"'radix'), whole and in {ORACLE_WINDOWS} windows; oracle_sort "
                    f"{sort_s:.3f} s, {total:.3f} s in all [host: {host_cpu()}]")
    return total


def oracle_fixtures(dev, smi: str) -> float:
    """The reference's own fixtures (SingleRadixSort.cpp:85-98) from the
    host runtime: 1e6 uniform keys in its 28-bit range from the seeded
    mt19937 grid, and the descending sequence, each through ``sort_pairs``
    with an arange payload on the default route and on radix_tiled, bitwise
    against ``oracle_sort`` (keys) and ``oracle_argsort`` (values), and
    ``first_unsorted``. Returns the seconds it took."""
    t0 = time.perf_counter()
    values = torch.arange(N_SMALL, dtype=torch.int32, device=dev).view(torch.uint32)
    fixtures = {"uniform 28-bit": native.generate_uniform(SEED, N_SMALL),
                "descending": native.generate_descending(N_SMALL)}
    for name, keys in fixtures.items():
        want_k, perm = native.oracle_sort(keys, "radix"), native.oracle_argsort(keys)
        require_equal(f"fixture {name}: the two oracles", keys[perm], want_k)
        routes = []
        for backend in (None, "radix_tiled"):
            ok, ov = vt.sort_pairs(torch.from_numpy(keys).to(dev), values, backend=backend)
            got_k, got_v = host_bits(ok), host_bits(ov)
            what = f"fixture {name} n={N_SMALL} backend={backend}"
            require_equal(f"{what}, keys", got_k, want_k)
            require_equal(f"{what}, values", got_v, perm)
            if native.first_unsorted(got_k) != -1:
                raise AssertionError(f"{what}: unsorted at {native.first_unsorted(got_k)}")
            routes.append(backend or f"default ({route_for('kv', N_SMALL)})")
        phase("oracle", f"reference fixture {name} n={N_SMALL} (keys {int(keys.min())} to "
                        f"{int(keys.max())}), sort_pairs on {' and '.join(routes)}: keys equal "
                        "oracle_sort, values oracle_argsort, first_unsorted -1")
    return time.perf_counter() - t0


def merge_wide_payloads(dev, smi: str) -> dict:
    """The merge path with payload sets past the kernels' two carry planes,
    at the bench size: ``sort_pairs(keys_u32, payloads, backend="merge")``
    with a float32 and a u64 payload (the JAX package's
    ``tests/test_merge.py`` set) and with three int32 payloads, each a local
    index through one tile sort and the merge levels, then a gather a
    payload. Each launches the tile-sort and merge-path kernels as a kv sort
    does (``counted``); its keys on the host, whole and in bench.py's
    windows, and every payload on the device, bitwise against the host
    runtime's stable argsort of the keys; timed in turns against
    ``backend="tiled"`` on the same call. Returns {set: launches}."""
    t_phase = time.perf_counter()
    n = N_MAIN
    keys = random_u32(dev, n, SEED + 41)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    cases = {
        "float32 + u64": (torch.randn(n, generator=gen, device=dev),
                          random_u64(dev, n, SEED + 43)),
        "3 x int32": tuple(random_u32(dev, n, SEED + 44 + i).view(torch.int32)
                           for i in range(3)),
    }
    t0 = time.perf_counter()
    keys_h = host_bits(keys)
    perm = native.oracle_argsort(keys_h)
    want_k = keys_h[perm]
    perm_dev = torch.from_numpy(perm.view(np.int32)).to(dev).to(torch.int64)
    oracle_s = time.perf_counter() - t0
    want_launches = expected_launches("merge", n, False, dev)
    launches = {}
    for name, vals in cases.items():
        what = f"sort_pairs n={n} u32 keys, {name} payloads, backend=merge"
        (out_k, out_v), got = counted(lambda: vt.sort_pairs(keys, vals, backend="merge"))
        if got != want_launches:
            raise AssertionError(f"{what}: launches {got}, expected {want_launches}")
        t0 = time.perf_counter()
        got_k = host_bits(out_k)
        require_equal(f"{what}, keys", got_k, want_k)
        oracle_windows(what, got_k, want_k)
        oracle_s += time.perf_counter() - t0
        for j, (o, v) in enumerate(zip(out_v, vals)):
            if not same_bits(o, take(v, perm_dev)):
                raise AssertionError(f"{what}: payload {j} differs from the oracle's order")
        del out_k, out_v, got_k
        t = turns({"merge": lambda k: vt.sort_pairs(k, vals, backend="merge"),
                   "tiled": lambda k: vt.sort_pairs(k, vals, backend="tiled")}, keys, fresh=True)
        launches[name] = got
        phase("slice", f"{what}: keys whole and in {ORACLE_WINDOWS} windows, every payload "
                       f"whole, bitwise against the host runtime's stable argsort; launches "
                       f"{got}; merge {' / '.join(f'{x:.3f}' for x in t['merge'])} ms, tiled "
                       f"{' / '.join(f'{x:.3f}' for x in t['tiled'])} ms (in turns, fresh "
                       f"remixes) [{smi}]")
    phase("time", f"phase 4b took {time.perf_counter() - t_phase:.2f} s of host, "
                  f"{oracle_s:.3f} of it the oracle and the key checks")
    return launches


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


def radix_payload(rng, n: int, dtype):
    """n random values of a 1-, 2-, 4- or 8-byte dtype (any bit pattern)."""
    return rng.integers(0, 2**64, size=n, dtype=np.uint64).view(np.uint8)[
        : n * np.dtype(dtype).itemsize].view(dtype).copy()


def compare_radix_kernels(dev, rng) -> dict:
    """The histogram kernel, both modes of the rank-and-scatter kernel, the
    onesweep sort's two kernels (every pass) and the fused kernel against
    their plain versions on ragged sizes, ties, dtype-max keys, both key
    widths, payloads of 0, 1, 2, 4 and 8 bytes and tiles taken in one round
    and in two."""
    err = {"histogram": 0, "radix_dest": 0, "onesweep": 0, "fused": 0}
    for n, tile, dtype, kind, vdt in [(5 * 2048 + 17, 2048, np.uint32, "ties", np.uint16),
                                      (300_001, 2048, np.uint64, "max", np.uint64),
                                      (3001, 100, np.uint32, "max", None),
                                      (1, 2048, np.uint64, "uniform", np.uint8),
                                      (70_001, 8192, np.uint32, "uniform", np.float32),
                                      (70_001, 8192, np.uint64, "ties", np.uint64),
                                      (40_000, 16384, np.uint32, "max", np.uint32)]:
        keys = torch.from_numpy(radix_keys(rng, n, dtype, kind)).to(dev)
        vals = None if vdt is None else torch.from_numpy(radix_payload(rng, n, vdt)).to(dev)
        for shift in range(0, 8 * keys.element_size(), 8):
            hist = histogram.tile_histograms(keys, shift, tile)
            e_hist = max_abs_err([hist], [histogram.tile_histograms_plain(keys, shift, tile)])
            base = reference.exclusive_bin_offsets(hist)
            e_dest = max_abs_err([radix_tiled.tile_destinations(keys, shift, tile, base)],
                                 [radix_tiled.tile_destinations_plain(keys, shift, tile, base)])
            got = radix_tiled.tile_scatter(keys, vals, shift, tile, base)
            want = radix_tiled.tile_scatter_plain(keys, vals, shift, tile, base)
            e_move = max_abs_err([x for x in got if x is not None],
                                 [x for x in want if x is not None])
            err["histogram"] = max(err["histogram"], e_hist)
            err["radix_dest"] = max(err["radix_dest"], e_dest, e_move)
        offsets = histogram.digit_histograms(keys)
        e_one = max_abs_err([offsets], [histogram.digit_histograms_plain(keys)])
        cur_k, cur_v = keys, vals
        for shift in range(0, 8 * keys.element_size(), 8):
            got = radix_tiled.onesweep_pass(cur_k, cur_v, shift, offsets[shift // 8])
            want = radix_tiled.onesweep_pass_plain(cur_k, cur_v, shift, offsets[shift // 8])
            e_one = max(e_one, max_abs_err([x for x in got if x is not None],
                                           [x for x in want if x is not None]))
            cur_k, cur_v = got
        err["onesweep"] = max(err["onesweep"], e_one)
        phase("compare", f"histogram + radix_dest (both modes) n={n} tile={tile} "
                         f"{np.dtype(dtype).name} {kind} payload "
                         f"{None if vdt is None else np.dtype(vdt).name}, every pass: "
                         f"max_abs_err {err['histogram']} / {err['radix_dest']}; digit_histograms "
                         f"+ onesweep_pass, every pass: max_abs_err {e_one}")
    for n, kdt, vdt, kind in [(N_FUSED, np.uint32, np.uint32, "ties"),
                              (N_FUSED, np.uint64, np.uint64, "uniform"),
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


RADIX_CHUNKS = (2048, 4096, 8192, 16384)


def profile_radix_sort(keys, values, backend, smi: str) -> None:
    """One 1e8 radix_tiled sort under ``torch.profiler``: the device kernels
    by name and count, and the host's aten calls. One digit histogram, then
    each pass moves keys and values in its own onesweep kernel: no per-pass
    histogram or rank-and-scatter kernel, no torch indexing or scatter kernel
    may run, and no ``aten::_to_copy`` (a dtype conversion, such as the
    former int32 -> int64 widening of the destinations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vt.sort_pairs(keys, values, backend=backend)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vt.sort_pairs(keys, values, backend=backend)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels_seen = {e.key: (e.count, e.device_time_total / 1e3) for e in events
                    if e.device_type == DeviceType.CUDA}
    host = {e.key: e.count for e in events if e.device_type == DeviceType.CPU}

    def count(part):
        return sum(c for k, (c, _) in kernels_seen.items() if part in k)

    torch_moves = [k for k in kernels_seen
                   if "vkrs" not in k and ("index" in k.lower() or "scatter" in k.lower())]
    phase("profile", f"sort_pairs n={N_MAIN} radix_tiled, device kernels (count, ms): " + "; ".join(
        f"{k[:90]} ({c}, {t:.3f})" for k, (c, t) in sorted(kernels_seen.items(),
                                                             key=lambda kv: -kv[1][1]))
        + f"; aten::_to_copy {host.get('aten::_to_copy', 0)}, aten::index_put_ "
        f"{host.get('aten::index_put_', 0)} [{smi}]")
    if count("digit_histograms_kernel") != 1 or count("onesweep_kernel") != 4 or torch_moves or \
            count("::histogram_kernel") or count("radix_pass_kernel") or \
            host.get("aten::_to_copy", 0) or host.get("aten::index_put_", 0):
        raise AssertionError(f"the radix_tiled profile is not 1 digit histogram and 4 onesweep "
                             f"passes alone: {kernels_seen}, aten {host}")


def radix_chunk_sweep(dev, keys, values, smi: str) -> dict:
    """The per-pass API's chunk swept over RADIX_CHUNKS at 1e8 stable u32
    kv: at each chunk the histogram, the scan and the rank-and-scatter
    kernel summed over the 4 passes (the card's sort, onesweep, does not
    read the chunk). Returns {chunk: {part: ms}}."""
    parts = {}
    for chunk in RADIX_CHUNKS:
        ms = {"histogram": 0.0, "scan": 0.0, "scatter": 0.0}
        cur_k, cur_v = keys, values
        for shift in range(0, 32, 8):
            hist = histogram.tile_histograms(cur_k, shift, chunk)
            base = reference.exclusive_bin_offsets(hist)
            ms["histogram"] += time_ms(lambda: histogram.tile_histograms(cur_k, shift, chunk))
            ms["scan"] += time_ms(lambda: reference.exclusive_bin_offsets(hist))
            ms["scatter"] += time_ms(
                lambda: radix_tiled.tile_scatter(cur_k, cur_v, shift, chunk, base))
            cur_k, cur_v = radix_tiled.tile_scatter(cur_k, cur_v, shift, chunk, base)
        check_kv(keys, cur_k, cur_v)
        parts[chunk] = ms
    phase("time", f"per-pass API chunk sweep n={N_MAIN} stable u32 kv, 4 passes summed: " + "; ".join(
        f"chunk {c}: histogram {m['histogram']:.4f}, scan {m['scan']:.4f}, rank-and-scatter "
        f"{m['scatter']:.4f} ms" for c, m in parts.items()) + f"; each the exact stable sort [{smi}]")
    return parts


def onesweep_parts(dev, keys: torch.Tensor, values, what: str, smi: str) -> dict:
    """The card's radix sort (onesweep) of ``keys`` with ``values`` (an
    arange, or None) by kernel: ``digit_histograms`` and each pass's
    ``onesweep_pass``, bitwise against their plain versions on the pass's
    own input and timed beside their bounds (the histogram reads each key
    once; a pass reads and writes each key and payload once) and their plain
    versions, with the pass's library answer (a stable ``torch.sort`` of its
    8-bit digit, int16, built outside the timed window, and the gathers)
    bitwise equal to it and timed, the histogram's (one ``bincount`` of
    every pass's digit, its index built outside the window), the kernel's
    shape and the blocks resident on each SM. The passes by hand give the
    exact stable sort."""
    n, kb = keys.numel(), keys.element_size()
    vb = 0 if values is None else values.element_size()
    shape = radix_tiled.onesweep_shape(dev.index, kb, vb)
    st = {"shape": shape, "histogram_bound": bound_ms(kb * n),
          "pass_bound": bound_ms(2 * (kb + vb) * n), "pass": [], "pass_plain": [],
          "pass_library": []}
    offsets = histogram.digit_histograms(keys)
    err = max_abs_err([offsets], [histogram.digit_histograms_plain(keys)])
    st["histogram"] = time_ms(lambda: histogram.digit_histograms(keys))
    st["histogram_plain"] = time_ms(lambda: histogram.digit_histograms_plain(keys), reps=3)
    composite = torch.cat([p * NUM_BINS + extract_digit(keys, 8 * p) for p in range(kb)])
    st["histogram_library"] = time_ms(lambda: torch.bincount(composite, minlength=kb * NUM_BINS))
    del composite
    state = radix_tiled.lookback_state(keys, values)
    cur_k, cur_v = keys, values
    for p in range(kb):
        shift, off = 8 * p, offsets[p]
        nxt = radix_tiled.onesweep_pass(cur_k, cur_v, shift, off, state)
        err = max(err, max_abs_err(
            [x for x in nxt if x is not None],
            [x for x in radix_tiled.onesweep_pass_plain(cur_k, cur_v, shift, off) if x is not None]))
        digit = extract_digit(cur_k, shift).to(torch.int16)

        def library_pass():
            perm = torch.sort(digit, stable=True).indices
            return take(cur_k, perm), None if cur_v is None else take(cur_v, perm)

        if not all(a is b or same_bits(a, b) for a, b in zip(library_pass(), nxt)):
            raise AssertionError(f"{what}: the stable torch.sort of the digit at shift {shift} and "
                                 "its gathers disagree with the onesweep pass")
        st["pass"].append(time_ms(lambda: radix_tiled.onesweep_pass(cur_k, cur_v, shift, off,
                                                                      state)))
        st["pass_plain"].append(time_ms(
            lambda: radix_tiled.onesweep_pass_plain(cur_k, cur_v, shift, off), reps=3))
        st["pass_library"].append(time_ms(library_pass, reps=3))
        top = int(torch.diff(offsets[p].to(torch.int64),
                             append=torch.tensor([n], device=dev)).max()) / n
        phase("time", f"n={n} {what} onesweep pass at shift {shift}: {st['pass'][-1]:.4f} ms "
                      f"(bound {st['pass_bound']:.4f}, {st['pass_bound'] / st['pass'][-1]:.1%}; "
                      f"plain {st['pass_plain'][-1]:.3f}; library: stable torch.sort of the int16 "
                      f"digit + gathers {st['pass_library'][-1]:.4f} ms, bitwise equal); the "
                      f"most common digit holds {top:.1%} of the keys [{smi}]")
        del digit
        cur_k, cur_v = nxt
    if values is not None:
        check_kv(keys, cur_k, cur_v)
    st["err"] = err
    if err:
        raise AssertionError(f"{what}: the onesweep kernels disagree with their plain versions: "
                             f"max_abs_err {err}")
    phase("time", f"n={n} {what} onesweep sort by kernel: digit_histograms {st['histogram']:.4f} ms "
                  f"(bound {st['histogram_bound']:.4f}, {st['histogram_bound'] / st['histogram']:.1%}; "
                  f"plain {st['histogram_plain']:.3f}; one bincount {st['histogram_library']:.4f}), "
                  f"{kb} passes {sum(st['pass']):.4f} ms (bound {kb * st['pass_bound']:.4f}, "
                  f"{kb * st['pass_bound'] / sum(st['pass']):.1%}; plain {sum(st['pass_plain']):.3f}; "
                  f"library {sum(st['pass_library']):.4f}); shape {shape}, state "
                  f"{state.numel() * 4 / 1e6:.2f} MB; max_abs_err {err}; the passes by hand give "
                  f"the exact stable sort [{smi}]")
    return st


def radix_main_path(dev, rng, smi: str) -> tuple:
    """The radix_tiled path: 1e6 pairs against numpy, then 1e8 pairs through
    the public entry point (the default route where it leads there) with
    launch counts, a profiler trace, peak memory and its time, then the
    onesweep sort by kernel (``onesweep_parts``), then each pass of the
    per-pass API (the JAX package's twins) by hand at the default chunk: the
    histogram kernel and both modes of the rank-and-scatter kernel bitwise
    against their plain versions on the pass's own keys and timed beside
    them, with the scan, ``torch.bincount`` over the precomputed composite
    index as the histogram's library yardstick, a stable ``torch.sort`` of
    the pass's 8-bit digit (int16, built outside the timed window) and the
    gathers of keys and values as the rank-and-scatter pass's (bitwise its
    output), and the scan bitwise against the onesweep's look-back sums
    (``radix_tiled.lookback_bases_plain``); then the per-pass API's chunk
    sweep. Returns (launches, stats)."""
    small = rng.integers(0, 1 << 32, size=N_SMALL, dtype=np.uint32)
    sk, sv = vt.sort_pairs(torch.from_numpy(small).to(dev),
                           torch.arange(N_SMALL, dtype=torch.int32, device=dev).view(torch.uint32),
                           backend="radix_tiled")
    check_numpy_kv(small, np.arange(N_SMALL, dtype=np.uint32), sk, sv, "1e6 radix_tiled sort")
    phase("slice", f"sort_pairs n={N_SMALL} backend=radix_tiled: bitwise equal to numpy's "
                   "stable argsort")

    keys = random_u32(dev, N_MAIN, SEED)
    values = torch.arange(N_MAIN, dtype=torch.int32, device=dev).view(torch.uint32)
    backend = None if route_for("kv", N_MAIN) == "radix_tiled" else "radix_tiled"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    c0 = profiling.counters()
    out_k, out_v = vt.sort_pairs(keys, values, backend=backend)
    torch.cuda.synchronize()
    launches = launches_since(c0, "digit_histograms", "onesweep", "histogram", "radix_scatter",
                              "radix_dest")
    peak = torch.cuda.max_memory_allocated(dev)
    check_kv(keys, out_k, out_v)
    want = {"digit_histograms": 1, "onesweep": 4, "histogram": 0, "radix_scatter": 0,
            "radix_dest": 0}
    phase("slice", f"sort_pairs n={N_MAIN} backend={backend} (the default route is "
                   f"{route_for('kv', N_MAIN)}): exact stable sort on the device; launches "
                   f"{launches}, expected {want}; peak device memory {peak / 1e9:.3f} GB "
                   f"({before / 1e9:.3f} GB of it allocated before the call)")
    if launches != want:
        raise AssertionError(f"the radix_tiled path did not run through the kernels: {launches}")
    oracle_s = oracle_main_path(keys, out_k, out_v, backend or "the default route", smi)
    del out_k, out_v
    profile_radix_sort(keys, values, backend, smi)
    sort_ms = [time_ms(lambda: vt.sort_pairs(keys, values, backend=backend)) for _ in range(3)]
    phase("time", f"sort_pairs n={N_MAIN} stable u32 kv on radix_tiled (onesweep), 3 runs of "
                  f"{REPS}: {' / '.join(f'{x:.4f}' for x in sort_ms)} ms [{smi}]")
    one = onesweep_parts(dev, keys, values, "stable u32 kv", smi)

    # the per-pass API (the JAX package's twins, off the sort route) on the same keys
    tile = histogram.TILE
    nt = cdiv(N_MAIN, tile)
    st = {k: 0.0 for k in ("histogram", "histogram_plain", "histogram_library", "scan",
                           "radix_scatter", "radix_scatter_plain", "radix_scatter_library",
                           "radix_dest", "radix_dest_plain")}
    err = {"histogram": 0, "radix_dest": 0}
    offsets = histogram.digit_histograms(keys)  # a pass's digits are any pass input's
    cur_k, cur_v = keys, values
    for shift in range(0, 32, 8):
        hist = histogram.tile_histograms(cur_k, shift, tile)
        err["histogram"] = max(err["histogram"], max_abs_err(
            [hist], [histogram.tile_histograms_plain(cur_k, shift, tile)]))
        base = reference.exclusive_bin_offsets(hist)
        if not torch.equal(base, radix_tiled.lookback_bases_plain(cur_k, shift, tile,
                                                                  offsets[shift // 8])):
            raise AssertionError(f"the scan at shift {shift} disagrees with the onesweep's "
                                 "look-back sums")
        dest = radix_tiled.tile_destinations(cur_k, shift, tile, base)
        e_dest = max_abs_err([dest],
                             [radix_tiled.tile_destinations_plain(cur_k, shift, tile, base)])
        nxt = radix_tiled.tile_scatter(cur_k, cur_v, shift, tile, base)
        e_move = max_abs_err(list(nxt), list(radix_tiled.tile_scatter_plain(cur_k, cur_v, shift,
                                                                            tile, base)))
        err["radix_dest"] = max(err["radix_dest"], e_dest, e_move)
        digit = extract_digit(cur_k, shift).to(torch.int16)

        def library_pass():
            perm = torch.sort(digit, stable=True).indices
            return take(cur_k, perm), take(cur_v, perm)

        if not all(same_bits(a, b) for a, b in zip(library_pass(), nxt)):
            raise AssertionError(f"the stable torch.sort of the digit at shift {shift} and its "
                                 "gathers disagree with the rank-and-scatter pass")
        pass_ms = {
            "histogram": time_ms(lambda: histogram.tile_histograms(cur_k, shift, tile)),
            "scan": time_ms(lambda: reference.exclusive_bin_offsets(hist)),
            "radix_scatter": time_ms(
                lambda: radix_tiled.tile_scatter(cur_k, cur_v, shift, tile, base)),
            "radix_scatter_library": time_ms(library_pass)}
        for k, v in pass_ms.items():
            st[k] += v
        phase("time", f"n={N_MAIN} chunk {tile} radix pass at shift {shift}: histogram "
                      f"{pass_ms['histogram']:.4f} ms, scan {pass_ms['scan']:.4f} ms, "
                      f"rank-and-scatter {pass_ms['radix_scatter']:.4f} ms (library: stable "
                      f"torch.sort of the int16 digit + 2 gathers "
                      f"{pass_ms['radix_scatter_library']:.4f} ms, bitwise equal) [{smi}]")
        st["radix_dest"] += time_ms(lambda: radix_tiled.tile_destinations(cur_k, shift, tile, base))
        st["histogram_plain"] += time_ms(
            lambda: histogram.tile_histograms_plain(cur_k, shift, tile), reps=3)
        st["radix_dest_plain"] += time_ms(
            lambda: radix_tiled.tile_destinations_plain(cur_k, shift, tile, base), reps=3)
        st["radix_scatter_plain"] += time_ms(
            lambda: radix_tiled.tile_scatter_plain(cur_k, cur_v, shift, tile, base), reps=3)
        composite = (torch.arange(N_MAIN, device=dev) // tile) * NUM_BINS + extract_digit(cur_k,
                                                                                         shift)
        st["histogram_library"] += time_ms(
            lambda: torch.bincount(composite, minlength=nt * NUM_BINS))
        del composite, dest, base, hist, digit
        cur_k, cur_v = nxt
    check_kv(keys, cur_k, cur_v)
    phase("compare", f"n={N_MAIN} chunk={tile}, the per-pass API's 4 passes on their own keys: "
                     f"histogram max_abs_err {err['histogram']}, rank-and-scatter (both "
                     f"modes) max_abs_err {err['radix_dest']}; the passes by hand give the exact "
                     "stable sort")
    if any(err.values()):
        raise AssertionError(f"radix kernels disagree with their plain versions at 1e8: {err}")
    phase("time", f"n={N_MAIN} per-pass API chunk {tile}, 4 passes summed: histogram "
                  f"{st['histogram']:.3f} ms (plain {st['histogram_plain']:.3f}, bincount "
                  f"{st['histogram_library']:.3f}); scan {st['scan']:.3f} ms (bitwise the "
                  f"look-back sums); rank-and-scatter {st['radix_scatter']:.3f} ms (plain "
                  f"{st['radix_scatter_plain']:.3f}, stable torch.sort of the digit + gathers "
                  f"{st['radix_scatter_library']:.3f}); destination mode {st['radix_dest']:.3f} ms "
                  f"(plain {st['radix_dest_plain']:.3f}); replaced: destinations 3.397 + widening "
                  f"1.740 + torch scatter 16.161 ms [{smi}]")
    del cur_k, cur_v
    st["sweep"] = radix_chunk_sweep(dev, keys, values, smi)
    st["err"] = err
    st["peak_gb"] = peak / 1e9
    st["oracle_s"] = oracle_s
    st["sort_ms"] = sort_ms
    st["onesweep"] = one
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
        c0 = profiling.counters()
        ok, ov = vt.sort_pairs(tk, tv, backend="fused")
        torch.cuda.synchronize()
        calls.append(launches_since(c0, "fused")["fused"])
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

    k64 = torch.from_numpy(radix_keys(rng, N_FUSED, np.uint64, "uniform")).to(dev)
    st = {"fused": time_batched_ms(lambda: fused.sort_fused(keys, values)),
          "fused_plain": time_ms(lambda: fused.sort_fused_plain(keys, values)),
          "fused_library": time_batched_ms(library),
          "fused_u64": time_batched_ms(lambda: fused.sort_fused(k64, k64)), "err": err}
    phase("time", f"n={N_FUSED} u32 kv, steadied: fused {st['fused']:.4f} ms (plain "
                  f"{st['fused_plain']:.4f}, torch.sort + gather {st['fused_library']:.4f}; "
                  f"PR 3: 0.2769, PERF.md); u64 keys with a u64 payload {st['fused_u64']:.4f} ms; "
                  f"max_abs_err {err} [{smi}]")
    return calls[0], st


def in_turns(call, keys: torch.Tensor, backends: dict) -> dict:
    """Device ms of ``call(backend)(keys)`` for each named backend, in turns:
    in the order of ``backends``, then in reverse, each a median of REPS
    calls on fresh remixes of the keys."""
    order = list(backends.items())
    times = {name: [] for name in backends}
    for name, backend in order + order[::-1]:
        times[name].append(measure_seconds_per_call(call(backend), keys, reps=REPS) * 1e3)
    return times


def bitonic_expected(n: int, nk: int, npayloads: int, dev) -> dict:
    """Launches of one bitonic sort of n elements, from the schedule
    ``bitonic.plan`` builds: in-block passes, global groups, and one gather
    per payload."""
    launches = bitonic.plan(bitonic._padded_size(n), bitonic.block_tile(nk, dev), nk)
    return bitonic.plan_counts(launches, npayloads)


def bitonic_bound_ms(n: int, nk: int, key_bytes: int, payload_bytes: int) -> tuple:
    """(bound ms, what bounds it) of one stable bitonic sort of n elements:
    the larger of the bytes (keys and payloads read once and written once)
    over the HBM peak and the compare-exchanges' int32 plane compares (npad / 2
    per stage, (nk + 1) planes) over 67 T/s."""
    npad = bitonic._padded_size(n)
    stages = npad.bit_length() - 1
    stages = stages * (stages + 1) // 2
    b_ms = bound_ms(2 * n * (key_bytes + payload_bytes))
    o_ms = npad // 2 * stages * (nk + 1) / PLAIN_OPS_PER_S * 1e3
    return (o_ms, "operations") if o_ms > b_ms else (b_ms, "bytes")


def time_bitonic_parts(signed: torch.Tensor, values: torch.Tensor, dev) -> dict:
    """Device ms of each part of one bitonic network on 1-D int32 keys
    ``signed`` carrying ``values``, on the schedule ``bitonic.plan`` builds:
    each launch timed steadied on its own (batches of 20 repeats; a launch
    does the same work whatever order its input is in), summed by part:
    the first in-block pass, the later in-block passes, the global groups
    and the gather."""
    n = signed.shape[0]
    npad = bitonic._padded_size(n)
    tile = min(bitonic.block_tile(1, dev), npad)
    work, _ = bitonic.network([signed], [], tile=tile)
    parts = {"first block": 0.0, "later blocks": 0.0, "global groups": 0.0, "gather": 0.0}
    for launch in bitonic.plan(npad, tile, 1):
        if isinstance(launch, bitonic.GlobalGroup):
            part, fn = "global groups", lambda: bitonic.global_group(work, launch)
        elif launch.first:
            part, fn = "first block", lambda: bitonic.block_pass([signed], work, n, tile, launch)
        else:
            part, fn = "later blocks", lambda: bitonic.block_pass([], work, n, tile, launch)
        parts[part] += time_batched_ms(fn, calls=20)
    parts["gather"] = time_batched_ms(lambda: bitonic.gather_payload(values, work[1]), calls=20)
    return parts


def bitonic_tile_sweep(dev, rng, smi: str) -> dict:
    """The in-block tile swept, 8192 against 16384, at the three contract
    shapes: the kernels steadied at each tile, and the sorted work buffers
    bitwise equal across tiles. Returns {shape: {tile: ms}}."""
    sweep = {}
    for name, n, nk, nv in [("kv", N_BITONIC_KV, 1, 1), ("keys", N_BITONIC_KEYS, 1, 0),
                            ("kv64", N_BITONIC_KV64, 2, 1)]:
        planes = [torch.from_numpy(rng.integers(-(2**31), 2**31, size=n).astype(np.int32)).to(dev)
                  for _ in range(nk)]
        vals = [torch.arange(n, dtype=torch.int32, device=dev)] * nv
        works, sweep[name] = [], {}
        for tile in (8192, 16384):
            works.append(bitonic.network(planes, vals, tile=tile)[0])
            sweep[name][tile] = time_batched_ms(lambda: bitonic.network(planes, vals, tile=tile),
                                                calls=20)
        if not torch.equal(works[0], works[1]):
            raise AssertionError(f"the bitonic network's result depends on its tile at {name}")
        phase("time", f"bitonic tile sweep {name} n={n}: " + ", ".join(
            f"tile {t} {ms:.4f} ms" for t, ms in sweep[name].items())
            + f"; results bitwise equal; the engine takes {bitonic.block_tile(nk, dev)} [{smi}]")
    return sweep


def compare_bitonic(dev, rng) -> int:
    """The bitonic kernels against their plain version, bitwise: ragged
    sizes below one tile, one tile exactly, sizes that need global groups,
    levels that end on every remainder of their global distances modulo the
    group size (2^17 + 1 and 2^19 + 1 beside the contract shapes); heavy
    ties, keys equal to the dtype's maximum, u64 keys, 4- and 8-byte
    payloads, several at once; each with the launch counts of its plan."""
    tile = bitonic.block_tile(1, dev)
    err = 0
    for n, kdt, kind, vdts in [(100, np.uint32, "max", (np.uint32,)),
                               (1000, np.uint64, "ties", ()),
                               (tile, np.uint32, "ties", (np.uint32,)),
                               (5 * tile + 3, np.uint64, "max", (np.uint64, np.float32)),
                               (3 * tile + 1, np.uint32, "uniform",
                                (np.uint64, np.uint32, np.float32)),
                               ((1 << 17) + 1, np.uint32, "max", (np.uint32,)),
                               ((1 << 19) + 1, np.uint64, "ties", (np.uint64,)),
                               ((1 << 20) + 1, np.uint32, "ties", (np.uint32,))]:
        keys = segsort.to_signed_order(torch.from_numpy(radix_keys(rng, n, kdt, kind)).to(dev))
        vals = tuple(torch.from_numpy(rng.integers(0, 2**63, size=n, dtype=np.uint64).astype(v))
                     .to(dev) for v in vdts)
        c0 = bitonic.launch_counts()
        ok, ov = bitonic.bitonic_sort_block(keys, vals)
        torch.cuda.synchronize()
        counts = {k: v - c0[k] for k, v in bitonic.launch_counts().items()}
        want = bitonic_expected(n, keys.element_size() // 4, len(vals), dev)
        pk, pv = bitonic.bitonic_sort_block_plain(keys, vals)
        e = max_abs_err([ok, *ov], [pk, *pv])
        err = max(err, e)
        phase("compare", f"bitonic n={n} keys {np.dtype(kdt).name} {kind} payloads "
                         f"{[np.dtype(v).name for v in vdts]}: max_abs_err {e}; launches {counts}")
        if counts != want:
            raise AssertionError(f"bitonic launches {counts}, expected {want}")
    if err:
        raise AssertionError(f"the bitonic kernels disagree with their plain version: {err}")
    return err


def bitonic_main_path(dev, rng, smi: str) -> tuple:
    """The bitonic path at the engine's size contract, through the public
    API: u32 keys at 2^22, stable u32 kv at 1,398,101, u64 keys with a u64
    payload at 838,860, each bitwise against numpy with its launch counts;
    then, at the kv shape, the kernels timed beside the plain version and
    ``torch.sort`` plus the payload's gather, and the whole sorts beside
    ``torch.sort`` in turns. Returns (launches of the kv run, stats)."""
    runs = {}
    for name, n, kdt, vdt in [("keys", N_BITONIC_KEYS, np.uint32, None),
                              ("kv", N_BITONIC_KV, np.uint32, np.uint32),
                              ("kv64", N_BITONIC_KV64, np.uint64, np.uint64)]:
        keys = radix_keys(rng, n, kdt, "uniform") >> kdt(4)  # some ties
        tk = torch.from_numpy(keys).to(dev)
        vals = None
        if vdt is not None:
            vals = (np.arange(n, dtype=vdt) if vdt == np.uint32
                    else rng.integers(0, 2**64, size=n, dtype=np.uint64))
        torch.cuda.synchronize()
        c0 = bitonic.launch_counts()
        if vals is None:
            out = vt.sort(tk, backend="bitonic")
        else:
            ok, ov = vt.sort_pairs(tk, torch.from_numpy(vals).to(dev), backend="bitonic")
        torch.cuda.synchronize()
        counts = {k: v - c0[k] for k, v in bitonic.launch_counts().items()}
        want = bitonic_expected(n, np.dtype(kdt).itemsize // 4, 0 if vals is None else 1, dev)
        if vals is None:
            if not np.array_equal(bits_view(out).cpu().numpy().view(kdt), np.sort(keys)):
                raise AssertionError(f"bitonic sort of {n} keys disagrees with np.sort")
        else:
            check_numpy_kv(keys, vals, ok, ov, f"bitonic sort_pairs of {n}")
        phase("slice", f"bitonic {name} n={n}: bitwise equal to numpy; launches {counts}, "
                       f"expected {want}")
        if counts != want:
            raise AssertionError(f"the bitonic path did not run through its kernels: {counts}")
        runs[name] = counts

    signed = segsort.to_signed_order(random_u32(dev, N_BITONIC_KV, SEED + 3))
    values = torch.arange(N_BITONIC_KV, dtype=torch.int32, device=dev)
    got_k, got_v = bitonic.bitonic_sort_block(signed, (values,))
    want_k, want_v = bitonic.bitonic_sort_block_plain(signed, (values,))
    err = max_abs_err([got_k, *got_v], [want_k, *want_v])
    if err:
        raise AssertionError(f"bitonic kernels disagree with their plain version: {err}")

    def library():
        s, perm = torch.sort(signed, stable=True)
        return s, values[perm]

    st = {"ms": time_batched_ms(lambda: bitonic.network([signed], [values])),
          "plain_ms": time_ms(lambda: bitonic.bitonic_sort_block_plain(signed, (values,)), reps=3),
          "library_ms": time_batched_ms(library), "err": err}
    st["bound_ms"], st["bound_by"] = bitonic_bound_ms(N_BITONIC_KV, 1, 4, 4)
    phase("time", f"n={N_BITONIC_KV} stable u32 kv, steadied: bitonic kernels {st['ms']:.4f} ms "
                  f"(plain {st['plain_ms']:.3f}, torch.sort + gather {st['library_ms']:.4f}, "
                  f"bound {st['bound_ms']:.4f} by {st['bound_by']}; PR 3: 0.966, PERF.md); "
                  f"max_abs_err {err} [{smi}]")
    st["sweep"] = bitonic_tile_sweep(dev, rng, smi)
    st["parts"] = time_bitonic_parts(signed, values, dev)
    phase("time", f"n={N_BITONIC_KV} stable u32 kv, bitonic launches by part (ms, each launch "
                  "steadied, summed): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in st["parts"].items()) + f" [{smi}]")
    uvals = values.view(torch.uint32)
    for what, n, call in [
            ("sort_pairs", N_BITONIC_KV, lambda b: lambda k: vt.sort_pairs(k, uvals, backend=b)),
            ("sort", N_BITONIC_KEYS, lambda b: lambda k: vt.sort(k, backend=b))]:
        e2e = in_turns(call, random_u32(dev, n, SEED + 4),
                       {"torch.sort": "tiled", "bitonic": "bitonic"})
        st[f"e2e_{what}"] = e2e
        for name, t in e2e.items():
            phase("time", f"{what} n={n} u32 via {name}: {' / '.join(f'{x:.4f}' for x in t)} ms "
                          f"[{smi}]")
    return runs["kv"], st


def samplesort_main_path(dev, rng, smi: str) -> tuple:
    """The samplesort path: the placement kernel against its plain version
    bitwise on a small ragged case and on the 1e8 kv sort's own rows, starts
    and lengths (and timed there beside the plain version and one
    ``torch.gather`` per plane from an index built outside the timed
    window); a small forced-overflow sort (the flat fallback, no placement);
    then through the public API ``sort_pairs`` at 1e8 (checked on the
    device), ``sort`` at 1e8 (bitwise equal to ``torch.sort``'s keys) and u64
    keys at 1e6 (bitwise against numpy), each with one placement launch,
    so no fallback; and the whole sorts beside ``torch.sort`` in turns.
    Returns (launches of the 1e8 kv run, stats)."""
    err = 0
    small = torch.from_numpy(np.sort(radix_keys(rng, 5 * 4099, np.uint64, "max").reshape(5, 4099),
                                     axis=1)).to(dev)
    starts, lens, overflow = samplesort._bucket_starts(small, samplesort._splitters(small, 16, 4),
                                                       896)
    if bool(overflow):
        raise AssertionError("the small placement case overflowed")
    fills = [(1 << 64) - 1]
    err = max(err, max_abs_err(samplesort.place_runs([small], starts, lens, 896, fills),
                               samplesort.place_runs_plain([small], starts, lens, 896, fills)))
    forced = radix_keys(rng, 60_000, np.uint32, "ties")
    c0 = profiling.counters()
    fk, fv, fired = samplesort.sort_pairs_samplesort(
        torch.from_numpy(forced).to(dev), torch.arange(60_000, dtype=torch.int32, device=dev),
        tile_target=1 << 14, bucket_target=1 << 12, oversample=1, slack=1.01, _debug_overflow=True)
    check_numpy_kv(forced, np.arange(60_000, dtype=np.int32), fk, fv, "forced-overflow samplesort")
    placed = launches_since(c0, "placement")["placement"]
    phase("compare", f"placement small u64 case: max_abs_err {err}; forced-overflow kv sort of "
                     f"60000: fallback fired {fired}, placement launches {placed}, bitwise equal "
                     "to numpy")
    if not fired or placed:
        raise AssertionError("the forced-overflow case did not take the fallback")

    keys = random_u32(dev, N_MAIN, SEED + 7)
    values = torch.arange(N_MAIN, dtype=torch.int32, device=dev).view(torch.uint32)
    G, C, B, cap = samplesort._pick_geometry(N_MAIN, 1 << 21, 1 << 21, 1.35)
    *planes, starts, lens, overflow = samplesort._pair_runs(keys, values, G, C, B, cap, 32)
    if bool(overflow):
        raise AssertionError("the 1e8 kv rows overflowed a bucket")
    fills = [(1 << 32) - 1, samplesort._GMAX, 0]
    e = max_abs_err(samplesort.place_runs(planes, starts, lens, cap, fills),
                    samplesort.place_runs_plain(planes, starts, lens, cap, fills))
    err = max(err, e)
    if err:
        raise AssertionError(f"the placement kernel disagrees with its plain version: {err}")
    src = starts.T[:, :, None].to(torch.int64) + torch.arange(cap, device=dev)
    index = (torch.arange(G, device=dev)[None, :, None] * C + src.clamp(max=C - 1)).reshape(-1)
    del src
    flat = [bits_view(p).view(-1) for p in planes]
    st = {"ms": time_ms(lambda: samplesort.place_runs(planes, starts, lens, cap, fills), reps=10),
          "plain_ms": time_ms(lambda: samplesort.place_runs_plain(planes, starts, lens, cap, fills),
                              reps=3),
          "library_ms": time_ms(lambda: [torch.gather(f, 0, index) for f in flat], reps=10),
          "err": err,
          "bound_ms": bound_ms(int(lens.sum()) * 12 + 8 * G * B + B * G * cap * 12)}
    phase("compare", f"placement at the 1e8 kv sort's rows (G={G} C={C} B={B} cap={cap}): "
                     f"max_abs_err {e}")
    phase("time", f"placement 1e8 kv: {st['ms']:.4f} ms (plain {st['plain_ms']:.3f}, "
                  f"torch.gather of the 3 planes {st['library_ms']:.4f}, bound "
                  f"{st['bound_ms']:.4f}) [{smi}]")
    del flat, index
    slots = samplesort.place_runs(planes, starts, lens, cap, fills)
    del planes
    st["buckets_ms"] = time_ms(lambda: samplesort._sort_buckets(slots, lens, N_MAIN), reps=3)
    del slots, starts, lens
    st["rows_ms"] = time_ms(lambda: samplesort._pair_runs(keys, values, G, C, B, cap, 32), reps=3)
    phase("time", f"samplesort 1e8 kv by step: row sorts, splitters and run bounds "
                  f"{st['rows_ms']:.3f} ms; placement {st['ms']:.3f} ms; bucket sorts and "
                  f"compaction {st['buckets_ms']:.3f} ms [{smi}]")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    c0 = profiling.counters()
    out_k, out_v = vt.sort_pairs(keys, values, backend="samplesort")
    torch.cuda.synchronize()
    launches = launches_since(c0, "placement")["placement"]
    st["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    check_kv(keys, out_k, out_v)
    del out_k, out_v
    c0 = profiling.counters()
    out = vt.sort(keys, backend="samplesort")
    torch.cuda.synchronize()
    keys_launches = launches_since(c0, "placement")["placement"]
    want = torch.sort(keys.view(torch.int32) ^ _MIN32).values ^ _MIN32
    if not torch.equal(out.view(torch.int32), want):
        raise AssertionError("samplesort keys at 1e8 disagree with torch.sort")
    del out, want
    k64 = rng.integers(0, 2**64, size=N_SMALL, dtype=np.uint64) >> np.uint64(20)
    v64 = np.arange(N_SMALL, dtype=np.uint32)
    c0 = profiling.counters()
    ok, ov = vt.sort_pairs(torch.from_numpy(k64).to(dev), torch.from_numpy(v64).to(dev),
                           backend="samplesort")
    o64 = vt.sort(torch.from_numpy(k64).to(dev), backend="samplesort")
    torch.cuda.synchronize()
    u64_launches = launches_since(c0, "placement")["placement"]
    check_numpy_kv(k64, v64, ok, ov, "samplesort u64 kv at 1e6")
    if not np.array_equal(bits_view(o64).cpu().numpy().view(np.uint64), np.sort(k64)):
        raise AssertionError("samplesort u64 keys at 1e6 disagree with np.sort")
    phase("slice", f"samplesort sort_pairs n={N_MAIN}: exact stable sort on the device, "
                   f"placement launches {launches}; sort n={N_MAIN}: bitwise equal to torch.sort, "
                   f"launches {keys_launches}; u64 sort_pairs and sort n={N_SMALL}: bitwise equal "
                   f"to numpy, launches {u64_launches}; overflow fallback fired: "
                   f"{not (launches == keys_launches == 1 and u64_launches == 2)}; peak device "
                   f"memory of the kv sort {st['peak_gb']:.3f} GB")
    if not (launches == keys_launches == 1 and u64_launches == 2):
        raise AssertionError("the samplesort path did not run through its placement kernel")

    for what, call in [("sort_pairs", lambda b: lambda k: vt.sort_pairs(k, values, backend=b)),
                       ("sort", lambda b: lambda k: vt.sort(k, backend=b))]:
        e2e = in_turns(call, keys, {"torch.sort": "tiled", "samplesort": "samplesort"})
        st[f"e2e_{what}"] = e2e
        for name, t in e2e.items():
            phase("time", f"{what} n={N_MAIN} u32 via {name}: {' / '.join(f'{x:.3f}' for x in t)}"
                          f" ms [{smi}]")
    return launches, st


def time_main_path(dev, n: int, smi: str):
    """The merge path's kernels at ``n`` random u32 pairs, at the shapes the
    sort gives them: the tile sort of (key, value) planes at the default
    tile, then every merge level. Each is held bitwise against its plain
    version on the same inputs and timed beside it, and the tile sort beside
    ``torch.sort`` of the same rows carrying positions; then the whole
    stable kv sort is timed through the merge, radix_tiled and torch.sort
    routes, in turns. Raises if a kernel disagrees. Returns ({kernel: ms},
    {kernel: plain ms}, {kernel: max_abs_err}, {kernel: library ms}, merge
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
    merge_library_ms = 0.0
    runs0, run = cur, tile
    while run < n:
        nxt = merge.mergepath_level(cur, 1, run)
        e = max_abs_err(nxt, merge.mergepath_level_plain(cur, 1, run))
        err["mergepath"] = max(err["mergepath"], e)
        k_ms = time_ms(lambda: merge.mergepath_level(cur, 1, run), reps=3)
        ms["mergepath"] += k_ms
        plain_ms["mergepath"] += time_ms(lambda: merge.mergepath_level_plain(cur, 1, run), reps=3)
        # the library's answer to one level: a stable sort of each pair of
        # adjacent runs, carrying positions (the indices)
        pairs = merge._padded(cur[0], cdiv(n, 2 * run) * 2 * run).view(-1, 2 * run)
        merge_library_ms += time_ms(lambda: torch.sort(pairs, dim=1, stable=True), reps=3)
        del pairs
        level_ms.append(k_ms)
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
                  f"(plain {plain_ms['mergepath']:.3f}, torch.sort of the run pairs "
                  f"{merge_library_ms:.3f}) [{smi}]")
    # a level reads and writes both planes once: 16 bytes an element
    phase("time", f"n={n} mergepath per level, run: ms (TB/s): " + ", ".join(
        f"{tile << i}: {t:.4f} ({16 * n / t / 1e9:.3f})" for i, t in enumerate(level_ms))
        + f" [{smi}]")
    # the host's side of one level: its enqueue time against the device's
    # time over the same back-to-back calls (equal when the host bounds it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        merge.mergepath_level(runs0, 1, tile)
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    dev_us = time_batched_ms(lambda: merge.mergepath_level(runs0, 1, tile)) * 1e3
    phase("time", f"n={n} first mergepath level, 100 back-to-back calls: host {host_us:.1f} us "
                  f"to enqueue a call, device window {dev_us:.1f} us a call [{smi}]")
    del runs0

    e2e = in_turns(lambda b: lambda k: vt.sort_pairs(k, values, backend=b), keys,
                   {"torch.sort": "tiled", "merge": "merge", "radix_tiled": "radix_tiled"})
    for name, runs in e2e.items():
        phase("time", f"sort_pairs n={n} stable u32 kv via {name}: "
                      f"{' / '.join(f'{t:.3f}' for t in runs)} ms "
                      f"({n / (min(runs) / 1e3) / 1e6:.1f} M pairs/s best) [{smi}]")
    library_ms = {"tilesort": library_ms, "mergepath": merge_library_ms}
    return ms, plain_ms, err, library_ms, len(level_ms)


def merge_tile_sweep(dev, smi: str) -> dict:
    """The tile sort's tile swept, 8192 against 16384, at 1e8 random u32
    pairs: the kernel alone and the whole ``sort_pairs`` on the merge route
    in turns, with the sorted results bitwise equal across tiles. Returns
    {"tilesort": {tile: ms}, "sort_pairs": {tile: [ms...]}}."""
    keys = random_u32(dev, N_MAIN, SEED + 11)
    values = torch.arange(N_MAIN, dtype=torch.int32, device=dev)
    planes = [keys.view(torch.int32) ^ _MIN32, values]
    sweep = {"tilesort": {}, "sort_pairs": {}}
    outs = []
    for tile in (8192, 16384):
        sweep["tilesort"][tile] = time_ms(lambda: merge.tilesort(planes, 1, tile))
        outs.append(vt.sort_pairs(keys, values.view(torch.uint32), backend="merge",
                                  config=vt.SortConfig(tile=tile)))
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(outs[0], outs[1])):
        raise AssertionError("the merge route's result depends on the tile-sort tile")
    del outs
    e2e = in_turns(lambda t: lambda k: vt.sort_pairs(k, values.view(torch.uint32), backend="merge",
                                                     config=vt.SortConfig(tile=t)),
                   keys, {8192: 8192, 16384: 16384})
    sweep["sort_pairs"] = e2e
    phase("time", f"tile sweep n={N_MAIN} stable u32 kv: tilesort " + ", ".join(
        f"tile {t} {ms:.4f} ms" for t, ms in sweep["tilesort"].items())
        + "; whole sort_pairs on the merge route " + ", ".join(
        f"tile {t} {' / '.join(f'{x:.3f}' for x in v)} ms" for t, v in e2e.items())
        + f", results bitwise equal; the default takes {merge.default_tile(1, dev)} [{smi}]")
    return sweep


MERGE_PLANE_CASES = [  # (what, key planes, carry planes)
    ("u32 keys", 1, 0), ("u32 kv", 1, 1), ("u32 kv with two 4-byte payloads", 1, 2),
    ("u64 keys", 2, 0), ("u64 keys with a u64 payload", 2, 2),
    ("u64 keys, gidx and a 4-byte payload", 3, 1), ("u64 keys, gidx and two 4-byte payloads", 3, 2),
]


def merge_plane_sweep(dev, smi: str) -> dict:
    """The merge kernel's output tile by plane count: 2048, 4096 and 8192
    (where two staged tiles fit one block's shared memory), summed over the
    merge levels of a 1e8 sort at 1 to 5 planes (three compare planes: a
    u64 key and the distributed sort's gidx), each level's result bitwise
    equal across tiles. Returns {what: {tile: ms}}."""
    optin = merge.smem_limits(dev)[0]
    sweep = {}
    for what, nck, ncarry in MERGE_PLANE_CASES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + nck * 4 + ncarry)
        planes = [torch.randint(-(2**31), 2**31, (N_MAIN,), dtype=torch.int32, device=dev,
                                generator=gen) for _ in range(nck + ncarry)]
        tiles = [t for t in (2048, 4096, 8192) if merge.mergepath_smem(nck + ncarry, t) <= optin]
        run = merge.default_tile(nck, dev)
        cur = merge.tilesort(planes, nck, run)
        del planes
        ms = {t: 0.0 for t in tiles}
        while run < N_MAIN:
            got = [merge.mergepath_level(cur, nck, run, out_tile=t) for t in tiles]
            if not all(torch.equal(a, b) for g in got[1:] for a, b in zip(got[0], g)):
                raise AssertionError(f"the merge level of run {run} depends on its output tile "
                                     f"at {what}")
            for t in tiles:
                ms[t] += time_ms(lambda: merge.mergepath_level(cur, nck, run, out_tile=t), reps=3)
            cur, run = got[0], 2 * run
            del got
        del cur
        sweep[what] = ms
        phase("time", f"mergepath out_tile sweep n={N_MAIN} {what} ({nck + ncarry} planes), "
                      "levels summed: " + ", ".join(f"{t}: {v:.4f} ms" for t, v in ms.items())
              + f"; results bitwise equal; the engine takes "
                f"{merge.MERGE_TILES[nck + ncarry]} [{smi}]")
    return sweep


CROSS_SIZES = (1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 26, N_MAIN)


def crossovers(dev, smi: str) -> dict:
    """The crossovers behind ROUTE_TABLE, stable and u32, in one process:
    kv with one 4-byte payload and keys alone through tiled (torch.sort),
    merge and radix_tiled, kv with two 4-byte payloads through tiled and
    merge, at every size of CROSS_SIZES, in turns, each call on a fresh
    remix of the keys. Prints each with the engine the table picks and the
    fastest. Returns {(op, n): {engine: [ms...]}}."""
    out = {}
    three = {"tiled": "tiled", "merge": "merge", "radix_tiled": "radix_tiled"}
    for n in CROSS_SIZES:
        keys = random_u32(dev, n, SEED + 40)
        v1 = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
        v2 = (v1, (torch.arange(n, dtype=torch.int32, device=dev) * 7).view(torch.float32))
        for op, call, engines in [
                ("kv", lambda b: lambda k: vt.sort_pairs(k, v1, backend=b), three),
                ("keys", lambda b: lambda k: vt.sort(k, backend=b), three),
                ("kv2", lambda b: lambda k: vt.sort_pairs(k, v2, backend=b),
                 {"tiled": "tiled", "merge": "merge"})]:
            t = in_turns(call, keys, engines)
            out[(op, n)] = t
            best = min(t, key=lambda e: statistics.mean(t[e]))
            phase("time", f"crossover {op} n={n}: " + ", ".join(
                f"{e} {' / '.join(f'{x:.4f}' for x in v)}" for e, v in t.items())
                + f" ms; fastest {best}, the table routes {route_for(op, n)} [{smi}]")
    return out


def random_u64(dev, n: int, seed: int) -> torch.Tensor:
    """n uniform u64 keys over the full width (their int64 view drawn below
    2^63 - 1, randint's exclusive bound)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-(2**63), 2**63 - 1, (n,), dtype=torch.int64, device=dev,
                         generator=gen).view(torch.uint64)


def turns(fns: dict, keys: torch.Tensor, fresh: bool) -> dict:
    """Device ms of each ``fns[name](keys)``, in turns: in order, then in
    reverse, each a median of REPS calls. ``fresh``: each call sorts a new
    remix of the keys (``measure_seconds_per_call``; uniform keys stay
    uniform); else every call sorts the same keys (a remix would make Zipf
    keys uniform; no sort modifies its input)."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        fn = fns[name]
        times[name].append(measure_seconds_per_call(fn, keys, reps=REPS) * 1e3 if fresh
                           else time_ms(lambda: fn(keys)))
    return times


def won_every_turn(t: dict):
    """The engine that was faster than every other in every turn, or None."""
    for e, v in t.items():
        if all(max(v) < min(w) for x, w in t.items() if x != e):
            return e
    return None


def route_crossovers(dev, zipf: torch.Tensor, smi: str) -> dict:
    """The crossovers behind the ROUTE_TABLE rows of the dispatcher's other
    paths, at every size of CROSS_SIZES, in turns, in this one process:
    argsort of u32 keys, and stable=False u32 kv with one 4-byte payload
    (beside the kv row, which it reads); then on u64 keys, full-width
    uniform and Zipf (the first n of ``zipf``, BASELINE.json config 4),
    keys alone, stable kv with one 4-byte payload and argsort. Each runs
    through tiled, merge and radix_tiled. Prints each with the engine that
    won every turn and the engine the table picks. Returns
    {(case, dist, n): {engine: [ms...]}}."""
    out = {}

    def engines(call):
        return {b: (lambda k, b=b: call(k, b)) for b in ("tiled", "merge", "radix_tiled")}

    for n in CROSS_SIZES:
        v1 = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
        argsort = engines(lambda k, b: vt.argsort(k, backend=b))
        unstable = engines(lambda k, b: vt.sort_pairs(k, v1, backend=b, stable=False))
        u32 = random_u32(dev, n, SEED + 90)
        cases = [("argsort", "uniform", u32, argsort),
                 ("kv stable=False", "uniform", u32, unstable)]
        kv64 = engines(lambda k, b: vt.sort_pairs(k, v1, backend=b))
        for dist, keys in (("uniform", random_u64(dev, n, SEED + 91)), ("zipf", zipf[:n])):
            cases += [("keys64", dist, keys, engines(lambda k, b: vt.sort(k, backend=b))),
                      ("kv64", dist, keys, kv64),
                      ("argsort64", dist, keys, argsort)]
        for case, dist, keys, fns in cases:
            t = turns(fns, keys, fresh=dist == "uniform")
            out[(case, dist, n)] = t
            row = case.split()[0]  # the ROUTE_TABLE row the case reads
            routed = route_for(row.removesuffix("64"), n, row.endswith("64"))
            phase("time", f"crossover {case} {dist} n={n}: " + ", ".join(
                f"{e} {' / '.join(f'{x:.4f}' for x in v)}" for e, v in t.items())
                + f" ms; won every turn: {won_every_turn(t)}; the table routes {routed} [{smi}]")
        del cases, keys, u32
    return out


# --- 10c. wide payload sets: the kvw rows, kv2 again, and the column gather

WIDE_SETS = {  # payload dtypes: the benchmark's five lineitem columns, three 4-byte columns,
    "lineitem": (torch.int64,) * 4 + (torch.int32,),  # two, and one of 1, 2 or 8 bytes
    "c3": (torch.int32,) * 3,
    "kv2": (torch.int32,) * 2,
    "i8": (torch.int8,),
    "i16": (torch.int16,),
    "i64": (torch.int64,),
}


def random_columns(dev, n: int, dtypes, seed: int) -> tuple:
    """Columns of random bits, one a dtype, made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.empty(n, dtype=d, device=dev).random_(torch.iinfo(d).min, None,
                                                             generator=gen) for d in dtypes)


def wide_crossovers(dev, zipf: torch.Tensor, smi: str, sets=tuple(WIDE_SETS)) -> dict:
    """The crossovers behind ROUTE_TABLE's kvw and kvw64 rows, and kv2's
    again, at every size of CROSS_SIZES, in turns: stable ``sort_pairs``
    through tiled (torch.sort, then a gather a column) and radix_tiled (the
    keys with their u32 positions, then one ``gather_columns``; one payload
    that fits ``radix_tiled.CARRY_MAX_BYTES`` with its key rides the
    passes), on u32 and u64 keys, uniform (a fresh remix a call) and Zipf
    (the first n of ``zipf``; for u32 keys reduced mod 2^32 - 1, as
    ``utils/fixtures.make_keys`` does), with each of the payload sets
    ``sets`` of WIDE_SETS (two 4-byte payloads read kv2 on u32 keys and
    kvw64 on u64 keys). Prints each with the engine that won every turn and
    the engine the table picks. Returns {(op, payloads, keys, n): {engine:
    [ms...]}}."""
    out = {}
    for n in CROSS_SIZES:
        z64 = zipf[:n]
        key_sets = {
            "u32 uniform": random_u32(dev, n, SEED + 95),
            "u32 zipf": (z64.view(torch.int64) % 0xFFFFFFFF).to(torch.int32).view(torch.uint32),
            "u64 uniform": random_u64(dev, n, SEED + 96),
            "u64 zipf": z64,
        }
        payloads = {name: random_columns(dev, n, WIDE_SETS[name], SEED + 97) for name in sets}
        for key_name, keys in key_sets.items():
            wide = keys.dtype == torch.uint64
            for set_name, cols in payloads.items():
                op = "kv2" if set_name == "kv2" and not wide else "kvw"
                fns = {e: (lambda k, e=e, cols=cols: vt.sort_pairs(k, cols, backend=e))
                       for e in ("tiled", "radix_tiled")}
                t = turns(fns, keys, fresh=key_name.endswith("uniform"))
                out[(op, set_name, key_name, n)] = t
                phase("time", f"crossover {op}{'64' if wide else ''} {set_name} {key_name} n={n}: "
                      + ", ".join(f"{e} {' / '.join(f'{x:.4f}' for x in v)}" for e, v in t.items())
                      + f" ms; won every turn: {won_every_turn(t)}; the table routes "
                        f"{route_for(op, n, wide)} [{smi}]")
        del key_sets, payloads
    return out


def carry_or_gather(dev, smi: str) -> dict:
    """One payload of 1, 2, 4 or 8 bytes on radix_tiled's onesweep sort,
    carried through the passes against sorted as u32 positions and moved by
    one ``gather_columns`` after them, bitwise equal, in turns, on uniform
    u32 and u64 keys at 2^24 and 1e8: behind ``radix_tiled.CARRY_MAX_BYTES``.
    Returns {(keys, bytes, n): {"carry": [ms...], "gather": [ms...]}}."""
    out = {}
    for n in (1 << 24, N_MAIN):
        pos = positions(n, dev)
        for key_name, keys in (("u32", random_u32(dev, n, SEED + 98)),
                               ("u64", random_u64(dev, n, SEED + 99))):
            for dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
                (v,) = random_columns(dev, n, (dtype,), SEED + 100)

                def carried(k, v=v):
                    return radix_tiled.sort_onesweep(k, v)

                def gathered(k, v=v):
                    out_k, perm = radix_tiled.sort_onesweep(k, pos)
                    return out_k, gather.gather_columns(perm, (v,))[0]

                a, b = carried(keys), gathered(keys)
                if not (same_bits(a[0], b[0]) and same_bits(a[1], b[1])):
                    raise AssertionError(f"{key_name} keys, {dtype} payload, n={n}: carried and "
                                         "gathered sorts disagree")
                del a, b
                t = turns({"carry": carried, "gather": gathered}, keys, fresh=True)
                width = torch.empty(0, dtype=dtype).element_size()
                out[(key_name, width, n)] = t
                phase("time", f"radix_tiled one {width}-byte payload, {key_name} uniform keys "
                      f"n={n}: " + ", ".join(f"{e} {' / '.join(f'{x:.4f}' for x in ms)}"
                                             for e, ms in t.items())
                      + f" ms, bitwise equal; won every turn: {won_every_turn(t)}; "
                        f"sort_radix_tiled carries it: {radix_tiled.carries(keys, v)} [{smi}]")
                del v
        del keys, pos
    return out


def gather_parts(dev, smi: str) -> dict:
    """The column gather (``csrc/gather.cu``) at 1e8 through a random
    permutation: the lineitem set in one launch, bitwise its plain version
    (``gather_columns_plain``: torch indexing by the permutation widened to
    int64) and timed beside its bound (each position read once, each
    payload byte read and written once), its plain version and the library
    (torch's indexing of each column by an int64 permutation made outside
    the window, as the tiled route gathers); then one column and eight at
    each width of 1, 2, 4 and 8 bytes, beside their bounds."""
    n = N_MAIN
    perm64 = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    perm = perm64.to(torch.int32).view(torch.uint32)
    cols = random_columns(dev, n, WIDE_SETS["lineitem"], SEED + 101)
    torch.cuda.synchronize()
    before = profiling.counters()
    got = gather.gather_columns(perm, cols)
    torch.cuda.synchronize()
    st = {"launches": launches_since(before, "gather_columns")["gather_columns"]}
    st["err"] = max_abs_err(list(got), list(gather.gather_columns_plain(perm, cols)))
    del got
    payload = sum(c.element_size() for c in cols)
    st["bound"] = bound_ms(n * (4 + 2 * payload))
    st["ms"] = time_ms(lambda: gather.gather_columns(perm, cols))
    st["plain"] = time_ms(lambda: gather.gather_columns_plain(perm, cols), reps=3)
    st["library"] = time_ms(lambda: tuple(take(c, perm64) for c in cols))
    phase("time", f"n={n} gather_columns, lineitem set ({len(cols)} columns, {payload} B a row): "
                  f"{st['ms']:.4f} ms in {st['launches']} launch (bound {st['bound']:.4f}, "
                  f"{st['bound'] / st['ms']:.1%}; plain {st['plain']:.4f}; library, torch's "
                  f"int64 indexing a column: {st['library']:.4f}); max_abs_err {st['err']} [{smi}]")
    del cols
    st["widths"] = {}
    for width, dtype in ((1, torch.int8), (2, torch.int16), (4, torch.int32), (8, torch.int64)):
        for ncols in (1, 8):
            cols = random_columns(dev, n, (dtype,) * ncols, SEED + 102)
            e = max_abs_err(list(gather.gather_columns(perm, cols)),
                            list(gather.gather_columns_plain(perm, cols)))
            st["err"] = max(st["err"], e)
            ms, bound = time_ms(lambda: gather.gather_columns(perm, cols)), bound_ms(
                n * (4 + 2 * width * ncols))
            st["widths"][(width, ncols)] = ms
            phase("time", f"n={n} gather_columns {ncols} x {width} B: {ms:.4f} ms (bound "
                          f"{bound:.4f}, {bound / ms:.1%}); max_abs_err {e} [{smi}]")
            del cols
    if st["err"]:
        raise AssertionError(f"gather_columns disagrees with its plain version: {st['err']}")
    return st


# --- 11. the distributed sort (parallel/distributed.py) on one card

DIST_P = 8  # logical shards of the card, as the JAX package's 8 CPU devices
N_DIST_U64 = 10_000_000
DIST_LOCAL_SIZES = (1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24)


def nck3_planes(dev, rng, n: int, ncarry: int) -> list:
    """The distributed sort's merge planes for u64 keys: the key as (hi,
    lo) in signed order (ties, keys equal to the dtype's maximum), gidx (a
    permutation of 0..n-1, as after the interleave) and random carries."""
    keys = torch.from_numpy(radix_keys(rng, n, np.uint64, "max")).to(dev)
    s = keys.view(torch.int64) ^ (-(1 << 63))
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    return [(s >> 32).to(torch.int32), s.to(torch.int32) ^ _MIN32,
            torch.randperm(n, device=dev, generator=gen).to(torch.int32)] + [
        torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
        for _ in range(ncarry)]


def compare_sort_chain(planes: list, nck: int) -> dict:
    """The kernels of one ``merge.sort_merge_planes`` call, each against its
    plain version on the same inputs: the tile sort at the default tile,
    then every merge level at the default output tile
    (``merge.MERGE_TILES`` by plane count). Returns the largest errors, the
    tile, the output tile and the number of levels."""
    n = planes[0].numel()
    tile = merge.default_tile(nck, planes[0].device)
    cur = merge.tilesort(planes, nck, tile)
    e_tile = max_abs_err(cur, merge.tilesort_plain(planes, nck, tile))
    run, e_merge, levels = tile, 0, 0
    while run < n:
        nxt = merge.mergepath_level(cur, nck, run)
        e_merge = max(e_merge, max_abs_err(nxt, merge.mergepath_level_plain(cur, nck, run)))
        cur, run, levels = nxt, 2 * run, levels + 1
    return {"tilesort": e_tile, "mergepath": e_merge, "tile": tile,
            "out_tile": merge.MERGE_TILES[len(planes)], "levels": levels}


def merged_err(err: dict, *results) -> dict:
    """``err`` with each kernel's error raised to the largest of ``results``;
    raises if any of them is not 0."""
    out = {k: max([v] + [r[k] for r in results if k in r]) for k, v in err.items()}
    if any(r.get(k, 0) for r in results for k in ("tilesort", "mergepath")):
        raise AssertionError(f"the merge kernels disagree with their plain versions: {results}")
    return out


def compare_nck3(dev, rng) -> dict:
    """The tile sort and every merge level at three compare planes, bitwise
    against their plain versions: u64 keys with ties and dtype-max keys plus
    a gidx plane, 0-2 carries, ragged lengths."""
    err = {"tilesort": 0, "mergepath": 0}
    tile = merge.default_tile(3, dev)
    for n, ncarry in [(5 * tile + 777, 1), (3 * tile + 5, 2), (2 * tile, 0), (1_000_003, 1)]:
        r = compare_sort_chain(nck3_planes(dev, rng, n, ncarry), 3)
        phase("compare", f"nck=3 (u64 key + gidx) ncarry={ncarry} n={n} tile={r['tile']}: "
                         f"tilesort max_abs_err {r['tilesort']}; mergepath {r['levels']} levels "
                         f"(output tile {r['out_tile']}) max_abs_err {r['mergepath']}")
        err = merged_err(err, r)
    return err


def captured_merge_planes(call) -> list:
    """Run ``call()`` with ``merge.sort_merge_planes`` wrapped to keep a copy
    of the planes of its first call at each (length, compare planes, planes):
    the inputs the merge engine gets in a distributed sort, its local sorts
    and its final sort. Returns [(planes, nck), ...]."""
    seen = {}
    inner = merge.sort_merge_planes

    def keep(planes, nck, **kw):
        seen.setdefault((planes[0].numel(), nck, len(planes)),
                        ([p.clone() for p in planes], nck))
        return inner(planes, nck, **kw)

    merge.sort_merge_planes = keep
    try:
        call()
    finally:
        merge.sort_merge_planes = inner
    torch.cuda.synchronize()
    return list(seen.values())


def compare_captured(call, what: str) -> dict:
    """The merge kernels against their plain versions on the planes that
    ``call`` gives ``merge.sort_merge_planes`` (:func:`captured_merge_planes`),
    each sort's whole chain at its default tiles."""
    err = {"tilesort": 0, "mergepath": 0}
    captured = captured_merge_planes(call)
    if not captured:
        raise AssertionError(f"{what}: the merge engine was never called")
    for planes, nck in captured:
        r = compare_sort_chain(planes, nck)
        phase("compare", f"{what}, merge engine input n={planes[0].numel()} nck={nck} planes="
                         f"{len(planes)}: tilesort tile {r['tile']} max_abs_err {r['tilesort']}; "
                         f"mergepath {r['levels']} levels, output tile {r['out_tile']}, "
                         f"max_abs_err {r['mergepath']}")
        err = merged_err(err, r)
        del planes
    return err


def merge_launches(n: int, nck: int, dev) -> tuple:
    """(tile sorts, merge levels) of one ``sort_merge_planes`` of n elements."""
    tile = merge.default_tile(nck, dev)
    return 1, max(0, math.ceil(math.log2(n / tile))) if n > tile else 0


def nck3_kernel_times(dev, rng, smi: str) -> dict:
    """The tile sort and the merge levels at one shard of the 1e8 sort
    (1.25e7 elements) with a u64 key and one carry: two compare planes (the
    key alone) against three (key and gidx, the distributed sort's
    order), each at its default tile, first bitwise against their plain
    versions (every level), then timed."""
    n = N_MAIN // DIST_P
    st = {"err": {"tilesort": 0, "mergepath": 0}}
    planes = nck3_planes(dev, rng, n, 1)
    for nck, ps in ((2, planes[:2] + planes[3:]), (3, planes)):
        r = compare_sort_chain(ps, nck)
        phase("compare", f"n={n} u64 key + 1 carry nck={nck}: tilesort tile {r['tile']} "
                         f"max_abs_err {r['tilesort']}; mergepath {r['levels']} levels, output "
                         f"tile {r['out_tile']}, max_abs_err {r['mergepath']}")
        st["err"] = merged_err(st["err"], r)
        tile = merge.default_tile(nck, dev)
        cur = merge.tilesort(ps, nck, tile)
        t_ms = time_ms(lambda: merge.tilesort(ps, nck, tile))
        run, m_ms = tile, 0.0
        while run < n:
            m_ms += time_ms(lambda: merge.mergepath_level(cur, nck, run), reps=3)
            cur, run = merge.mergepath_level(cur, nck, run), 2 * run
        st[nck] = {"tilesort": t_ms, "mergepath": m_ms, "tile": tile}
    phase("time", f"n={n} u64 key + 1 carry, tile sort / merge levels summed: nck=2 tile "
                  f"{st[2]['tile']} {st[2]['tilesort']:.4f} / {st[2]['mergepath']:.4f} ms; nck=3 "
                  f"(+gidx) tile {st[3]['tile']} {st[3]['tilesort']:.4f} / "
                  f"{st[3]['mergepath']:.4f} ms [{smi}]")
    return st


def dist_steps_ms(call, reps: int = 3) -> dict:
    """Device ms of each step of the distributed sort's body: ``reps`` calls
    under ``torch.profiler``, after one untimed call, its trace written to
    build/dist_trace.json. A step's time is the span on the device of its
    ``vkrs/sort_sharded/<step>`` span (the trace's GPU user annotation: from its
    first kernel's start to its last kernel's end), summed over the call's
    ranges of that name, mean over the calls; its "busy" time is the
    kernels' time inside those spans. "whole" is one call by CUDA events
    (median of ``reps``), and "idle share" is 1 - the kernels' time of one
    call over it."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    from vkradixsort_tpu_torch.parallel.distributed import STEPS

    whole = time_ms(call, reps=reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    path = pathlib.Path(__file__).resolve().parent / "build" / "dist_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"]
    spans = [(e["name"].removeprefix("vkrs/sort_sharded/"), e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") == "gpu_user_annotation"
             and e.get("name", "").startswith("vkrs/sort_sharded/")]
    if {name for name, _, _ in spans} != set(STEPS):
        raise AssertionError(f"the trace has no device span for some steps: "
                             f"{sorted({name for name, _, _ in spans})}, categories "
                             f"{sorted({str(e.get('cat')) for e in events})}")
    ms = {step: 0.0 for step in STEPS}
    busy = {step: 0.0 for step in STEPS}
    for name, a, b in spans:
        ms[name] += (b - a) / 1e3 / reps
        busy[name] += sum(min(k1, b) - max(k0, a) for k0, k1 in kernels
                          if k0 < b and k1 > a) / 1e3 / reps
    kernels_ms = sum(k1 - k0 for k0, k1 in kernels) / 1e3 / reps
    return {"steps": ms, "busy": busy, "whole": whole, "kernels": kernels_ms,
            "idle share": 1 - kernels_ms / whole}


def distributed_main_path(dev, rng, smi: str) -> tuple:
    """The distributed sort on P = 8 logical shards of the card
    (``LocalMesh([cuda:0] * 8)``) at the bench call's size: 1e8 stable u32
    kv, overlap_chunks 1 and 2, local engine "xla" (torch.sort) and "merge"
    (the tile-sort and merge-path kernels), each checked exactly on the
    device, with no overflow, balance <= 1.25, its kernel launches and peak
    memory; on the merge runs the kernels against their plain versions on
    the planes the run gives them; the device ms by step beside one
    ``sort_pairs`` of the same array. Returns ({(chunks, engine): launches},
    stats with the kernels' errors under "err")."""
    from vkradixsort_tpu_torch.parallel.distributed import (
        LocalMesh,
        gather_sorted,
        sort_sharded,
    )

    mesh = LocalMesh([dev] * DIST_P)
    keys = random_u32(dev, N_MAIN, SEED + 50)
    values = torch.arange(N_MAIN, dtype=torch.int32, device=dev).view(torch.uint32)
    launches, st = {}, {}
    err = {"tilesort": 0, "mergepath": 0}
    for chunks in (1, 2):
        for eng in ("xla", "merge"):
            def call():
                return sort_sharded(keys, mesh, values=values, overlap_chunks=chunks,
                                    local_engine=eng)

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            c0 = profiling.counters()
            pk, counts, overflow, pv = call()
            torch.cuda.synchronize()
            got = launches_since(c0, "tilesort", "mergepath")
            peak = torch.cuda.max_memory_allocated(dev)
            c = counts.cpu().numpy()
            balance = c.max() / c.mean()
            if bool(overflow.any()) or balance > 1.25:
                raise AssertionError(f"distributed sort C={chunks} {eng}: overflow "
                                     f"{overflow.tolist()}, balance {balance:.4f}")
            out_k, out_v = gather_sorted(pk, counts, pv)
            check_kv(keys, out_k, out_v)
            del pk, pv, out_k, out_v
            n_local = N_MAIN // DIST_P
            cap = int(2.0 * n_local / (chunks * DIST_P)) + 64
            lt, ll = merge_launches(n_local // chunks, 2, dev)
            ft, fl = merge_launches(chunks * DIST_P * cap, 2, dev)
            want = ({"tilesort": DIST_P * (chunks * lt + ft),
                     "mergepath": DIST_P * (chunks * ll + fl)} if eng == "merge"
                    else {"tilesort": 0, "mergepath": 0})
            phase("slice", f"sort_sharded n={N_MAIN} stable u32 kv on LocalMesh([cuda:0] * "
                           f"{DIST_P}) overlap_chunks={chunks} local_engine={eng}: exact stable "
                           f"sort on the device, no overflow, counts {c.tolist()}, balance "
                           f"{balance:.4f}; launches {got}, expected {want}; peak device memory "
                           f"{peak / 1e9:.3f} GB ({before / 1e9:.3f} GB before the call)")
            if got != want:
                raise AssertionError(f"the distributed sort's launches {got}, expected {want}")
            launches[(chunks, eng)] = got
            if eng == "merge":
                err = merged_err(err, compare_captured(
                    call, f"sort_sharded n={N_MAIN} P={DIST_P} C={chunks}"))
            steps = dist_steps_ms(call)
            st[(chunks, eng)] = {"steps": steps, "balance": float(balance), "peak_gb": peak / 1e9}
            phase("time", f"sort_sharded n={N_MAIN} P={DIST_P} C={chunks} {eng}, device ms by "
                          "step, span (kernels), profiler, mean of 3: " + ", ".join(
                              f"{k} {v:.3f} ({steps['busy'][k]:.3f})"
                              for k, v in steps["steps"].items())
                  + f"; whole {steps['whole']:.3f} (CUDA events, median of 3), kernels "
                    f"{steps['kernels']:.3f}, device idle share {steps['idle share']:.4f} [{smi}]")
    st["sort_pairs"] = time_ms(lambda: vt.sort_pairs(keys, values), reps=3)
    phase("time", f"sort_pairs n={N_MAIN} stable u32 kv on one card (default route "
                  f"{route_for('kv', N_MAIN)}): {st['sort_pairs']:.3f} ms, beside the distributed "
                  f"sort above [{smi}]")
    st["err"] = err
    return launches, st


def distributed_small_paths(dev, rng, smi: str) -> dict:
    """``dryrun_multichip(8)`` on the card (f32 keys, two payloads, about
    1e6, C = 1 and 2), then u64 Zipf kv at 1e7 through ``sort_distributed``
    with the merge engine (three compare planes), bitwise against numpy, and
    the kernels against their plain versions on the planes that run gives
    them. Returns its launches and the kernels' errors."""
    from vkradixsort_tpu_torch.entry import dryrun_multichip
    from vkradixsort_tpu_torch.parallel.distributed import LocalMesh, sort_distributed

    t0 = time.perf_counter()
    dryrun_multichip(DIST_P, device=dev)
    phase("slice", f"dryrun_multichip({DIST_P}) on {dev}: exact, "
                   f"{time.perf_counter() - t0:.2f} s of host")
    keys = make_keys(rng, N_DIST_U64, np.uint64, "zipf")
    vals = np.arange(N_DIST_U64, dtype=np.int32)
    mesh = LocalMesh([dev] * DIST_P)
    keys_d = torch.from_numpy(keys).to(dev)
    vals_d = torch.from_numpy(vals).to(dev)

    def call():
        return sort_distributed(keys_d, mesh, values=vals_d, local_engine="merge", slack=4.0,
                                oversample=64)

    torch.cuda.synchronize()
    c0 = profiling.counters()
    got_k, got_v = call()
    torch.cuda.synchronize()
    got = launches_since(c0, "tilesort", "mergepath")
    check_numpy_kv(keys, vals, got_k, got_v, "distributed u64 zipf kv on the merge engine")
    phase("slice", f"sort_distributed n={N_DIST_U64} u64 zipf kv, local_engine=merge (nck=3): "
                   f"bitwise equal to numpy's stable argsort; launches {got}")
    if not got["tilesort"] or not got["mergepath"]:
        raise AssertionError(f"the u64 merge run did not launch the kernels: {got}")
    return {"launches": got,
            "err": compare_captured(call, f"sort_distributed n={N_DIST_U64} u64 zipf kv")}


def nccl_world_one(dev, smi: str) -> dict:
    """``GroupMesh`` on NCCL at world size 1 (the machine has one card): the
    1e8 stable u32 kv sort, exact on the device, through
    ``init_process_group("nccl", world_size=1)`` with a file store under
    build/, then the group destroyed."""
    import pathlib

    import torch.distributed as dist

    from vkradixsort_tpu_torch.parallel.distributed import (
        GroupMesh,
        GroupMesh2D,
        gather_sorted,
        sort_sharded,
    )

    store = pathlib.Path(__file__).resolve().parent / "build" / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        mesh = GroupMesh(device=dev)
        keys = random_u32(dev, N_MAIN, SEED + 51)
        values = torch.arange(N_MAIN, dtype=torch.int32, device=dev).view(torch.uint32)
        pk, counts, overflow, pv = sort_sharded(keys, mesh, values=values)
        if bool(overflow.any()):
            raise AssertionError("NCCL world-size-1 sort overflowed")
        out_k, out_v = gather_sorted(pk, counts, pv, mesh=mesh)
        check_kv(keys, out_k, out_v)
        del out_k, out_v
        ms = time_ms(lambda: sort_sharded(keys, mesh, values=values), reps=3)
        phase("slice", f"sort_sharded n={N_MAIN} stable u32 kv on GroupMesh (NCCL, world size "
                       f"1): exact stable sort on the device; {ms:.3f} ms [{smi}]")
        # the process-group 2-D mesh: new_group for its row and its column
        mesh2 = GroupMesh2D((1, 1), device=dev)
        pk2, counts2, overflow2, pv2 = sort_sharded(keys, mesh2, values=values, axis_name="chip")
        if bool(overflow2.any()):
            raise AssertionError("NCCL 2-D mesh sort overflowed")
        out_k, out_v = gather_sorted(pk2, counts2, pv2, mesh=mesh2, axis_name="chip")
        check_kv(keys, out_k, out_v)
        if not (same_bits(pk2[0], pk[0]) and same_bits(pv2[0], pv[0])
                and torch.equal(counts2, counts)):
            raise AssertionError("the NCCL 2-D mesh sort differs from the GroupMesh sort")
        del pk, pv, pk2, pv2, out_k, out_v
        phase("slice", f"sort_sharded n={N_MAIN} stable u32 kv on GroupMesh2D((1, 1)) along "
                       "'chip' (NCCL, world size 1, a process group for its row and its "
                       "column): exact stable sort on the device, bitwise equal to the GroupMesh "
                       "sort")
    finally:
        dist.destroy_process_group()
    return {"ms": ms}


def dist_local_crossovers(dev, smi: str) -> dict:
    """The distributed sort's local composite sort, (key, gidx) with one
    int32 payload, through "xla" (torch.sort) and "merge" at 2^16 to 2^24
    per shard, u32 and u64 keys, in turns (xla, merge, merge, xla), results
    bitwise equal. Behind ROUTE_TABLE["dist_local"] / ["dist_local64"]."""
    from vkradixsort_tpu_torch.parallel.distributed import _idx_sort, _idx_sort_merge

    out = {}
    for wide in (False, True):
        for n in DIST_LOCAL_SIZES + ((1 << 26,) if wide else ()):
            gen = torch.Generator(device=dev).manual_seed(SEED + 60 + n)
            dt = torch.int64 if wide else torch.int32
            info = torch.iinfo(dt)
            k = torch.randint(info.min, info.max, (n,), dtype=dt, device=dev, generator=gen)
            g = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
            v = [torch.arange(n, dtype=torch.int32, device=dev)]
            fns = {"xla": lambda: _idx_sort(k, g, v), "merge": lambda: _idx_sort_merge(k, g, v)}
            a, b = fns["xla"](), fns["merge"]()
            if not all(torch.equal(x, y) for x, y in zip([a[0], a[1]] + a[2],
                                                           [b[0], b[1]] + b[2])):
                raise AssertionError(f"the local sorts disagree at n={n} wide={wide}")
            t = {"xla": [], "merge": []}
            for name in ("xla", "merge", "merge", "xla"):
                t[name].append(time_ms(fns[name]))
            out[(wide, n)] = t
            best = "merge" if max(t["merge"]) < min(t["xla"]) else "xla"
            routed = route_for("dist_local", n, wide=wide)
            phase("time", f"dist_local crossover {'u64' if wide else 'u32'} keys + gidx + 1 "
                          f"payload n={n}: xla {' / '.join(f'{x:.4f}' for x in t['xla'])}, merge "
                          f"{' / '.join(f'{x:.4f}' for x in t['merge'])} ms; merge faster in both "
                          f"turns: {best == 'merge'}; the table routes "
                          f"{'merge' if routed == 'merge' else 'xla'} [{smi}]")
    return out


def distributed_2d_path(dev, smi: str) -> tuple:
    """The distributed sort along one axis of a 2-D mesh, at the bench
    call's size: 1e8 stable u32 kv over ``LocalMesh2D([[cuda:0] * 4] * 2)``
    along "chip" (P = 4, 2 replicas) and along "host" (P = 2, 4 replicas),
    on the default local engine (merge: 2.5e7 and 5e7 a shard). For each
    axis: every replica exact on the device with no overflow and balance
    <= 1.25, the replicas bitwise equal to each other and replica 0 to
    ``sort_sharded`` over ``LocalMesh([cuda:0] * P)`` (padded shards, counts
    and flags), the tile-sort and merge-path launches exactly replicas x
    the 1-D run's, the kernels against their plain versions on the planes
    the 2-D run gives them, device ms of the whole call beside the 1-D sort,
    and peak memory; counts and flags of shape (P,), and ``gather_sorted``
    without ``mesh=`` bitwise equal to the ``mesh=`` form and, on the host,
    to the host runtime's stable argsort. Also ``GPUContext.mesh_2d``.
    Returns ({axis: launches}, stats with the kernels' errors under "err")."""
    from vkradixsort_tpu_torch.parallel.distributed import (
        LocalMesh,
        LocalMesh2D,
        gather_sorted,
        sort_sharded,
    )

    t_phase = time.perf_counter()
    ctx = vt.GPUContext(dev)
    m11 = ctx.mesh_2d((1, 1))
    if m11.devices != [[dev]] or m11.shape != {"host": 1, "chip": 1}:
        raise AssertionError(f"mesh_2d((1, 1)) gave {m11.devices}, {m11.shape}")
    try:
        ctx.mesh_2d((1, 2))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("mesh_2d((1, 2)) on one card did not raise")
    phase("slice", f"GPUContext.mesh_2d((1, 1)): shape {m11.shape} on {m11.devices}; "
                   f"mesh_2d((1, 2)) raises ValueError: {refused}")

    mesh = LocalMesh2D([[dev] * 4] * 2, ("host", "chip"))
    keys = random_u32(dev, N_MAIN, SEED + 52)
    values = torch.arange(N_MAIN, dtype=torch.int32, device=dev).view(torch.uint32)
    t0 = time.perf_counter()
    keys_h = host_bits(keys)
    perm = native.oracle_argsort(keys_h)
    want_k = keys_h[perm]
    oracle_s = time.perf_counter() - t0
    launches, st = {}, {}
    err = {"tilesort": 0, "mergepath": 0}
    for axis in ("chip", "host"):
        P = mesh.shape[axis]
        reps = len(mesh.along(axis))
        one = LocalMesh([dev] * P)

        def call():
            return sort_sharded(keys, mesh, values=values, axis_name=axis)

        def call_1d():
            return sort_sharded(keys, one, values=values)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        c0 = profiling.counters()
        pk, counts, overflow, pv = call()
        torch.cuda.synchronize()
        got = launches_since(c0, "tilesort", "mergepath")
        peak = torch.cuda.max_memory_allocated(dev)
        c0 = profiling.counters()
        rk, rcounts, roverflow, rv = call_1d()
        torch.cuda.synchronize()
        got_1d = launches_since(c0, "tilesort", "mergepath")
        n_local = N_MAIN // P
        cap = int(2.0 * n_local / P) + 64
        lt, ll = merge_launches(n_local, 2, dev)
        ft, fl = merge_launches(P * cap, 2, dev)
        want_1d = {"tilesort": P * (lt + ft), "mergepath": P * (ll + fl)}
        want = {k: reps * v for k, v in want_1d.items()}
        if got_1d != want_1d or got != want:
            raise AssertionError(f"2-D sort along {axis}: launches {got} (1-D {got_1d}), "
                                 f"expected {want} ({want_1d})")
        if len(pk) != reps * P or counts.shape != (P,) or overflow.shape != (P,):
            raise AssertionError(f"2-D sort along {axis}: {len(pk)} output shards and counts "
                                 f"of shape {tuple(counts.shape)}; {reps * P} and ({P},) expected")
        c = counts.cpu().numpy()
        balance = float(c.max() / c.mean())
        if bool(overflow.any()) or balance > 1.25:
            raise AssertionError(f"2-D sort along {axis}: overflow {overflow.tolist()} (any "
                                 f"replica), balance {balance:.4f}")
        if not (torch.equal(counts, rcounts) and torch.equal(overflow, roverflow)):
            raise AssertionError(f"2-D sort along {axis}: counts or flags differ from the 1-D "
                                 "sort's")
        for i in range(reps):
            sl = slice(i * P, (i + 1) * P)
            out_k, out_v = gather_sorted(pk[sl], counts, pv[sl])
            check_kv(keys, out_k, out_v)
            del out_k, out_v
            for d in range(P):  # bitwise equal to the 1-D sort, so to each other
                if not (same_bits(pk[i * P + d], rk[d]) and same_bits(pv[i * P + d], rv[d])):
                    raise AssertionError(f"2-D sort along {axis}: replica {i} shard {d} differs "
                                         "from the 1-D sort's")
        # without mesh=: the counts' shape strips one replica, as mesh= does
        out_k, out_v = gather_sorted(pk, counts, pv)
        mesh_k, mesh_v = gather_sorted(pk, counts, pv, mesh=mesh, axis_name=axis)
        if not (out_k.shape == (N_MAIN,) and same_bits(out_k, mesh_k)
                and same_bits(out_v, mesh_v)):
            raise AssertionError(f"2-D sort along {axis}: gather_sorted without mesh= differs "
                                 "from the mesh= form")
        del mesh_k, mesh_v
        t0 = time.perf_counter()
        what = f"gather_sorted without mesh= along {axis!r}"
        require_equal(f"{what}, keys", host_bits(out_k), want_k)
        require_equal(f"{what}, values", host_bits(out_v), perm)
        oracle_s += time.perf_counter() - t0
        del out_k, out_v, pk, pv, rk, rv
        phase("slice", f"sort_sharded n={N_MAIN} stable u32 kv on LocalMesh2D([[cuda:0] * 4] * 2) "
                       f"along {axis!r} (P={P}, {reps} replicas, local engine "
                       f"{'merge' if got['tilesort'] else 'xla'}): every replica an exact stable "
                       f"sort on the device, no overflow, counts {counts.tolist()}, balance "
                       f"{balance:.4f}; every replica bitwise equal to sort_sharded over "
                       f"LocalMesh([cuda:0] * {P}) (padded shards, counts, flags); gather_sorted "
                       f"without mesh= bitwise equal to the mesh= form and to the host runtime's "
                       f"stable argsort; launches {got}, "
                       f"expected {reps} x {want_1d}; peak device memory {peak / 1e9:.3f} GB "
                       f"({before / 1e9:.3f} GB before the call) [{smi}]")
        err = merged_err(err, compare_captured(
            call, f"sort_sharded n={N_MAIN} along {axis!r} of a 2 x 4 mesh, P={P}"))
        whole = time_ms(call, reps=3)
        ms_1d = time_ms(call_1d, reps=3)
        launches[axis] = got
        st[axis] = {"whole": whole, "replica": whole / reps, "1d": ms_1d, "peak_gb": peak / 1e9}
        phase("time", f"sort_sharded n={N_MAIN} along {axis!r} of a 2 x 4 mesh (P={P}, {reps} "
                      f"replicas): whole {whole:.3f} ms, {whole / reps:.3f} a replica; the 1-D "
                      f"sort over LocalMesh([cuda:0] * {P}) {ms_1d:.3f} ms (CUDA events, median "
                      f"of 3) [{smi}]")
    st["err"] = err
    phase("time", f"phase 11b took {time.perf_counter() - t_phase:.2f} s of host, "
                  f"{oracle_s:.3f} of it the host oracle and its checks")
    return launches, st


def check_coranks(dev) -> None:
    """The co-rank mirror against the kernel's own splits at one level of the
    1e8 ladder (runs of 2^20): the kernel merges the level's keys carrying
    each element's position in its input, so every output shows whether it
    came from its pair's A run; the co-rank of an output tile is how many of
    the pair's outputs before it did. ``coranks_plain`` must give exactly
    these, tile by tile."""
    run = 1 << 20
    keys = segsort.to_signed_order(random_u32(dev, N_MAIN, SEED + 12))
    r = merge.default_tile(1, dev)
    runs = merge.tilesort([keys], 1, r)
    while r < run:  # the levels below 2^20
        runs, r = merge.mergepath_level(runs, 1, r), 2 * r
    pos = torch.arange(N_MAIN, dtype=torch.int32, device=dev)
    out_tile = merge.MERGE_TILES[2]
    _, src = merge.mergepath_level([runs[0], pos], 1, run, out_tile=out_tile)
    idx = torch.arange(N_MAIN, device=dev)
    pair0 = idx // (2 * run) * (2 * run)
    from_a = (src.to(torch.int64) < pair0 + run).to(torch.int64)
    before = torch.cumsum(from_a, 0) - from_a  # A outputs before each index, from 0
    starts = torch.arange(0, N_MAIN, out_tile, device=dev)
    kernel_splits = before[starts] - before[pair0[starts]]
    mirror = merge.coranks_plain(runs, 1, run, out_tile)
    same = torch.equal(mirror, kernel_splits)
    phase("compare", f"co-ranks at run {run}, {starts.numel()} output tiles of {out_tile}: "
                     f"coranks_plain equal to the kernel's splits: {same}")
    if not same:
        raise AssertionError("the co-rank mirror disagrees with the kernel's splits")


def check_past_2_31(dev) -> None:
    """n = 2^31 + 4097 keys, one plane, no carry: the tile sort's last three
    tiles (the last ragged, 4097 elements past 2^31) and the merge level of
    runs of one tile on its output, held on its last two run pairs (a whole
    pair ending at 2^31 and the lone run past it), each against its plain
    version run on that slice alone: tiles and run pairs are independent,
    so the slices are exact."""
    n = (1 << 31) + 4097
    tile = merge.default_tile(1, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    keys[::7] = 2**31 - 1  # ties at the top of the signed order
    c0 = profiling.counters()
    (tiled,) = merge.tilesort([keys], 1, tile)
    lo = (cdiv(n, tile) - 3) * tile
    e_tile = max_abs_err([tiled[lo:]], merge.tilesort_plain([keys[lo:]], 1, tile))
    del keys
    (level,) = merge.mergepath_level([tiled], 1, tile)
    lo = (1 << 31) - 2 * tile
    e_merge = max_abs_err([level[lo:]], merge.mergepath_level_plain([tiled[lo:]], 1, tile))
    torch.cuda.synchronize()
    phase("compare", f"n={n} (2^31 + 4097) one key plane: tilesort tile {tile}, last 3 tiles "
                     f"from {(cdiv(n, tile) - 3) * tile}: max_abs_err {e_tile}; mergepath run "
                     f"{tile}, last 2 run pairs from {lo}: max_abs_err {e_merge}; launches "
                     f"{launches_since(c0, 'tilesort', 'mergepath')}")
    if e_tile or e_merge:
        raise AssertionError("the merge kernels disagree with their plain versions past 2^31")


def check_onesweep_near_2_31(dev) -> None:
    """The onesweep sort at n = 2^31 - 1, the top of radix_tiled's envelope,
    where the look-back words' inclusive prefixes reach 2^31 - 1: the u32
    keys n - 1 - i, all distinct, sorted to arange(n), bitwise, with one
    digit histogram and 4 passes."""
    n = (1 << 31) - 1
    keys = torch.arange(n - 1, -1, -1, dtype=torch.int32, device=dev).view(torch.uint32)
    c0 = profiling.counters()
    out, _ = radix_tiled.sort_radix_tiled(keys)
    del keys
    torch.cuda.synchronize()
    launches = launches_since(c0, "digit_histograms", "onesweep")
    ok = same_bits(out, torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32))
    phase("compare", f"n={n} (2^31 - 1) u32 keys n - 1 - i on radix_tiled (onesweep): sorted to "
                     f"arange(n) bitwise: {ok}; launches {launches}")
    if not ok or launches != {"digit_histograms": 1, "onesweep": 4}:
        raise AssertionError("the onesweep sort is wrong at n = 2^31 - 1")


# --- 12. the dispatcher's other paths at the bench size, on their default routes

def counted(call):
    """``call()`` and the launches of every kernel of the dispatcher's
    routes that it made: (result, {kernel: launches > 0})."""
    torch.cuda.synchronize()
    c0 = profiling.counters()
    out = call()
    torch.cuda.synchronize()
    got = launches_since(c0, "tilesort", "mergepath", "histogram", "radix_scatter", "radix_dest",
                         "digit_histograms", "onesweep", "gather_columns")
    return out, {k: v for k, v in got.items() if v}


def expected_launches(path: str, n: int, wide: bool, dev, columns: int = 0) -> dict:
    """The kernel launches of one sort of n keys (u64 if ``wide``) on
    ``path``, with one 4-byte payload, or with ``columns`` payloads that
    radix_tiled gathers after its sort of positions: one digit histogram,
    an onesweep pass a digit and, with ``columns``, one gather launch a
    ``kernels.MAX_COLUMNS`` columns on radix_tiled; one tile sort and a
    launch a level on merge; none on tiled (``torch.sort``)."""
    if path == "tiled":
        return {}
    if path == "radix_tiled":
        want = {"digit_histograms": 1, "onesweep": 8 if wide else 4}
        if columns:
            want["gather_columns"] = cdiv(columns, kernels.MAX_COLUMNS)
        return want
    if path == "merge":
        tiles, levels = merge_launches(n, 2 if wide else 1, dev)
        return {"tilesort": tiles, "mergepath": levels}
    raise AssertionError(f"no ROUTE_TABLE row leads to {path!r}")


WIDE_SLICE = "stable kv, u64 uniform keys, lineitem columns"


def route_slices(dev, zipf: torch.Tensor, smi: str) -> dict:
    """The dispatcher's paths at 1e8 through the public entry points on
    their default routes, each checked exactly on the device with its
    kernel launches counted, and timed beside ``backend="tiled"``
    (torch.sort) on the same keys: stable kv of u64 Zipf keys with an
    arange payload (BASELINE.json config 4 at the bench size); argsort of
    uniform u32 keys and of the u64 Zipf keys (a permutation under which
    the keys are non-decreasing, increasing within equal keys);
    ``stable=False`` kv of uniform u32 keys (keys non-decreasing, values a
    permutation with ``keys_in[values] == keys_out``); stable kv of uniform
    u64 keys with the benchmark's five lineitem columns (``WIDE_SLICE``,
    the ``u64-lineitem-1e8`` cell's call: keys and every column bitwise the
    tiled route's answer); the kv sorts' keys also on the host, bitwise
    against the host runtime's oracle sort. Returns ({slice: launches},
    the host oracle's seconds)."""
    n = N_MAIN
    values = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    u32 = random_u32(dev, n, SEED + 92)
    u64 = random_u64(dev, n, SEED + 94)
    cols = random_columns(dev, n, WIDE_SETS["lineitem"], SEED + 94)

    def by_perm(keys, perm):
        return bits_view(keys)[bits_view(perm).to(torch.int64)].view(keys.dtype)

    def same_as_tiled(out):
        want_k, want_v = vt.sort_pairs(u64, cols, backend="tiled")
        if not (same_bits(out[0], want_k) and all(map(same_bits, out[1], want_v))):
            raise AssertionError(f"{WIDE_SLICE}: the default route's answer is not the tiled "
                                 "route's")

    cases = [
        ("stable kv, u64 zipf keys", "kv", zipf, True,
         lambda b: vt.sort_pairs(zipf, values, backend=b),
         lambda out: check_kv(zipf, *out)),
        (WIDE_SLICE, "kvw", u64, True,
         lambda b: vt.sort_pairs(u64, cols, backend=b), same_as_tiled),
        ("argsort, u32 uniform keys", "argsort", u32, False,
         lambda b: vt.argsort(u32, backend=b),
         lambda perm: check_kv(u32, by_perm(u32, perm), perm)),
        ("argsort, u64 zipf keys", "argsort", zipf, True,
         lambda b: vt.argsort(zipf, backend=b),
         lambda perm: check_kv(zipf, by_perm(zipf, perm), perm)),
        ("stable=False kv, u32 uniform keys", "kv", u32, False,
         lambda b: vt.sort_pairs(u32, values, backend=b, stable=False),
         lambda out: check_kv(u32, *out, stable=False)),
    ]
    launches, oracle_s = {}, 0.0
    for what, op, keys, wide, call, check in cases:
        path = route_for(op, n, wide)
        out, got = counted(lambda: call(None))
        check(out)
        if op != "argsort":  # the kv sorts' keys to the host oracle
            oracle_s += oracle_sorted_keys(f"{what} on its default route {path}", keys, out[0],
                                           smi)
        del out
        want = expected_launches(path, n, wide, dev, len(cols) if op == "kvw" else 0)
        ms = {"default": time_ms(lambda: call(None), reps=3),
              "tiled": time_ms(lambda: call("tiled"), reps=3)}
        phase("slice", f"{what} n={n} on its default route {path}: exact on the device; "
                       f"launches {got}, expected {want}; {ms['default']:.3f} ms against "
                       f"torch.sort's {ms['tiled']:.3f} ms [{smi}]")
        if got != want:
            raise AssertionError(f"{what}: the default route {path} launched {got}, "
                                 f"expected {want}")
        launches[what] = got
    return launches, oracle_s


def radix_passes_u64(dev, keys: torch.Tensor, what: str, smi: str) -> dict:
    """Each of the 8 passes of the per-pass API's sort of u64 ``keys`` with
    an arange u32 payload, on the sort's own intermediate keys: the
    histogram kernel and the rank-and-scatter kernel bitwise against their
    plain versions, and timed beside their bounds (the histogram reads the
    keys, 8 B a key, and writes its table; the pass reads and writes keys
    and payload, 24 B an element, and reads the table) and the share of the
    keys in the pass's most common digit; then the onesweep sort of the
    same keys by kernel (``onesweep_parts``). Returns the per-pass ms, the
    bounds, the errors and the onesweep's parts."""
    tile = histogram.TILE
    n = keys.numel()
    table = 4 * NUM_BINS * cdiv(n, tile)
    st = {"histogram": [], "radix_dest": [], "histogram_bound": bound_ms(8 * n + table),
          "radix_dest_bound": bound_ms(24 * n + table), "err": {"histogram": 0, "radix_dest": 0}}
    cur_k = keys
    cur_v = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    for shift in range(0, 64, 8):
        hist = histogram.tile_histograms(cur_k, shift, tile)
        e_hist = max_abs_err([hist], [histogram.tile_histograms_plain(cur_k, shift, tile)])
        base = reference.exclusive_bin_offsets(hist)
        nxt = radix_tiled.tile_scatter(cur_k, cur_v, shift, tile, base)
        e_move = max_abs_err(list(nxt), list(radix_tiled.tile_scatter_plain(cur_k, cur_v, shift,
                                                                            tile, base)))
        st["err"]["histogram"] = max(st["err"]["histogram"], e_hist)
        st["err"]["radix_dest"] = max(st["err"]["radix_dest"], e_move)
        h_ms = time_ms(lambda: histogram.tile_histograms(cur_k, shift, tile))
        s_ms = time_ms(lambda: radix_tiled.tile_scatter(cur_k, cur_v, shift, tile, base))
        st["histogram"].append(h_ms)
        st["radix_dest"].append(s_ms)
        top = int(hist.sum(0).max()) / n
        phase("time", f"n={n} {what} radix pass at shift {shift}: histogram {h_ms:.4f} ms "
                      f"(bound {st['histogram_bound']:.4f}, {st['histogram_bound'] / h_ms:.1%}), "
                      f"rank-and-scatter {s_ms:.4f} ms (bound {st['radix_dest_bound']:.4f}, "
                      f"{st['radix_dest_bound'] / s_ms:.1%}); the most common digit holds "
                      f"{top:.1%} of the keys; max_abs_err {e_hist} / {e_move} [{smi}]")
        del hist, base
        cur_k, cur_v = nxt
    check_kv(keys, cur_k, cur_v)
    if any(st["err"].values()):
        raise AssertionError(f"radix kernels disagree with their plain versions on the {what} "
                             f"passes: {st['err']}")
    phase("time", f"n={n} {what} per-pass API, 8 passes summed: histogram "
                  f"{sum(st['histogram']):.3f} ms (bound {8 * st['histogram_bound']:.3f}), "
                  f"rank-and-scatter {sum(st['radix_dest']):.3f} ms (bound "
                  f"{8 * st['radix_dest_bound']:.3f}); the passes by hand give the exact stable "
                  f"sort [{smi}]")
    del cur_k, cur_v
    st["onesweep"] = onesweep_parts(
        dev, keys, torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32), what, smi)
    return st


BENCH_NAMES = {"histogram": "tile_histograms", "radix_scatter": "tile_scatter",
               "digit_histograms": "digit_histograms", "onesweep": "onesweep_pass",
               "tilesort": "tilesort", "mergepath": "mergepath_level"}  # wrapper of each kernel


def bench_twin(dev, radix_ms: list, smi: str) -> dict:
    """Phase 14: the port's benchmark, ``python -m vkradixsort_tpu_torch.bench``
    at 1e8, as a subprocess from the root of this checkout (it reuses the
    kernels and host runtime built above). It must exit 0 with exactly one
    JSON line on stdout, holding the contract's four keys and a value above
    0, and its 1e8 sort must have launched the kernels of the default route
    (its stderr logs the launches of that call). Its value is printed
    beside N over phase 5's whole radix_tiled sort (``radix_ms``, three
    runs). Returns {"line": the JSON line, "launches":
    the sort's launches by wrapper}."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the twin allocates in its own process
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "vkradixsort_tpu_torch.bench", "--n", str(N_MAIN)],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=600)
    took = time.perf_counter() - t0
    for line in r.stderr.strip().splitlines()[-40:]:
        phase("bench", f"stderr: {line}")
    out = r.stdout.splitlines()
    if r.returncode != 0 or len(out) != 1:
        raise AssertionError(f"the benchmark twin exited {r.returncode} with {len(out)} stdout "
                             f"lines: {out[:5]}")
    line = json.loads(out[0])
    if set(line) != {"metric", "value", "unit", "vs_baseline"} or not line["value"] > 0:
        raise AssertionError(f"the benchmark twin's line is not the contract's: {line}")
    logged = [s for s in r.stderr.splitlines() if "kernel launches " in s]
    launches = json.loads(logged[-1].split("kernel launches ", 1)[1]) if logged else {}
    want = {BENCH_NAMES[k]: v for k, v in
            expected_launches(route_for("kv", N_MAIN), N_MAIN, False, dev).items()}
    if launches != want:
        raise AssertionError(f"the benchmark twin's 1e8 sort launched {launches}, expected {want}")
    phase5 = [N_MAIN / (ms / 1e3) / 1e6 for ms in radix_ms]
    phase("bench", f"python -m vkradixsort_tpu_torch.bench (n={N_MAIN}): rc 0 in {took:.2f} s of "
                   f"host, stdout {out[0]}; its sort's launches {launches}, expected {want}; value "
                   f"{line['value']} M keys/s against N over phase 5's radix_tiled sort ("
                   + ", ".join(f"{ms:.4f} ms: {x:.1f}" for ms, x in zip(radix_ms, phase5))
                   + f" M keys/s), ratio {line['value'] / statistics.mean(phase5):.4f} [{smi}]")
    return {"line": line, "launches": launches}


def routes_only(dev, smi: str) -> None:
    """``--routes``: the measurements behind the ROUTE_TABLE rows alone, for
    repeated runs: the wide payload sets' crossovers, the carry rule and the
    column gather (phase 10c), the dispatcher's crossovers (phase 10), the
    dist_local crossovers (phase 11) and the radix kernels on the u64
    passes (phase 12). Prints no JSON line."""
    zipf = torch.from_numpy(make_keys(np.random.default_rng(SEED + 70), N_MAIN, np.uint64,
                                      "zipf")).to(dev)
    wide_crossovers(dev, zipf, smi)
    carry_or_gather(dev, smi)
    gather_parts(dev, smi)
    route_crossovers(dev, zipf, smi)
    dist_local_crossovers(dev, smi)
    radix_passes_u64(dev, zipf, "u64 zipf", smi)
    radix_passes_u64(dev, random_u64(dev, N_MAIN, SEED + 93), "u64 uniform", smi)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")

    t_run = time.perf_counter()
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
    if sys.argv[1:] == ["--routes"]:
        routes_only(dev, smi)
        return
    t0 = time.perf_counter()
    so = native.build()  # raises if g++ is missing or fails: no numpy fallback here
    if not native.available():
        raise RuntimeError(f"the host runtime {so} does not load: {native._LIB_ERR}")
    phase("build", f"host runtime (g++) {time.perf_counter() - t0:.2f} s -> {so.name}")

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
    err3 = compare_nck3(dev, rng)
    err = {k: max(v, err3[k]) for k, v in err.items()}
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
    c0 = profiling.counters()
    backend = None if route_for("kv", N_MAIN) == "merge" else "merge"
    out_k, out_v = vt.sort_pairs(keys, values, backend=backend)
    torch.cuda.synchronize()
    launches = launches_since(c0, "tilesort", "mergepath")
    nlev = math.ceil(math.log2(N_MAIN / main_tile))
    check_kv(keys, out_k, out_v)
    phase("slice", f"sort_pairs n={N_MAIN} backend={backend} (the default route is "
                   f"{route_for('kv', N_MAIN)}): exact stable sort on the device; "
                   f"launches {launches}, expected tilesort 1 and mergepath {nlev}")
    if launches != {"tilesort": 1, "mergepath": nlev}:
        raise AssertionError(f"the main path did not run through the kernels: {launches}")
    del out_k, out_v, keys, values

    # --- 4b. the merge path with payload sets past the kernels' two carry planes
    wide_launches = merge_wide_payloads(dev, smi)

    # --- 5. and 6. the radix_tiled and fused paths
    radix_launches, rst = radix_main_path(dev, rng, smi)
    launches.update(radix_launches)
    launches["fused"], fst = fused_main_path(dev, rng, smi)
    for k in ("histogram", "radix_dest"):
        err[k] = max(err[k], rst["err"][k])
    err["onesweep"] = max(err["onesweep"], rst["onesweep"]["err"])
    err["fused"] = max(err["fused"], fst["err"])

    # --- 7. times: merge kernels beside their plain versions, the routes in turns
    for n in (N_SMALL, N_MAIN):
        ms, plain_ms, e, merge_library_ms, nlevels = time_main_path(dev, n, smi)
        err = {k: max(err[k], e.get(k, 0)) for k in err}
    merge_tile_sweep(dev, smi)
    merge_plane_sweep(dev, smi)
    check_coranks(dev)
    check_past_2_31(dev)
    check_onesweep_near_2_31(dev)

    # --- 8. and 9. the bitonic and samplesort paths
    err["bitonic"] = compare_bitonic(dev, rng)
    launches["bitonic"], bst = bitonic_main_path(dev, rng, smi)
    err["bitonic"] = max(err["bitonic"], bst["err"])
    launches["placement"], sst = samplesort_main_path(dev, rng, smi)
    err["placement"] = sst["err"]

    # --- 10. the crossovers behind the route table
    crossovers(dev, smi)
    zipf = torch.from_numpy(make_keys(np.random.default_rng(SEED + 70), N_MAIN, np.uint64,
                                      "zipf")).to(dev)
    route_crossovers(dev, zipf, smi)
    wide_crossovers(dev, zipf, smi)
    carry_or_gather(dev, smi)
    gst = gather_parts(dev, smi)
    err["gather_columns"] = gst["err"]

    # --- 11. the distributed sort on 8 logical shards of the card
    dist_launches, dst = distributed_main_path(dev, rng, smi)
    dsm = distributed_small_paths(dev, rng, smi)
    nccl_world_one(dev, smi)
    n3 = nck3_kernel_times(dev, rng, smi)
    err = merged_err(err, dst["err"], dsm["err"], n3["err"])
    dist_local_crossovers(dev, smi)

    # --- 11b. the distributed sort along one axis of a 2-D mesh
    dist2d_launches, d2 = distributed_2d_path(dev, smi)
    err = merged_err(err, d2["err"])

    # --- 12. the dispatcher's other paths at 1e8, and the radix kernels on u64 keys
    launches["routes"], routes_oracle_s = route_slices(dev, zipf, smi)
    u64 = {"zipf": radix_passes_u64(dev, zipf, "u64 zipf", smi),
           "uniform": radix_passes_u64(dev, random_u64(dev, N_MAIN, SEED + 93), "u64 uniform",
                                       smi)}
    err = merged_err(err, u64["zipf"]["err"], u64["uniform"]["err"])
    err["onesweep"] = max(err["onesweep"], u64["zipf"]["onesweep"]["err"],
                          u64["uniform"]["onesweep"]["err"])

    # --- 13. the reference's fixtures from the host runtime, and what the oracle cost
    fixtures_s = oracle_fixtures(dev, smi)
    phase("oracle", f"host oracle checks took {rst['oracle_s'] + routes_oracle_s + fixtures_s:.3f}"
                    f" s of this run: phase 5 {rst['oracle_s']:.3f}, phase 12 "
                    f"{routes_oracle_s:.3f}, fixtures {fixtures_s:.3f} [host: {host_cpu()}]")

    # --- 14. the port's benchmark, as a user runs it
    twin = bench_twin(dev, rst["sort_ms"], smi)

    one = rst["onesweep"]
    nt = cdiv(N_MAIN, histogram.TILE)
    hist_bytes = 4 * (4 * N_MAIN + 4 * NUM_BINS * nt)  # keys in, table out; 4 passes
    # keys and values read and written, the base table read; 4 passes
    move_bytes = 4 * (16 * N_MAIN + 4 * NUM_BINS * nt)
    phase("time", f"chip_smoke.py took {time.perf_counter() - t_run:.2f} s of host after its "
                  "imports, the builds included")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "tilesort", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/tilesort.cu",
         "replaces": "vkradixsort_tpu/ops/merge.py:311", "launches": launches["tilesort"],
         "max_abs_err": err["tilesort"], "ms": ms["tilesort"], "plain_ms": plain_ms["tilesort"],
         "bound_ms": bound_ms(16 * N_MAIN), "bound_by": "bytes",
         "library_ms": merge_library_ms["tilesort"],
         "dist_launches": dist_launches[(1, "merge")]["tilesort"],
         "dist2d_launches": {a: v["tilesort"] for a, v in dist2d_launches.items()},
         "wide_payload_launches": {k: v["tilesort"] for k, v in wide_launches.items()},
         "shard_ms_nck2_nck3": [n3[2]["tilesort"], n3[3]["tilesort"]]},
        {"name": "mergepath", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/mergepath.cu",
         "replaces": "vkradixsort_tpu/ops/merge.py:655", "launches": launches["mergepath"],
         "max_abs_err": err["mergepath"], "ms": ms["mergepath"],
         "plain_ms": plain_ms["mergepath"], "bound_ms": bound_ms(16 * N_MAIN * nlevels),
         "bound_by": "bytes", "library_ms": merge_library_ms["mergepath"],
         "dist_launches": dist_launches[(1, "merge")]["mergepath"],
         "dist2d_launches": {a: v["mergepath"] for a, v in dist2d_launches.items()},
         "wide_payload_launches": {k: v["mergepath"] for k, v in wide_launches.items()},
         "shard_ms_nck2_nck3": [n3[2]["mergepath"], n3[3]["mergepath"]]},
        {"name": "histogram", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/histogram.cu",
         "replaces": "vkradixsort_tpu/ops/histogram.py:54", "launches": launches["histogram"],
         "api": "the JAX package's per-pass API, off the sort route",
         "max_abs_err": err["histogram"], "ms": rst["histogram"],
         "plain_ms": rst["histogram_plain"], "bound_ms": bound_ms(hist_bytes),
         "bound_by": "bytes", "library_ms": rst["histogram_library"],
         "bench_launches": twin["launches"].get("tile_histograms", 0),
         "u64_zipf_1e8_ms": sum(u64["zipf"]["histogram"]),
         "u64_zipf_1e8_bound_ms": 8 * u64["zipf"]["histogram_bound"],
         "u64_uniform_1e8_ms": sum(u64["uniform"]["histogram"])},
        {"name": "radix_dest", "route": "cuda",
         "source": "vkradixsort_tpu_torch/csrc/radix_dest.cu",
         "replaces": "vkradixsort_tpu/ops/radix_tiled.py:86",
         "api": "the JAX package's per-pass API, off the sort route",
         "launches": launches["radix_scatter"], "max_abs_err": err["radix_dest"],
         "ms": rst["radix_scatter"], "plain_ms": rst["radix_scatter_plain"],
         "bound_ms": bound_ms(move_bytes), "bound_by": "bytes",
         "library_ms": rst["radix_scatter_library"],
         "bench_launches": twin["launches"].get("tile_scatter", 0),
         "pr5": "3.397 ms dest + 1.740 widen + 16.161 torch scatter",
         "u64_zipf_1e8_ms": sum(u64["zipf"]["radix_dest"]),
         "u64_zipf_1e8_bound_ms": 8 * u64["zipf"]["radix_dest_bound"],
         "u64_uniform_1e8_ms": sum(u64["uniform"]["radix_dest"])},
        {"name": "digit_histograms", "route": "cuda",
         "source": "vkradixsort_tpu_torch/csrc/onesweep.cu",
         "replaces": "vkradixsort_tpu/ops/histogram.py:54 (on the sort route, once a sort)",
         "launches": launches["digit_histograms"], "max_abs_err": err["onesweep"],
         "ms": one["histogram"], "plain_ms": one["histogram_plain"],
         "bound_ms": one["histogram_bound"], "bound_by": "bytes",
         "library_ms": one["histogram_library"],
         "bench_launches": twin["launches"].get("digit_histograms", 0),
         "u64_zipf_1e8_ms": u64["zipf"]["onesweep"]["histogram"],
         "u64_zipf_1e8_bound_ms": u64["zipf"]["onesweep"]["histogram_bound"],
         "u64_uniform_1e8_ms": u64["uniform"]["onesweep"]["histogram"]},
        {"name": "onesweep_pass", "route": "cuda",
         "source": "vkradixsort_tpu_torch/csrc/onesweep.cu",
         "replaces": "vkradixsort_tpu/ops/radix_tiled.py:86 (on the sort route)",
         "launches": launches["onesweep"], "max_abs_err": err["onesweep"],
         "ms": sum(one["pass"]), "plain_ms": sum(one["pass_plain"]),
         "bound_ms": 4 * one["pass_bound"], "bound_by": "bytes",
         "library_ms": sum(one["pass_library"]), "shape": one["shape"],
         "bench_launches": twin["launches"].get("onesweep_pass", 0),
         "u64_zipf_1e8_ms": sum(u64["zipf"]["onesweep"]["pass"]),
         "u64_zipf_1e8_bound_ms": 8 * u64["zipf"]["onesweep"]["pass_bound"],
         "u64_zipf_shape": u64["zipf"]["onesweep"]["shape"],
         "u64_uniform_1e8_ms": sum(u64["uniform"]["onesweep"]["pass"])},
        {"name": "gather_columns", "route": "cuda",
         "source": "vkradixsort_tpu_torch/csrc/gather.cu",
         "replaces": "no TPU kernel: torch's int64 indexing a column after a sort of the keys "
                     "with their positions (ops/segsort.sort_flat_pairs)",
         "launches": launches["routes"][WIDE_SLICE]["gather_columns"],
         "max_abs_err": err["gather_columns"], "ms": gst["ms"],
         "plain_ms": gst["plain"], "bound_ms": gst["bound"], "bound_by": "bytes",
         "library_ms": gst["library"], "payloads": "lineitem: 4 x int64 + int32, 1e8 rows",
         "ms_by_width_and_columns": {f"{w}x{c}": v for (w, c), v in gst["widths"].items()}},
        {"name": "fused", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/fused.cu",
         "replaces": "vkradixsort_tpu/ops/fused.py:158", "launches": launches["fused"],
         "max_abs_err": err["fused"], "ms": fst["fused"], "plain_ms": fst["fused_plain"],
         "bound_ms": bound_ms(16 * N_FUSED), "bound_by": "bytes",
         "library_ms": fst["fused_library"], "pr3": "0.2769 ms, 1 launch (PERF.md)"},
        {"name": "bitonic", "route": "cuda", "source": "vkradixsort_tpu_torch/csrc/bitonic.cu",
         "replaces": "vkradixsort_tpu/ops/bitonic.py:119",
         "launches": sum(launches["bitonic"].values()),
         "max_abs_err": err["bitonic"], "ms": bst["ms"], "plain_ms": bst["plain_ms"],
         "bound_ms": bst["bound_ms"], "bound_by": bst["bound_by"],
         "library_ms": bst["library_ms"],
         "pr3": "0.966 ms, 46 launches: 9 in-block, 36 global, 1 gather (PERF.md)"},
        {"name": "placement", "route": "cuda",
         "source": "vkradixsort_tpu_torch/csrc/placement.cu",
         "replaces": "vkradixsort_tpu/ops/samplesort.py:74", "launches": launches["placement"],
         "max_abs_err": err["placement"], "ms": sst["ms"], "plain_ms": sst["plain_ms"],
         "bound_ms": sst["bound_ms"], "bound_by": "bytes", "library_ms": sst["library_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
