"""Merge-path large-N engine: tile sorts, then a ladder of merge levels.

Port of ``vkradixsort_tpu/ops/merge.py`` (``sort_merge`` and
``sort_merge_planes``), and the stable key-value sort's main path:

  1. ``tilesort``: every ``tile``-element tile of the input is sorted in one
     block's shared memory (kernel ``csrc/tilesort.cu``), giving sorted runs
     of ``tile`` elements;
  2. ``mergepath_level``, once per run-doubling level: sorted runs of ``run``
     elements merge pairwise into runs of ``2 * run`` (kernel
     ``csrc/mergepath.cu``), reading one buffer and writing the other.

Everything runs on PLANES of int32: the first ``nck`` planes are the key in
signed order (one plane for 32-bit keys, (hi, lo) for 64-bit keys, and a
third for a tie-break such as the distributed sort's global position) and
compare lexicographically; the rest are carried payload. Both kernels
break ties by input order (in-tile position; A before B in a merge), so
the sort is stable without a position plane through device memory, and
its result is the one stable order the JAX engine also produces.

Each kernel has a plain PyTorch version beside it with the same signature
(``tilesort_plain``, ``mergepath_level_plain``). A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises. The TPU layout of the JAX engine (alternating run
directions, the synthetic tie plane, row-aligned windows, the XLA seed)
has no counterpart here; see the notes at the top of each kernel source.
"""

from __future__ import annotations

import functools

import torch

from vkradixsort_tpu_torch.engine.context import GPUContext
from vkradixsort_tpu_torch.ops import kernels
from vkradixsort_tpu_torch.ops.common import _MIN32, bits_view, cdiv, take
from vkradixsort_tpu_torch.utils import profiling

# Shared memory on an H100 (sm_90): what one block may opt into, what one SM
# holds, and what the runtime reserves for every resident block. CPU tensors
# size their tiles as the card would, so both run the same ladder.
H100_SMEM_PER_BLOCK_OPTIN = 232448
H100_SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
MAX_KERNEL_CARRY = 2  # carry planes the kernels are instantiated for
INDEX32_LIMIT = 1 << 31  # a carried local index is int32 below it, int64 (two planes) from it

# The tile-sort kernel (csrc/tilesort.cu): TILESORT_PER_THREAD elements a
# thread, at least 256 threads (one per digit in its scan), at most
# TILESORT_MAX_THREADS[nck]; a slot of TILESORT_SLOT_BYTES[nck] an element.
TILESORT_PER_THREAD = 16
TILESORT_MIN_THREADS = 256
TILESORT_MAX_THREADS = {1: 1024, 2: 1024, 3: 512}
TILESORT_SLOT_BYTES = {1: 8, 2: 10, 3: 14}

# The merge-path kernel (csrc/mergepath.cu): output tiles of MERGE_TILES[p]
# elements for p planes (keys and carries), two staged tiles in shared
# memory, as many persistent blocks as fit an SM. A block takes
# mergepath_smem(p, tile) bytes and an SM holds 233,472, less 1 KB a block:
# at 4096, three blocks an SM at 1 plane, two at 2, one at 3 and 4; 8192
# fits one block at 1 and 2 planes and none at 3 or 4. Each entry is the
# fastest tile of the H100 sweep of a 1e8 sort's merge levels (PERF.md): 1
# plane 4096 (2048 and 8192 12-23% slower), 2 planes 8192 (0.3-0.7% faster
# than 4096), 3 planes 2048 (7% faster than 4096), 4 planes 4096 (1.3-1.6%
# faster than 2048), 5 planes (three compare planes, two carries) 4096
# (1.3% faster than 2048).
MERGE_TILES = {1: 4096, 2: 8192, 3: 2048, 4: 4096, 5: 4096}
MERGE_STAGES = 2
MERGE_SLACK = 16  # ints a staged plane holds past its tile
MERGE_HEADER = 256  # bytes of barriers and tile records


def tilesort_smem(nck: int, tile: int) -> int:
    """Bytes of shared memory one tile-sort block takes: a slot per element
    (key and position, 8 bytes for one key plane, 10 for two, 14 for three)
    and a row of 256 digit counters (1 KB) per warp."""
    threads = max(tile // TILESORT_PER_THREAD, TILESORT_MIN_THREADS)
    return TILESORT_SLOT_BYTES[nck] * tile + threads // 32 * 1024


def tilesort_max_tile(nck: int) -> int:
    """The largest tile one tile-sort block takes at ``nck`` key planes."""
    return TILESORT_PER_THREAD * TILESORT_MAX_THREADS[nck]


@functools.lru_cache(maxsize=None)
def smem_limits(device: torch.device) -> tuple:
    """(bytes one block may opt into, bytes one SM holds) on ``device``,
    asked once per device: the query costs the host more than a launch."""
    if device.type == "cuda":
        info = GPUContext(device).info
        return info.smem_per_block_optin, info.smem_per_sm
    return H100_SMEM_PER_BLOCK_OPTIN, H100_SMEM_PER_SM


def default_tile(nck: int, device: torch.device) -> int:
    """The tile sort's default tile: the largest power of two whose slots
    and counters (:func:`tilesort_smem`) fit the shared memory one block
    may opt into, within the kernel's threads: 16384 on an H100 (160 KB
    for one key plane, 192 KB for two; one 1024-thread block an SM), 8192
    for three (128 KB; 16384 would take 256). In the
    H100 sweep (PERF.md) 8192 sorted its tiles faster, two blocks an SM,
    but 16384 made the whole sort faster: it takes one merge level off the
    ladder. The stable result does not depend on the tile."""
    optin, _ = smem_limits(device)
    tile = tilesort_max_tile(nck)
    while tilesort_smem(nck, tile) > optin:
        tile //= 2
    return tile


def mergepath_smem(nplanes: int, tile: int) -> int:
    """Bytes of shared memory one merge-path block takes: barriers and tile
    records, then per stage every plane's windows and the tile's sources."""
    return MERGE_HEADER + MERGE_STAGES * (nplanes * (tile + MERGE_SLACK) + tile) * 4


def _check_planes(planes: list, nck: int) -> None:
    if nck not in (1, 2, 3) or len(planes) < nck:
        raise ValueError(f"need 1, 2 or 3 compare planes, got nck={nck} of {len(planes)}")
    p0 = planes[0]
    for p in planes:
        if p.dtype != torch.int32 or p.dim() != 1 or p.shape != p0.shape:
            raise ValueError("planes must be 1-D int32 tensors of one length")
        if p.device != p0.device:
            raise ValueError("planes must lie on one device")


def _check_kernel_planes(planes: list, nck: int) -> None:
    if planes[0].device.type != "cuda":
        raise ValueError(f"the merge kernels run on CUDA tensors, got {planes[0].device}")
    if len(planes) - nck > MAX_KERNEL_CARRY:
        raise ValueError(
            f"the merge kernels carry at most {MAX_KERNEL_CARRY} planes, got {len(planes) - nck}"
        )
    if not all(p.is_contiguous() for p in planes):
        raise ValueError("the merge kernels take contiguous planes")


def _check_pow2(name: str, x: int) -> None:
    if x < 2 or x & (x - 1):
        raise ValueError(f"{name} must be a power of two >= 2, got {x}")


def _lex_key(planes: list, nck: int) -> torch.Tensor:
    """One tensor whose order is the lexicographic order of the compare
    planes, equal where the keys are equal: the plane itself, (hi << 32) +
    (lo + 2^31) in int64, or for three planes each key's dense rank among
    the keys (found by two stable sorts, low plane first)."""
    if nck == 1:
        return planes[0]
    pair = (planes[0].to(torch.int64) << 32) + (planes[1].to(torch.int64) - _MIN32)
    if nck == 2:
        return pair
    _, order = torch.sort(planes[2], stable=True)
    order = order[torch.sort(pair[order], stable=True)[1]]
    hi, lo = pair[order], planes[2][order]
    new = torch.ones_like(hi, dtype=torch.bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    rank = torch.empty_like(hi)
    rank[order] = torch.cumsum(new, 0) - 1
    return rank


def _padded(key: torch.Tensor, length: int) -> torch.Tensor:
    """``key`` padded to ``length`` with the dtype's maximum, which stable
    sorts and A-first merges place after every real element."""
    out = torch.full((length,), torch.iinfo(key.dtype).max, dtype=key.dtype, device=key.device)
    out[: key.numel()] = key
    return out


# ---------------------------------------------------------------------------
# tile sort


def tilesort_plain(planes: list, nck: int, tile: int) -> list:
    """Plain version of the tile-sort kernel: a stable sort of every tile on
    the compare planes, then a gather of every plane."""
    key = _lex_key(planes, nck)
    n = key.numel()
    ntiles = cdiv(n, tile)
    _, order = torch.sort(_padded(key, ntiles * tile).view(ntiles, tile), dim=1, stable=True)
    base = tile * torch.arange(ntiles, device=key.device)[:, None]
    src = (order + base).view(-1)[:n]
    return [p[src] for p in planes]


def tilesort(planes: list, nck: int, tile: int) -> list:
    """Sort every ``tile``-element tile of the planes lexicographically on the
    first ``nck`` (stable). Returns new planes; the input is not modified."""
    _check_planes(planes, nck)
    _check_pow2("tile", tile)
    if planes[0].device.type == "cpu":
        return tilesort_plain(planes, nck, tile)
    _check_kernel_planes(planes, nck)
    smem = tilesort_smem(nck, tile)
    limit = smem_limits(planes[0].device)[0]
    if smem > limit:
        raise ValueError(f"tile {tile} needs {smem} B of shared memory, the card has {limit}")
    outs = [torch.empty_like(p) for p in planes]
    n = planes[0].numel()
    if n:
        kernels.launch("tilesort", planes, outs, nck, n, tile)
        profiling.count("launch.tilesort")
    return outs


# ---------------------------------------------------------------------------
# merge-path level


def _merge_dest(key: torch.Tensor, run: int) -> torch.Tensor:
    """(npairs, 2, run) position of every element of each run pair (A, B) in
    their stable merge, local to the pair: an A element goes after the B
    elements strictly less than it, a B element after the A elements less
    than or equal to it. Slots past the input are padding."""
    npairs = cdiv(key.numel(), 2 * run)
    pairs = _padded(key, npairs * 2 * run).view(npairs, 2, run)
    a, b = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
    idx = torch.arange(run, device=key.device)
    dest_a = idx + torch.searchsorted(b, a, right=False)
    dest_b = idx + torch.searchsorted(a, b, right=True)
    return torch.stack([dest_a, dest_b], dim=1)


def mergepath_level_plain(planes: list, nck: int, run: int) -> list:
    """Plain version of the merge-path kernel: every pair of sorted runs of
    ``run`` elements merged stably (A first on ties) by scattering each
    element to its rank in the pair."""
    n = planes[0].numel()
    dest = _merge_dest(_lex_key(planes, nck), run)
    base = 2 * run * torch.arange(dest.shape[0], device=dest.device)[:, None, None]
    dest = (dest + base).view(-1)[:n]
    outs = []
    for p in planes:
        o = torch.empty_like(p)
        o[dest] = p
        outs.append(o)
    return outs


def level_splits_plain(planes: list, nck: int, run: int, tile: int) -> torch.Tensor:
    """Co-rank of every ``tile``-element output tile of the level that merges
    runs of ``run``: how many of the outputs before the tile's start, within
    its run pair, come from the pair's A run. These are the split points the
    merge-path kernel searches for (and ``_level_splits`` in the JAX engine)."""
    n = planes[0].numel()
    dest_a = _merge_dest(_lex_key(planes, nck), run)[:, 0]
    starts = torch.arange(0, n, tile, device=dest_a.device)
    pair = starts // (2 * run)
    diag = starts - pair * 2 * run
    return torch.searchsorted(dest_a[pair], diag[:, None]).view(-1)


def coranks_plain(planes: list, nck: int, run: int, tile: int) -> torch.Tensor:
    """The merge-path kernel's co-rank search in plain torch: the co-rank of
    every ``tile``-element output tile's start (as :func:`level_splits_plain`
    gives it), found as the kernel's producer warp finds it. The interval
    starts as [max(0, d - len(B)), min(d, len(A))] for diagonal d, and the
    predicate A[x] <= B[d-1-x] holds on a prefix of it; each round probes 32
    evenly spaced points x = lo + lane * ceil((hi - lo) / 32) below hi, and
    with k of them holding, the crossing lies in (the k-th probe, the
    (k+1)-th probe or hi]. (The kernel narrows a tile's end to within
    ``tile`` of its start first; the co-rank is the same.)"""
    key = _lex_key(planes, nck)
    n = key.numel()
    dev = key.device
    starts = torch.arange(0, n, tile, device=dev)
    a0 = starts // (2 * run) * (2 * run)
    b0 = a0 + run
    d = starts - a0
    lo = (d - (n - b0).clamp(0, run)).clamp(min=0)
    hi = torch.minimum(d, (n - a0).clamp(max=run))
    lane = torch.arange(32, device=dev)
    while bool((lo < hi).any()):
        step = (hi - lo + 31) // 32
        x = lo[:, None] + lane * step[:, None]
        probe = x < hi[:, None]
        ai = (a0[:, None] + x).clamp(max=n - 1)
        bi = (b0[:, None] + d[:, None] - 1 - x).clamp(0, n - 1)
        k = (probe & (key[ai] <= key[bi])).sum(1)
        hit = k > 0
        hi = torch.where(hit, torch.minimum(hi, lo + k * step), lo)
        lo = torch.where(hit, lo + (k - 1) * step + 1, lo)
    return lo


def mergepath_level(planes: list, nck: int, run: int, *, out_tile: int | None = None) -> list:
    """Merge each pair of sorted runs of ``run`` elements (a power of two)
    into one sorted run of ``2 * run``, stably. Returns new planes.
    ``out_tile``: the kernel's output tile, a power of two >= 4 (default
    ``MERGE_TILES`` for the plane count); the result does not depend on it."""
    _check_planes(planes, nck)
    _check_pow2("run", run)
    if planes[0].device.type == "cpu":
        return mergepath_level_plain(planes, nck, run)
    _check_kernel_planes(planes, nck)
    if out_tile is None:
        out_tile = MERGE_TILES[len(planes)]
    if out_tile < 4 or out_tile & (out_tile - 1):
        raise ValueError(f"out_tile must be a power of two >= 4, got {out_tile}")
    smem = mergepath_smem(len(planes), min(out_tile, 2 * run))
    limit = smem_limits(planes[0].device)[0]
    if smem > limit:
        raise ValueError(f"out_tile {out_tile} needs {smem} B of shared memory, the card has {limit}")
    outs = [torch.empty_like(p) for p in planes]
    n = planes[0].numel()
    if n:
        kernels.launch("mergepath", planes, outs, nck, n, run, out_tile)
        profiling.count("launch.mergepath_level")
    return outs


# ---------------------------------------------------------------------------
# the ladder: one tile sort, then the merge levels


def sort_merge_planes(planes: list, nck: int, *, tile: int | None = None) -> list:
    """Sort int32 planes lexicographically by the first ``nck``, stably.

    ``planes``: 1-D int32 tensors of one length on one device, compare
    planes (signed order, see ops/segsort.to_signed_order) first. ``tile``
    is the tile-sort grain in elements (default: :func:`default_tile`): any
    grain the JAX package takes, floored to a power of two of at least 2 (as
    its ``grain_to_tile_rows`` floors) and capped at :func:`default_tile`,
    the largest tile one block sorts; the result does not depend on it.
    Runs one tile sort and ceil(log2(n / tile)) merge levels."""
    cap = default_tile(nck, planes[0].device)
    tile = cap if tile is None else min(1 << max(int(tile).bit_length() - 1, 1), cap)
    out = tilesort(planes, nck, tile)
    run = tile
    while run < out[0].numel():
        out = mergepath_level(out, nck, run)
        run *= 2
    return out


def _join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def carry_planes(vals, n: int, device) -> tuple:
    """The int32 carry planes of the payloads ``vals`` (each of ``n``
    elements) and how to take the sorted payloads back from them.

    A 4-byte payload is one plane and an 8-byte one two (hi, lo), while
    they fit the kernels' ``MAX_KERNEL_CARRY`` planes. A wider set stays
    where it is: one local index rides instead, int32 below
    ``INDEX32_LIMIT`` and int64 split into two planes from there, and every
    payload is gathered through the sorted index (``ops/common.take``). The
    sort is stable and the gather exact, so both forms give the same bits.
    1- and 2-byte payloads raise ``TypeError``, as in the JAX engine.
    Returns ``(planes, unpack)``; ``unpack(sorted_planes)`` is the list of
    sorted payloads."""
    for v in vals:
        if v.element_size() not in (4, 8):
            raise TypeError(f"merge engine carries 4/8-byte payloads, got {v.dtype}")
    if sum(v.element_size() // 4 for v in vals) <= MAX_KERNEL_CARRY:
        planes = []
        for v in vals:
            b = bits_view(v)
            if b.element_size() == 8:
                planes += [(b >> 32).to(torch.int32), b.to(torch.int32)]
            else:
                planes.append(b.contiguous())

        def unpack(out: list) -> list:
            got, pos = [], 0
            for v in vals:
                if v.element_size() == 8:
                    got.append(_join64(out[pos], out[pos + 1]).view(v.dtype))
                    pos += 2
                else:
                    got.append(out[pos].view(v.dtype))
                    pos += 1
            return got

        return planes, unpack
    if n < INDEX32_LIMIT:
        planes = [torch.arange(n, dtype=torch.int32, device=device)]
    else:
        idx = torch.arange(n, dtype=torch.int64, device=device)
        planes = [(idx >> 32).to(torch.int32), idx.to(torch.int32)]

    def unpack(out: list) -> list:
        idx = out[0] if len(out) == 1 else _join64(out[0], out[1])
        return [take(v, idx) for v in vals]

    return planes, unpack


def sort_merge(enc: torch.Tensor, vals: tuple = (), *, tile: int | None = None):
    """Merge engine on encoded (unsigned) keys with payloads; stable.

    Accepts uint32/uint64 encoded keys and any number of 4- or 8-byte
    payloads (:func:`carry_planes`: up to ``MAX_KERNEL_CARRY`` int32 planes
    ride through the kernels, a wider set as one local index and a gather a
    payload); returns ``(sorted_enc, sorted_vals_tuple)``.
    """
    if enc.dtype == torch.uint32:
        key_planes = [enc.view(torch.int32) ^ _MIN32]
    elif enc.dtype == torch.uint64:
        bits = enc.view(torch.int64)
        key_planes = [(bits >> 32).to(torch.int32) ^ _MIN32, bits.to(torch.int32) ^ _MIN32]
    else:
        raise TypeError(f"merge engine sorts encoded u32/u64 keys, got {enc.dtype}")
    nck = len(key_planes)
    carry, unpack = carry_planes(vals, enc.shape[0], enc.device)
    out = sort_merge_planes(key_planes + carry, nck, tile=tile)
    if enc.dtype == torch.uint32:
        out_enc = (out[0] ^ _MIN32).view(torch.uint32)
    else:
        out_enc = _join64(out[0] ^ _MIN32, out[1] ^ _MIN32).view(torch.uint64)
    return out_enc, tuple(unpack(out[nck:]))
