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
signed order (one plane for 32-bit keys, (hi, lo) for 64-bit keys) and
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

import torch

from vkradixsort_tpu_torch.engine.context import GPUContext
from vkradixsort_tpu_torch.ops import kernels
from vkradixsort_tpu_torch.ops.common import _MIN32, bits_view, cdiv

# Shared memory on an H100 (sm_90): what one block may opt into, what one SM
# holds, and what the runtime reserves for every resident block. CPU tensors
# size their tiles as the card would, so both run the same ladder.
H100_SMEM_PER_BLOCK_OPTIN = 232448
H100_SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
TILESORT_BLOCKS_PER_SM = 2  # two 1024-thread tile-sort blocks fill an SM's 2048 threads
MAX_KERNEL_CARRY = 2  # carry planes the kernels are instantiated for


def default_tile(nck: int, device: torch.device) -> int:
    """Largest power-of-two tile whose ``nck`` key planes and position plane
    (4 bytes each) fit shared memory ``TILESORT_BLOCKS_PER_SM`` times over on
    one SM of ``device``, so that many tile-sort blocks share each SM (8192
    elements on an H100 for one or two key planes)."""
    per_sm, optin = H100_SMEM_PER_SM, H100_SMEM_PER_BLOCK_OPTIN
    if device.type == "cuda":
        info = GPUContext(device).info
        per_sm, optin = info.smem_per_sm, info.smem_per_block_optin
    budget = min(optin, per_sm // TILESORT_BLOCKS_PER_SM - SMEM_RESERVED_PER_BLOCK)
    return 1 << ((budget // (4 * (nck + 1))).bit_length() - 1)


def _check_planes(planes: list, nck: int) -> None:
    if nck not in (1, 2) or len(planes) < nck:
        raise ValueError(f"need 1 or 2 compare planes, got nck={nck} of {len(planes)}")
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
    planes: the plane itself, or (hi << 32) + (lo + 2^31) in int64."""
    if nck == 1:
        return planes[0]
    return (planes[0].to(torch.int64) << 32) + (planes[1].to(torch.int64) - _MIN32)


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
    smem = 4 * (nck + 1) * tile
    limit = GPUContext(planes[0].device).info.smem_per_block_optin
    if smem > limit:
        raise ValueError(f"tile {tile} needs {smem} B of shared memory, the card has {limit}")
    outs = [torch.empty_like(p) for p in planes]
    n = planes[0].numel()
    if n:
        kernels.launch("tilesort", planes, outs, nck, n, tile)
        tilesort.launches += 1
    return outs


tilesort.launches = 0


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


def mergepath_level(planes: list, nck: int, run: int) -> list:
    """Merge each pair of sorted runs of ``run`` elements (a power of two)
    into one sorted run of ``2 * run``, stably. Returns new planes."""
    _check_planes(planes, nck)
    _check_pow2("run", run)
    if planes[0].device.type == "cpu":
        return mergepath_level_plain(planes, nck, run)
    _check_kernel_planes(planes, nck)
    outs = [torch.empty_like(p) for p in planes]
    n = planes[0].numel()
    if n:
        kernels.launch("mergepath", planes, outs, nck, n, run)
        mergepath_level.launches += 1
    return outs


mergepath_level.launches = 0


# ---------------------------------------------------------------------------
# the ladder: one tile sort, then the merge levels


def sort_merge_planes(planes: list, nck: int, *, tile: int | None = None) -> list:
    """Sort int32 planes lexicographically by the first ``nck``, stably.

    ``planes``: 1-D int32 tensors of one length on one device, compare
    planes (signed order, see ops/segsort.to_signed_order) first. ``tile``
    is the tile-sort grain in elements (default: :func:`default_tile`).
    Runs one tile sort and ceil(log2(n / tile)) merge levels."""
    if tile is None:
        tile = default_tile(nck, planes[0].device)
    out = tilesort(planes, nck, tile)
    run = tile
    while run < out[0].numel():
        out = mergepath_level(out, nck, run)
        run *= 2
    return out


def _join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def sort_merge(enc: torch.Tensor, vals: tuple = (), *, tile: int | None = None):
    """Merge engine on encoded (unsigned) keys with payloads; stable.

    Accepts uint32/uint64 encoded keys and 4- or 8-byte payloads that need
    at most ``MAX_KERNEL_CARRY`` int32 carry planes (two for 8 bytes);
    returns ``(sorted_enc, sorted_vals_tuple)``. Wider payload sets take the
    "tiled" engine (``ops/dispatch._route``).
    """
    if enc.dtype == torch.uint32:
        key_planes = [enc.view(torch.int32) ^ _MIN32]
    elif enc.dtype == torch.uint64:
        bits = enc.view(torch.int64)
        key_planes = [(bits >> 32).to(torch.int32) ^ _MIN32, bits.to(torch.int32) ^ _MIN32]
    else:
        raise TypeError(f"merge engine sorts encoded u32/u64 keys, got {enc.dtype}")
    nck = len(key_planes)
    carry = []
    for v in vals:
        size = v.element_size()
        if size == 8:
            b = bits_view(v)
            carry += [(b >> 32).to(torch.int32), b.to(torch.int32)]
        elif size == 4:
            carry.append(bits_view(v).contiguous())
        else:
            raise TypeError(f"merge engine carries 4/8-byte payloads, got {v.dtype}")
    if len(carry) > MAX_KERNEL_CARRY:
        raise ValueError(
            f"the merge engine carries at most {MAX_KERNEL_CARRY} int32 planes of payload, "
            f"got {len(carry)}; sort them with backend='tiled'"
        )
    out = sort_merge_planes(key_planes + carry, nck, tile=tile)
    if enc.dtype == torch.uint32:
        out_enc = (out[0] ^ _MIN32).view(torch.uint32)
    else:
        out_enc = _join64(out[0] ^ _MIN32, out[1] ^ _MIN32).view(torch.uint64)
    out_vals = []
    pos = nck
    for v in vals:
        if v.element_size() == 8:
            out_vals.append(_join64(out[pos], out[pos + 1]).view(v.dtype))
            pos += 2
        else:
            out_vals.append(out[pos].view(v.dtype))
            pos += 1
    return out_enc, tuple(out_vals)
