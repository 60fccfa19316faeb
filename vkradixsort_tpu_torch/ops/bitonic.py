"""Bitonic engine: the whole padded array through one bitonic network.

Port of ``vkradixsort_tpu/ops/bitonic.py``. Keys are compared as a
lexicographic tuple of int32 planes: 4-byte keys are one plane, 8-byte keys
two order-isomorphic planes (hi, lo) (:func:`_split_planes`). The array is
padded to a power of two >= 1024 with the key dtype's maximum, which is
INT32_MAX in every plane. With payloads the sort is stable: the padded
position is the last compare plane, so ties resolve to input order and a
real maximum key keeps its payload.

On a CUDA tensor :func:`bitonic_sort_block` runs the kernels of
``csrc/bitonic.cu`` on the schedule :func:`plan` builds. A block cannot wait
for another inside a launch, so the network runs as the global bitonic
sort, on the key planes and the position plane in device memory:

  1. the first :class:`BlockPass`: each tile of ``tile`` elements
     (:func:`block_tile`) is padded and sorted in one block's shared memory
     by the network up to size ``tile``, directions from the global index;
  2. for every level ``k > tile``: its distances ``j >= tile`` in
     :class:`GlobalGroup` launches of up to ``GROUP_DISTANCES[nk]``
     distances each (each thread holds in registers the ``2^r`` elements
     whose indices differ in those distances' bits and runs the ``r``
     stages there, so ``r`` stages cost one pass over the planes), then a
     :class:`BlockPass` with the level's stages ``j < tile``;
  3. ``gather_payload``: one launch per payload moves it by the final
     position.

An in-block pass runs its stages in rounds (:func:`block_rounds`): in a
round each thread holds in registers the ``2^ROUND_BITS`` elements of the
tile whose in-tile indices differ only in the round's window of
``ROUND_BITS`` bits, runs every stage whose distance is one of those bits,
and writes them back to shared memory; a barrier separates rounds.

Any schedule that keeps each compare-exchange's partner ``i ^ j``, its
direction from ``i & k`` and the order of stages on every element sorts the
one total order to the same result, so the answer is the JAX kernel's
bitwise. On a CPU tensor the plain version :func:`bitonic_sort_block_plain`
runs the JAX kernel's network as vectorised torch, stage by stage in order.
:func:`scheduled_sort_plain` runs the kernels' schedule with their index
maps (groups, rounds, thread bits, shared-memory swizzle) in plain torch,
so the CPU tests can hold the schedule itself against both; no path of the
engine calls it.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import torch

from vkradixsort_tpu_torch.ops import kernels, merge
from vkradixsort_tpu_torch.ops.common import _MIN32, bits_view
from vkradixsort_tpu_torch.utils import profiling

LANES = 128
MIN_PADDED = LANES * 8  # the JAX kernel's smallest (8, 128) block

# Size contract of the engine (dispatch raises above it), the JAX formula
# ``budget // (16 * nplanes)`` with the budget fixed: on a CUDA tensor the
# 64 MiB of VMEM of the TPU v5e that set the JAX engine's envelope (here the
# stages past one tile run from device memory, so it is a contract, not a
# limit of the card); on a CPU tensor the JAX package's own CPU budget, so
# both packages refuse at the same N.
CUDA_BUDGET_BYTES = 64 * 2**20
CPU_BUDGET_BYTES = 16 * 2**20


def max_n(device: torch.device, nplanes: int) -> int:
    """Largest N the engine takes on ``device`` with ``nplanes`` resident
    int32 planes (key planes, one per 4 payload bytes, and the position
    plane when there are payloads)."""
    budget = CUDA_BUDGET_BYTES if device.type == "cuda" else CPU_BUDGET_BYTES
    return budget // (16 * nplanes)


def _is_signed_int(dtype: torch.dtype) -> bool:
    return dtype.is_signed and not dtype.is_floating_point


def _split_planes(x: torch.Tensor) -> list:
    """8-byte tensor -> two order-isomorphic int32 planes (hi, lo); 4-byte ->
    one int32 plane preserving its natural order (unsigned: sign bit
    flipped; anything else: its bits)."""
    if x.element_size() == 8:
        b = bits_view(x)
        hi = (b >> 32).to(torch.int32)
        hi_p = hi if _is_signed_int(x.dtype) else hi ^ _MIN32
        return [hi_p, b.to(torch.int32) ^ _MIN32]
    if not x.dtype.is_floating_point and not x.dtype.is_signed:
        return [bits_view(x) ^ _MIN32]
    return [bits_view(x)]


def _join_planes(planes: list, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_split_planes`."""
    if dtype.itemsize == 8:
        hi_p, lo_p = planes
        hi = hi_p if _is_signed_int(dtype) else hi_p ^ _MIN32
        lo = lo_p ^ _MIN32
        u = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
        return u.view(dtype)
    (p,) = planes
    if not dtype.is_floating_point and not dtype.is_signed:
        p = p ^ _MIN32
    return p.view(dtype)


def _padded_size(n: int) -> int:
    return 1 << (max(n, MIN_PADDED) - 1).bit_length()


def _check_input(keys: torch.Tensor, values: tuple) -> None:
    if keys.element_size() not in (4, 8):
        raise TypeError(
            f"bitonic sorts 4/8-byte integer keys, got {keys.dtype}; "
            "encode smaller dtypes to uint32 first (ops/common.encode_keys)"
        )
    if keys.dim() != 1:
        raise ValueError(f"bitonic sorts 1-D keys, got shape {tuple(keys.shape)}")
    for v in values:
        if v.element_size() not in (4, 8):
            raise TypeError(f"bitonic carries 4/8-byte values, got {v.dtype}")
        if v.shape != keys.shape or v.device != keys.device:
            raise ValueError("values must have the keys' shape and device")


# ---------------------------------------------------------------------------
# plain version: the JAX kernel's network, stage by stage


def _lex_lt_gt(aps: list, bps: list):
    """(a < b, a > b) lexicographically over the planes, most significant
    first."""
    lt = aps[-1] < bps[-1]
    gt = bps[-1] < aps[-1]
    for a, b in zip(reversed(aps[:-1]), reversed(bps[:-1])):
        eq = a == b
        lt = (a < b) | (eq & lt)
        gt = (b < a) | (eq & gt)
    return lt, gt


def bitonic_sort_block_plain(keys: torch.Tensor, values: tuple = (), stable: bool = False):
    """Plain version of :func:`bitonic_sort_block`: the padded planes (and
    the position plane when stable) through every compare-exchange stage of
    the network in order, as vectorised torch: partner ``i ^ j``, direction
    from ``i & k``. The payloads move by the final position."""
    if values:
        stable = True
    _check_input(keys, values)
    n = keys.shape[0]
    npad = _padded_size(n)
    flat = torch.arange(npad, device=keys.device)
    planes = []
    for p in _split_planes(keys):
        padded = torch.full((npad,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                            device=keys.device)
        padded[:n] = p
        planes.append(padded)
    if stable:
        planes.append(flat.to(torch.int32))
    k = 2
    while k <= npad:
        j = k // 2
        while j >= 1:
            partner = flat ^ j
            pplanes = [p[partner] for p in planes]
            want_lo = ((flat & j) == 0) == ((flat & k) == 0)
            plt, pgt = _lex_lt_gt(pplanes, planes)
            take = torch.where(want_lo, plt, pgt)
            planes = [torch.where(take, pp, p) for pp, p in zip(pplanes, planes)]
            j //= 2
        k *= 2
    nk = len(planes) - (1 if stable else 0)
    out_k = _join_planes([p[:n] for p in planes[:nk]], keys.dtype)
    if not values:
        return out_k, ()
    pos = planes[-1][:n].to(torch.int64)
    return out_k, tuple(bits_view(v)[pos].view(v.dtype) for v in values)


# ---------------------------------------------------------------------------
# the kernels' schedule

# Global distances per GlobalGroup launch, per number of key planes: a
# thread holds 2^r elements of nk + 1 planes in registers (32 for one key
# plane, 48 for two; csrc/bitonic.cu instantiates r = 1..4).
GROUP_DISTANCES = {1: 4, 2: 4}
# An in-block round holds 2^ROUND_BITS elements per thread (csrc/bitonic.cu
# kRoundBits).
ROUND_BITS = 4
# Most stages one in-block launch takes (csrc/bitonic.cu kMaxStages): the
# first pass at a tile of 2^14 runs 105.
MAX_BLOCK_STAGES = 128
# Largest tile the in-block kernel takes: its swizzle folds bits 5-14 of the
# in-tile index into the bank bits.
MAX_TILE = 1 << 15


class GlobalGroup(NamedTuple):
    """One launch of ``r`` consecutive stages of the level of size
    ``2**level`` over the whole work buffer: the distances ``2**top``,
    ``2**(top - 1)``, ..., ``2**(top - r + 1)``, each at least the tile."""

    level: int
    top: int
    r: int


class BlockPass(NamedTuple):
    """One in-block launch, one block per tile. ``first``: pads the input
    planes into the work buffer and runs every level up to the tile; else it
    runs the stages below the tile of one level on the work buffer.
    ``stages``: ``(window top, size log2, distance log2)`` per stage, in
    network order, tagged by :func:`block_rounds`."""

    first: bool
    stages: tuple


def block_rounds(stages) -> tuple:
    """Tags each ``(size log2, distance log2)`` stage of an in-block pass, in
    order, with the top bit of its round's window of ``ROUND_BITS`` bits. A
    round opens at the first stage whose distance bit ``b`` lies outside the
    open window, with the window ``{t, t - 1, ..., t - ROUND_BITS + 1}``,
    ``t = max(b, ROUND_BITS - 1)``; consecutive rounds differ in their top."""
    out, top = [], None
    for size_log, b in stages:
        if top is None or not top - ROUND_BITS < b <= top:
            top = max(b, ROUND_BITS - 1)
        out.append((top, size_log, b))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def plan(npad: int, tile: int, nk: int) -> tuple:
    """The kernels' schedule of the network over ``npad`` elements (a power
    of two) with tiles of ``min(tile, npad)`` and ``nk`` key planes: a tuple
    of :class:`BlockPass` and :class:`GlobalGroup` launches, in order. Every
    stage ``(level k, distance j)`` of the network appears once, in network
    order (:func:`plan_stages`). Cached: it is built once per shape."""
    if npad < 1 or npad & (npad - 1) or tile < 1 or tile & (tile - 1):
        raise ValueError(f"npad and tile must be powers of two, got {npad} and {tile}")
    if nk not in GROUP_DISTANCES:
        raise ValueError(f"the bitonic kernels take 1 or 2 key planes, got {nk}")
    tile = min(tile, npad)
    logt, logn = tile.bit_length() - 1, npad.bit_length() - 1
    if not ROUND_BITS <= logt <= MAX_TILE.bit_length() - 1:
        raise ValueError(f"tile must lie in [{1 << ROUND_BITS}, {MAX_TILE}], got {tile}")
    first = [(s, b) for s in range(1, logt + 1) for b in range(s - 1, -1, -1)]
    launches = [BlockPass(True, block_rounds(first))]
    for level in range(logt + 1, logn + 1):
        top = level - 1
        while top >= logt:
            r = min(GROUP_DISTANCES[nk], top - logt + 1)
            launches.append(GlobalGroup(level, top, r))
            top -= r
        stages = [(level, b) for b in range(logt - 1, -1, -1)]
        launches.append(BlockPass(False, block_rounds(stages)))
    return tuple(launches)


def plan_stages(launches: tuple) -> list:
    """The ``(size log2, distance log2)`` stages a plan runs, in order."""
    out = []
    for x in launches:
        if isinstance(x, GlobalGroup):
            out += [(x.level, b) for b in range(x.top, x.top - x.r, -1)]
        else:
            out += [(s, b) for _, s, b in x.stages]
    return out


def plan_counts(launches: tuple, npayloads: int) -> dict:
    """Launches of each kernel that ``launches`` and ``npayloads`` gathers
    make, keyed as :func:`launch_counts`."""
    return {"block": sum(isinstance(x, BlockPass) for x in launches),
            "global": sum(isinstance(x, GlobalGroup) for x in launches),
            "gather": npayloads}


def block_tile(nk: int, device: torch.device) -> int:
    """The engine's in-block tile, from the sweep of 8192 against 16384 on
    the H100 (PERF.md): with one key plane the largest tile whose key and
    position planes fit one block's shared memory (16384 on an H100, one
    block per SM), which takes one global distance off every level; with two
    key planes the largest tile whose key and position planes fit one SM's
    shared memory twice over (8192): a two-plane tile of 16384 fills 192 KB,
    and at the two-plane contract shape (838,860 elements, 2^20 padded) it
    makes 64 blocks for the H100's 132 SMs."""
    optin, per_sm = merge.smem_limits(device)
    if nk == 2:
        optin = per_sm // 2 - merge.SMEM_RESERVED_PER_BLOCK
    return min(MAX_TILE, 1 << ((optin // (4 * (nk + 1))).bit_length() - 1))


def thread_bit_positions(top: int, logt: int) -> list:
    """Bits of the in-tile index that a thread's id fills, low bit first, in
    a round whose window is bits ``top - ROUND_BITS + 1`` to ``top``: first
    the five lane bits, for each residue mod 5 the lowest bit outside the
    window (under :func:`swizzle` the 32 lanes then hit 32 distinct banks),
    then the other bits outside the window, ascending. Mirrors
    ``thread_base`` in ``csrc/bitonic.cu``."""
    free = [p for p in range(logt) if not top - ROUND_BITS < p <= top]
    lanes = []
    for c in range(5):
        p = next((p for p in free if p % 5 == c), None)
        if p is not None:
            lanes.append(p)
    return lanes + [p for p in free if p not in lanes]


def swizzle(i):
    """Shared-memory slot of in-tile index ``i`` (an int or a tensor): bits
    5-14 folded onto the bank bits 0-4, so bit ``p`` moves the bank by bit
    ``p % 5``. Mirrors ``swizzle`` in ``csrc/bitonic.cu``."""
    return i ^ (((i >> 5) ^ (i >> 10)) & 31)


# ---------------------------------------------------------------------------
# the schedule in plain torch, with the kernels' index maps


def _exchange(regs: list, a: int, b: int, ascending: torch.Tensor) -> None:
    """Compare-exchange of register columns ``a < b`` over the planes (keys,
    then position), in place: ``a`` ends first when ``ascending``."""
    lt, gt = _lex_lt_gt([p[..., a] for p in regs], [p[..., b] for p in regs])
    swap = torch.where(ascending, gt, lt)
    for p in regs:
        x, y = p[..., a].clone(), p[..., b].clone()
        p[..., a] = torch.where(swap, y, x)
        p[..., b] = torch.where(swap, x, y)


def _global_group_plain(planes: list, g: GlobalGroup) -> None:
    """``bitonic_group_kernel``: each group of ``2^r`` elements that differ
    only in the group's distance bits, loaded, run through its ``r``
    stages and stored back."""
    npad = planes[0].shape[0]
    lo = g.top - g.r + 1
    grp = torch.arange(npad >> g.r, device=planes[0].device)
    low = grp & ((1 << lo) - 1)
    base = ((grp - low) << g.r) | low
    idx = base[:, None] + (torch.arange(1 << g.r, device=grp.device) << lo)[None, :]
    regs = [p[idx] for p in planes]
    ascending = ((base >> g.level) & 1) == 0
    for bit in range(g.r - 1, -1, -1):
        for m in range(1 << g.r):
            if not m >> bit & 1:
                _exchange(regs, m, m | 1 << bit, ascending)
    for p, r in zip(planes, regs):
        p[idx] = r


def _block_pass_plain(planes: list, bp: BlockPass, tile: int) -> None:
    """``bitonic_block_kernel`` on every tile at once: the tile into
    swizzled shared memory, each round's thread groups into registers, the
    round's stages, back to shared memory, and the tile out."""
    npad = planes[0].shape[0]
    dev = planes[0].device
    logt = tile.bit_length() - 1
    slots = swizzle(torch.arange(tile, device=dev))
    gbase = (torch.arange(npad // tile, device=dev) * tile)[:, None, None]
    smem = []
    for p in planes:
        s = torch.empty((npad // tile, tile), dtype=p.dtype, device=dev)
        s[:, slots] = p.view(-1, tile)
        smem.append(s)
    t = torch.arange(tile >> ROUND_BITS, device=dev)
    for top, stages in itertools.groupby(bp.stages, key=lambda st: st[0]):
        lo = top - ROUND_BITS + 1
        base = torch.zeros_like(t)
        for k, p in enumerate(thread_bit_positions(top, logt)):
            base |= ((t >> k) & 1) << p
        idx = base[:, None] | (torch.arange(1 << ROUND_BITS, device=dev) << lo)[None, :]
        addr = swizzle(idx)
        regs = [s[:, addr] for s in smem]
        gidx = gbase | idx[None]
        for _, size_log, b in stages:
            ascending = ((gidx >> size_log) & 1) == 0
            for m in range(1 << ROUND_BITS):
                if not m >> (b - lo) & 1:
                    _exchange(regs, m, m | 1 << (b - lo), ascending[..., m])
        for s, r in zip(smem, regs):
            s[:, addr] = r
    for p, s in zip(planes, smem):
        p.view(-1, tile)[:] = s[:, slots]


def scheduled_sort_plain(keys: torch.Tensor, values: tuple = (), tile: int = 64):
    """The kernels' schedule in plain torch: the padded key planes and the
    position plane (the kernels always carry it) through :func:`plan` with
    tiles of ``tile``, each launch as its kernel moves the elements
    (groups, rounds, thread bits, swizzle). Returns
    ``(sorted_keys, sorted_values_tuple)``, the stable order."""
    _check_input(keys, values)
    n = keys.shape[0]
    npad = _padded_size(n)
    planes = []
    for p in _split_planes(keys):
        padded = torch.full((npad,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                            device=keys.device)
        padded[:n] = p
        planes.append(padded)
    planes.append(torch.arange(npad, dtype=torch.int32, device=keys.device))
    for launch in plan(npad, tile, len(planes) - 1):
        if isinstance(launch, GlobalGroup):
            _global_group_plain(planes, launch)
        else:
            _block_pass_plain(planes, launch, min(tile, npad))
    out_k = _join_planes([p[:n] for p in planes[:-1]], keys.dtype)
    pos = planes[-1][:n].to(torch.int64)
    return out_k, tuple(bits_view(v)[pos].view(v.dtype) for v in values)


# ---------------------------------------------------------------------------
# the kernel wrappers (csrc/bitonic.cu)


def block_pass(in_planes: list, work: torch.Tensor, n: int, tile: int, bp: BlockPass) -> None:
    """One in-block launch on the ``(nk + 1, npad)`` int32 work buffer (key
    planes, then positions), running the stages of ``bp``. The first pass
    pads every tile of the 1-D int32 key planes ``in_planes`` (``n``
    elements) into ``work``; a later one works on ``work`` in place."""
    nk, npad = work.shape[0] - 1, work.shape[1]
    if len(bp.stages) > MAX_BLOCK_STAGES:
        raise ValueError(f"an in-block launch takes at most {MAX_BLOCK_STAGES} stages")
    ptrs = [p.data_ptr() for p in in_planes] + [0] * (2 - len(in_planes))
    kernels.call("bitonic_block", work.device, ptrs[0], ptrs[1], work.data_ptr(), nk,
                 n, npad, tile, int(bp.first), _packed(bp.stages), len(bp.stages))
    profiling.count("launch.block_pass")


@functools.lru_cache(maxsize=256)
def _packed(stages: tuple):
    """``stages`` as the kernel takes them, a C array of
    ``window top << 10 | size log2 << 5 | distance log2``; never written."""
    return (ctypes.c_int * len(stages))(*(top << 10 | s << 5 | b for top, s, b in stages))


def global_group(work: torch.Tensor, g: GlobalGroup) -> None:
    """The ``r`` stages of ``g`` over the whole work buffer in device memory,
    in one launch."""
    nk, npad = work.shape[0] - 1, work.shape[1]
    kernels.call("bitonic_group", work.device, work.data_ptr(), nk, npad, g.level, g.top, g.r)
    profiling.count("launch.global_group")


def gather_payload(v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``v[pos[i]]`` for the first ``len(v)`` final positions."""
    out = torch.empty_like(v)
    kernels.call("bitonic_gather", v.device, v.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 v.shape[0], v.element_size())
    profiling.count("launch.gather_payload")
    return out


def bitonic_sort_block(keys: torch.Tensor, values: tuple = (), stable: bool = False):
    """Sort 1-D 4/8-byte integer keys (padded to a power of two >= 1024 with
    dtype-max sentinels) through one bitonic network; returns
    ``(sorted_keys, sorted_values_tuple)``.

    ``keys``' natural order is the sort order. With ``values`` (4- or 8-byte
    each, any number) the sort is stable (``stable`` is implied): the
    position is the last compare plane, so a real maximum key keeps its
    payload and never trades it with the padding. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels or raises.
    """
    if values:
        stable = True
    _check_input(keys, values)
    if keys.device.type == "cpu":
        return bitonic_sort_block_plain(keys, values, stable)
    if keys.device.type != "cuda":
        raise ValueError(f"the bitonic kernels run on CUDA tensors, got {keys.device}")
    n = keys.shape[0]
    if n == 0:
        return keys.clone(), tuple(v.clone() for v in values)
    key_planes = [p.contiguous() for p in _split_planes(keys)]
    work, out_v = network(key_planes, [bits_view(v).contiguous() for v in values])
    out_k = _join_planes([work[i, :n] for i in range(len(key_planes))], keys.dtype)
    return out_k, tuple(o.view(v.dtype) for o, v in zip(out_v, values))


def network(key_planes: list, values: list, tile: int | None = None):
    """The kernels on the schedule :func:`plan` builds, on 1-D contiguous
    CUDA int32 key planes of n elements (most significant first) and
    contiguous 4/8-byte payloads: returns the ``(nk + 1, npad)`` work
    buffer, sorted on (key planes, position), and the payloads moved by the
    final positions. ``tile``: the in-block tile (default
    :func:`block_tile`; the result does not depend on it)."""
    nk, n = len(key_planes), key_planes[0].shape[0]
    if nk not in (1, 2):
        raise ValueError(f"the bitonic kernels take 1 or 2 key planes, got {nk}")
    dev = key_planes[0].device
    for t in (*key_planes, *values):
        if t.device != dev or t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError("key planes and payloads must be contiguous 1-D tensors of one "
                             "length on one device")
    if dev.type != "cuda" or any(p.dtype != torch.int32 for p in key_planes):
        raise ValueError(f"the bitonic kernels take int32 key planes on a CUDA device, got "
                         f"{[p.dtype for p in key_planes]} on {dev}")
    if n == 0 or n >= 1 << 31:
        raise ValueError(f"the bitonic kernels take 0 < n < 2^31, got {n}")
    npad = _padded_size(n)
    tile = min(tile or block_tile(nk, dev), npad)
    work = torch.empty((nk + 1, npad), dtype=torch.int32, device=dev)
    for launch in plan(npad, tile, nk):
        if isinstance(launch, GlobalGroup):
            global_group(work, launch)
        else:
            block_pass(key_planes if launch.first else [], work, n, tile, launch)
    return work, [gather_payload(v, work[nk]) for v in values]


def launch_counts() -> dict:
    """The launch counters of the three bitonic kernels."""
    c = profiling.COUNTERS
    return {"block": c.get("launch.block_pass", 0), "global": c.get("launch.global_group", 0),
            "gather": c.get("launch.gather_payload", 0)}
