"""Bitonic engine: the whole padded array through one bitonic network.

Port of ``vkradixsort_tpu/ops/bitonic.py``. Keys are compared as a
lexicographic tuple of int32 planes: 4-byte keys are one plane, 8-byte keys
two order-isomorphic planes (hi, lo) (:func:`_split_planes`). The array is
padded to a power of two >= 1024 with the key dtype's maximum, which is
INT32_MAX in every plane. With payloads the sort is stable: the padded
position is the last compare plane, so ties resolve to input order and a
real maximum key keeps its payload.

On a CUDA tensor :func:`bitonic_sort_block` runs the kernels of
``csrc/bitonic.cu``. A block cannot wait for another inside a launch, so the
network runs as the standard global bitonic sort, on the key planes and the
position plane in device memory:

  1. ``block_pass`` with ``level = 0``: each tile of ``tile`` elements (from
     ``ops/merge.default_tile``) is padded and sorted in one block's shared
     memory by the network up to size ``tile``, directions from the global
     index;
  2. for every level ``k > tile``: one ``global_stage`` launch per distance
     ``j >= tile`` (each thread compares and exchanges the pair
     ``(i, i ^ j)``), then one ``block_pass`` with ``level = k`` that runs
     the stages ``j < tile`` in shared memory;
  3. ``gather_payload``: one launch per payload moves it by the final
     position.

Every network sorts a total order to the same result, so the answer is the
JAX kernel's bitwise. On a CPU tensor the plain version
:func:`bitonic_sort_block_plain` runs the JAX kernel's network as vectorised
torch, stage by stage in order.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops import kernels, merge
from vkradixsort_tpu_torch.ops.common import _MIN32, bits_view

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
# the kernel wrappers (csrc/bitonic.cu)


def block_pass(in_planes: list, work: torch.Tensor, n: int, tile: int, level: int) -> None:
    """One in-block launch on the ``(nk + 1, npad)`` int32 work buffer (key
    planes, then positions). ``level == 0``: pad and sort every tile of the
    1-D int32 key planes ``in_planes`` (``n`` elements) into ``work``;
    ``level > tile``: run the stages ``j < tile`` of level ``level`` on
    ``work`` in place."""
    nk, npad = work.shape[0] - 1, work.shape[1]
    ptrs = [p.data_ptr() for p in in_planes] + [0] * (2 - len(in_planes))
    kernels.call("bitonic_block", work.device, ptrs[0], ptrs[1], work.data_ptr(), nk,
                 n, npad, tile, level)
    block_pass.launches += 1


block_pass.launches = 0


def global_stage(work: torch.Tensor, k: int, j: int) -> None:
    """One compare-exchange stage at distance ``j`` of level ``k`` over the
    whole work buffer in device memory."""
    nk, npad = work.shape[0] - 1, work.shape[1]
    kernels.call("bitonic_global", work.device, work.data_ptr(), nk, npad, k, j)
    global_stage.launches += 1


global_stage.launches = 0


def gather_payload(v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``v[pos[i]]`` for the first ``len(v)`` final positions."""
    out = torch.empty_like(v)
    kernels.call("bitonic_gather", v.device, v.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 v.shape[0], v.element_size())
    gather_payload.launches += 1
    return out


gather_payload.launches = 0


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


def network(key_planes: list, values: list):
    """The kernels' schedule on 1-D contiguous CUDA int32 key planes of n
    elements (most significant first) and contiguous 4/8-byte payloads:
    returns the ``(nk + 1, npad)`` work buffer, sorted on (key planes,
    position), and the payloads moved by the final positions."""
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
    tile = min(merge.default_tile(nk, dev), npad)
    work = torch.empty((nk + 1, npad), dtype=torch.int32, device=dev)
    block_pass(key_planes, work, n, tile, 0)
    k = 2 * tile
    while k <= npad:
        j = k // 2
        while j >= tile:
            global_stage(work, k, j)
            j //= 2
        block_pass([], work, n, tile, k)
        k *= 2
    return work, [gather_payload(v, work[nk]) for v in values]


def launch_counts() -> dict:
    """The launch counters of the three bitonic kernels."""
    return {"block": block_pass.launches, "global": global_stage.launches,
            "gather": gather_payload.launches}


def reset_launch_counts() -> None:
    block_pass.launches = global_stage.launches = gather_payload.launches = 0

