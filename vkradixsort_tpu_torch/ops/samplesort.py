"""Single-device sample sort: the structural large-N pipeline.

Port of ``vkradixsort_tpu/ops/samplesort.py``:

  1. tile the (padded) array into G rows of C elements and sort every row
     (one batched ``torch.sort`` along the rows, where JAX ran a
     ``lax.scan`` of flat sorts);
  2. sample B-1 splitters from the sorted rows (regular quantile positions,
     an oversampled global sample);
  3. per (row, bucket): run boundaries by batched ``searchsorted``, with
     boundaries inside equal-key runs balanced toward the even spread
     (``_bucket_starts``);
  4. ``place_runs`` copies every (row, bucket) run into its static slot of
     the (B, G, cap) bucket matrix and fills the rest of the slot (kernel
     ``csrc/placement.cu``). The GPU needs no 1024-element alignment, so a
     slot's valid window is its first ``len`` elements;
  5. every bucket is sorted (one batched ``torch.sort`` over the B rows of
     G * cap slots, fills sinking to the tail) and the valid prefixes are
     compacted in bucket order.

Bucket overflow (a run longer than ``cap``) is checked on the host
(``bool(overflow)``: one device-to-host sync per call, where JAX had a
``lax.cond``), and the whole sort then falls back to one flat library sort,
so the result is always exact.

The keys-only path relies on duplicate keys being interchangeable; the
key-value path (:func:`sort_pairs_samplesort`) carries each element's
original position ``gidx`` as a second sort key, which makes every element
distinct and the result stable. Requires padded size < 2^31 (int32 gidx and
offsets). ``place_runs`` takes its plain version ``place_runs_plain`` only for
CPU tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops import kernels, segsort
from vkradixsort_tpu_torch.ops.common import (
    bits_view,
    cdiv,
    composite_searchsorted,
    pad_sentinel,
    pad_to,
    round_up,
    signed_bits,
)
from vkradixsort_tpu_torch.utils import profiling

LANES = 128
_GMAX = (1 << 31) - 1  # gidx of padding and fill: after every real position


# ---------------------------------------------------------------------------
# run placement (csrc/placement.cu)


def _check_placement(rows: list, starts: torch.Tensor, lens: torch.Tensor, cap: int,
                     fills: list) -> None:
    if len(rows) not in (1, 3) or len(fills) != len(rows):
        raise ValueError("place_runs moves keys, or keys, positions and values, with one fill each")
    G, C = rows[0].shape
    for r in rows:
        if r.dim() != 2 or tuple(r.shape) != (G, C) or r.element_size() not in (4, 8):
            raise ValueError("rows must be (G, C) tensors of 4- or 8-byte elements")
        if r.device != rows[0].device:
            raise ValueError("rows must lie on one device")
    if len(rows) == 3 and rows[1].dtype != torch.int32:
        raise ValueError("the positions plane must be int32")
    for t in (starts, lens):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != G or t.device != rows[0].device:
            raise ValueError("starts and lens must be (G, B) int32 on the rows' device")
    if not 0 < cap <= C:
        raise ValueError(f"cap must be in (0, C], got {cap} for C = {C}")


def place_runs_plain(rows: list, starts: torch.Tensor, lens: torch.Tensor, cap: int,
                     fills: list) -> list:
    """Plain version of the placement kernel: a gather of every plane from
    the index ``g * C + start[g, b] + j``, then the fill outside the valid
    window ``j < len[g, b]``."""
    G, C = rows[0].shape
    j = torch.arange(cap, device=starts.device)
    src = starts.T[:, :, None].to(torch.int64) + j  # (B, G, cap)
    valid = j < lens.T[:, :, None]
    flat = (torch.arange(G, device=src.device)[None, :, None] * C + src.clamp(max=C - 1))
    outs = []
    for r, fill in zip(rows, fills):
        b = bits_view(r).reshape(-1)[flat]
        fill_b = signed_bits(fill, r.element_size())
        outs.append(torch.where(valid, b, fill_b).contiguous().view(r.dtype))
    return outs


def place_runs(rows: list, starts: torch.Tensor, lens: torch.Tensor, cap: int,
               fills: list) -> list:
    """Slot matrices of the sample sort: for each (G, C) row plane (keys, or
    keys, int32 positions and values), a (B, G, cap) tensor whose slot
    (b, g) holds row g's run ``[starts[g, b], starts[g, b] + lens[g, b])``
    followed by the plane's fill (a value of the plane's dtype, given as a
    Python int bit pattern or value). Every run must lie inside its row and
    be at most ``cap`` long."""
    _check_placement(rows, starts, lens, cap, fills)
    if rows[0].device.type == "cpu":
        return place_runs_plain(rows, starts, lens, cap, fills)
    if rows[0].device.type != "cuda":
        raise ValueError(f"the placement kernel runs on CUDA tensors, got {rows[0].device}")
    G, C = rows[0].shape
    B = starts.shape[1]
    if not all(t.is_contiguous() for t in (*rows, starts, lens)):
        raise ValueError("the placement kernel takes contiguous rows, starts and lens")
    outs = [torch.empty((B, G, cap), dtype=r.dtype, device=r.device) for r in rows]
    kernels.call("placement", rows[0].device, kernels.pointers(rows), kernels.pointers(outs),
                 kernels.u64s(fills), len(rows), rows[0].element_size(),
                 rows[-1].element_size() if len(rows) == 3 else 0,
                 starts.data_ptr(), lens.data_ptr(), G, C, B, cap)
    profiling.count("launch.place_runs")
    return outs


# ---------------------------------------------------------------------------
# splitters and run boundaries


def _sort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Sort every row of encoded keys (one batched library sort)."""
    s, _ = torch.sort(segsort.to_signed_order(rows), dim=1)
    return segsort.from_signed_order(s, rows.dtype)


def _splitters(rows_sorted: torch.Tensor, B: int, oversample: int) -> torch.Tensor:
    """B-1 global splitters from per-row regular quantile samples."""
    G, C = rows_sorted.shape
    num_s = oversample * B
    pos = (torch.arange(num_s, device=rows_sorted.device) * C) // num_s + C // (2 * num_s)
    samples = segsort.to_signed_order(rows_sorted)[:, pos].reshape(-1)
    samples, _ = torch.sort(samples)
    step = samples.shape[0] // B
    return segsort.from_signed_order(samples[step::step][: B - 1], rows_sorted.dtype)


def _bucket_starts(rows_sorted: torch.Tensor, splitters: torch.Tensor, cap: int):
    """Per-(row, bucket) run starts, balanced inside equal-key runs.

    For each splitter the legal boundary in a sorted row is anywhere in
    [searchsorted left, searchsorted right] (duplicates are
    interchangeable); the boundary is pulled toward the even-spread target
    b*C/B within that range, which keeps constant and heavily skewed rows
    balanced. Returns (starts (G, B) int32, lens (G, B) int32, overflow
    bool tensor): overflow flags a run longer than ``cap``."""
    G, C = rows_sorted.shape
    B = splitters.shape[0] + 1
    rows_s = segsort.to_signed_order(rows_sorted)
    q = segsort.to_signed_order(splitters).expand(G, B - 1).contiguous()
    lo = torch.searchsorted(rows_s, q).to(torch.int32)
    hi = torch.searchsorted(rows_s, q, right=True).to(torch.int32)
    target = ((torch.arange(1, B, dtype=torch.int32, device=lo.device) * C) // B).expand(G, B - 1)
    bounds = torch.minimum(torch.maximum(target, lo), hi)
    return _runs(bounds, C, cap)


def _runs(bounds: torch.Tensor, C: int, cap: int):
    """(starts, lens, overflow) of the B runs of each row cut at the (G, B-1)
    ``bounds``."""
    G = bounds.shape[0]
    zeros = torch.zeros((G, 1), dtype=torch.int32, device=bounds.device)
    starts = torch.cat([zeros, bounds], dim=1)
    ends = torch.cat([bounds, torch.full_like(zeros, C)], dim=1)
    lens = ends - starts
    return starts, lens, (lens > cap).any()


def _pick_geometry(n: int, tile_target: int, bucket_target: int, slack: float):
    """Static (G, C, B, cap) for a given input size."""
    G = max(cdiv(n, tile_target), 1)
    C = round_up(cdiv(n, G), LANES)
    B = min(max(cdiv(G * C, bucket_target), 8), 128)
    cap = round_up(int(slack * C / B) + LANES, LANES)
    cap = min(cap, C)
    return G, C, B, cap


def _check_size(npad: int) -> None:
    if npad >= 1 << 31:
        raise NotImplementedError("samplesort needs padded size < 2^31 (int32 offsets)")


def _valid_prefix(sorted_slots: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The first ``L[b]`` elements of every bucket row, concatenated in
    bucket order; ``L[b]`` is the sum of bucket b's run lengths."""
    L = lens.sum(dim=0)
    j = torch.arange(sorted_slots.shape[1], device=sorted_slots.device)
    return sorted_slots[j < L[:, None]]


# ---------------------------------------------------------------------------
# the pipelines


def sort_samplesort(
    enc: torch.Tensor,
    *,
    tile_target: int = 1 << 19,
    bucket_target: int = 1 << 19,
    oversample: int = 32,
    slack: float = 1.35,
) -> torch.Tensor:
    """Sort encoded (uint32/uint64) keys; returns sorted keys of the same
    length. Keys only (duplicates interchangeable); key-value pairs go
    through :func:`sort_pairs_samplesort`.

    ``tile_target``/``bucket_target`` are the grain knob. The defaults are
    the JAX package's, measured on a TPU v5e, not on the H100."""
    n = enc.shape[0]
    if n == 0:
        return enc
    G, C, B, cap = _pick_geometry(n, tile_target, bucket_target, slack)
    npad = G * C
    _check_size(npad)
    # Rows by strided interleave (element i -> row i % G), as in the
    # key-value path: the npad - n sentinel pads spread over all rows.
    # Contiguous rows (the JAX layout) put every pad in the last row's last
    # bucket, which overflows whenever the pads outnumber about cap - C / B
    # (at 1e8 with the default grain, 16,768 pads against a cap of 5,760),
    # so every such sort took the flat fallback.
    rows_sorted = _sort_rows(pad_to(enc, npad).reshape(C, G).T.contiguous())
    splitters = _splitters(rows_sorted, B, oversample)
    starts, lens, overflow = _bucket_starts(rows_sorted, splitters, cap)
    if bool(overflow):
        return segsort.sort_flat(enc)
    slots = place_runs([rows_sorted], starts, lens, cap, [pad_sentinel(enc.dtype)])
    out_k, _ = _sort_buckets(slots, lens, n)
    return segsort.from_signed_order(out_k, enc.dtype)


def _sort_buckets(slots: list, lens: torch.Tensor, n: int):
    """Step 5: sort every bucket (slot planes viewed as B rows of G * cap;
    by key, or with positions and values by (key, gidx)) and compact the
    valid prefixes. Returns the first n sorted keys in signed order and,
    with values, the values' bits alongside (else None)."""
    B = slots[0].shape[0]
    s = segsort.to_signed_order(slots[0].view(B, -1))
    if len(slots) == 1:
        s, _ = torch.sort(s, dim=1)
        return _valid_prefix(s, lens)[:n], None
    order = _lex_order(s, slots[1].view(B, -1))
    return (_valid_prefix(torch.gather(s, 1, order), lens)[:n],
            _valid_prefix(torch.gather(slots[2].view(B, -1), 1, order), lens)[:n])


def _lex_order(k_s: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Indices that sort along the last dimension by (k_s, g)
    lexicographically; ``k_s`` signed-order keys, ``g`` int32. Keys of 4
    bytes pack with ``g`` into one int64 key; 8-byte keys take two stable
    passes, ``g`` first."""
    if k_s.element_size() == 4:
        packed = (k_s.to(torch.int64) << 32) | (g.to(torch.int64) + (1 << 31))
        return torch.sort(packed, dim=-1).indices
    by_g = torch.sort(g, dim=-1, stable=True).indices
    by_k = torch.sort(torch.gather(k_s, -1, by_g), dim=-1, stable=True).indices
    return torch.gather(by_g, -1, by_k)


def _pair_runs(enc: torch.Tensor, values: torch.Tensor, G: int, C: int, B: int, cap: int,
               oversample: int):
    """Steps 1-3 of the key-value pipeline: the interleaved (G, C) rows of
    keys, gidx and value bits sorted by (key, gidx), and the (G, B) starts
    and lengths of their runs, with the overflow flag: the inputs of
    ``place_runs``."""
    n = enc.shape[0]
    npad = G * C
    _check_size(npad)
    dev = enc.device

    def interleave(flat):
        # element i -> (row i % G, col i // G); the padded tail spreads too
        return flat.reshape(C, G).T.contiguous()

    gidx = torch.full((npad,), _GMAX, dtype=torch.int32, device=dev)
    gidx[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    vals_p = torch.zeros(npad, dtype=bits_view(values).dtype, device=dev)
    vals_p[:n] = bits_view(values)
    s, perm = torch.sort(segsort.to_signed_order(interleave(pad_to(enc, npad))), dim=1,
                         stable=True)
    k_rows = segsort.from_signed_order(s, enc.dtype)
    g_rows = torch.gather(interleave(gidx), 1, perm)
    v_rows = torch.gather(interleave(vals_p), 1, perm)
    del perm, vals_p, gidx

    # composite splitters from regular quantile samples
    num_s = oversample * B
    pos = (torch.arange(num_s, device=dev) * C) // num_s + C // (2 * num_s)
    sk = s[:, pos].reshape(-1)
    sg = g_rows[:, pos].reshape(-1)
    order = _lex_order(sk, sg)
    step = sk.shape[0] // B
    spl_k = segsort.from_signed_order(sk[order][step::step][: B - 1], enc.dtype)
    spl_g = sg[order][step::step][: B - 1]
    del s

    bounds = composite_searchsorted(k_rows, g_rows, spl_k, spl_g)  # (G, B-1)
    return (k_rows, g_rows, v_rows) + _runs(bounds, C, cap)


def sort_pairs_samplesort(
    enc: torch.Tensor,
    values: torch.Tensor,
    *,
    tile_target: int = 1 << 21,
    bucket_target: int = 1 << 21,
    oversample: int = 32,
    slack: float = 1.35,
    _debug_overflow: bool = False,
):
    """Stable key-value sample sort of encoded (uint32/uint64) keys with one
    4- or 8-byte payload; returns ``(sorted_keys, sorted_values)``.

    Every element carries its original position ``gidx`` (int32):

      * rows sort by (key, gidx); rows are filled by STRIDED interleave
        (element i -> row i % G), so gidx already rises along each row and a
        stable sort by key alone gives that order, and every row holds an
        even share of each tie run (a heavily repeated key would otherwise
        fill whole rows and overflow any bucket cap);
      * composite (key, gidx) splitters cut each row exactly
        (``composite_searchsorted``); no equal-run balancing is needed;
      * placement moves keys, gidx and values with the same runs, filling
        keys with the sentinel and gidx with INT32_MAX, so fill sorts after
        every real pair even where real keys equal the sentinel;
      * buckets sort by (key, gidx); the valid prefixes are exact.

    ``_debug_overflow=True`` appends whether the flat fallback ran (a test
    hook). The defaults are the JAX package's, measured on a TPU v5e, not
    on the H100.
    """
    n = enc.shape[0]
    if n == 0:
        return (enc, values, False) if _debug_overflow else (enc, values)
    if values.element_size() < 4:
        raise TypeError(
            f"samplesort values must be 4- or 8-byte typed, got {values.dtype}; "
            "widen the payload (e.g. to float32/int32)"
        )
    G, C, B, cap = _pick_geometry(n, tile_target, bucket_target, slack)
    k_rows, g_rows, v_rows, starts, lens, overflow = _pair_runs(enc, values, G, C, B, cap,
                                                                oversample)
    overflow = bool(overflow)
    if overflow:
        out_k, (out_v,) = segsort.sort_flat_pairs(enc, (values,))
        return (out_k, out_v, True) if _debug_overflow else (out_k, out_v)

    slots = place_runs([k_rows, g_rows, v_rows], starts, lens, cap,
                       [pad_sentinel(enc.dtype), _GMAX, 0])
    del k_rows, g_rows, v_rows
    out_k, out_v = _sort_buckets(slots, lens, n)
    out = (segsort.from_signed_order(out_k, enc.dtype), out_v.view(values.dtype))
    return out + (False,) if _debug_overflow else out
