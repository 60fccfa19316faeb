"""Plain LSD radix sort: the radix engines' oracle and ``backend="reference"``.

Port of ``vkradixsort_tpu/ops/reference.py``. The sort is decomposed into
the three phases the radix kernels run, so each phase is a plain version
the kernels are held against:

  chunk_histograms       per-chunk 256-bin counts of one digit
  exclusive_bin_offsets  global scan: where each chunk's run of each digit starts
  rank_in_chunk          stable rank of each element among equal digits of its chunk
  radix_pass             the three, then a scatter to ``base + rank``

Every phase works on int32/int64 views (torch has no unsigned shifts or
indexing on the card) and in bounded memory: the counts are one
``bincount`` and the rank comes from a stable sort of each chunk, never a
``[chunks, chunk, 256]`` one-hot, so the plain versions also run at the
main path's 1e8 elements on the card.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops.common import (
    BITS_PER_PASS,
    NUM_BINS,
    bits_view,
    cdiv,
    decode_keys,
    encode_keys,
    extract_digit,
    num_passes,
    positions,
    take,
)


def digit_counts(digits: torch.Tensor, chunk: int) -> torch.Tensor:
    """``[cdiv(n, chunk), 256]`` int32 counts of each digit (int32 in
    [0, 256)) in every run of ``chunk`` consecutive elements; the last run
    may be short."""
    n = digits.shape[0]
    rows = cdiv(n, chunk)
    chunk_id = torch.arange(n, device=digits.device) // chunk
    flat = torch.bincount(chunk_id * NUM_BINS + digits, minlength=rows * NUM_BINS)
    return flat.view(rows, NUM_BINS).to(torch.int32)


def chunk_histograms(keys: torch.Tensor, shift: int, num_chunks: int) -> torch.Tensor:
    """Per-chunk 256-bin histograms of digit ``(key >> shift) & 0xFF``:
    ``[num_chunks, 256]`` int32, chunk-major. ``num_chunks`` divides n."""
    n = keys.shape[0]
    if num_chunks < 1 or n % num_chunks:
        raise ValueError(f"num_chunks={num_chunks} does not divide n={n}")
    return digit_counts(extract_digit(keys, shift), n // num_chunks)


def exclusive_bin_offsets(hist: torch.Tensor) -> torch.Tensor:
    """Global digit offsets per chunk, ``[num_chunks, 256]`` int32, in
    bin-major order: offset[c, b] = (count of all digits < b) + (count of
    digit b in chunks < c). The scan runs in int32: its outputs are below
    n, and the radix engines take n < 2^31 (an int32 sum that passes 2^31
    on the last element wraps, and the exclusive offsets stay exact)."""
    flat = hist.t().reshape(-1)  # [b * num_chunks + c]
    scanned = torch.cumsum(flat, 0, dtype=torch.int32) - flat
    return scanned.view(hist.shape[1], hist.shape[0]).t().contiguous()


def rank_in_chunk(digits: torch.Tensor) -> torch.Tensor:
    """Stable intra-chunk rank: the number of earlier elements of the same
    row with the same digit. ``digits``: ``[num_chunks, chunk]`` int32;
    returns the same shape. An element's place in its row's stable sorted
    order, less the place where its digit's run begins there."""
    rows, chunk = digits.shape
    sorted_d, order = torch.sort(digits, dim=1, stable=True)
    run_start = torch.searchsorted(sorted_d, sorted_d)
    place = torch.arange(chunk, device=digits.device).expand(rows, chunk)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, place - run_start)
    return rank.to(torch.int32)


def scatter(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """``out[dest[i]] = x[i]`` for a permutation ``dest`` (int64), any dtype."""
    out = torch.empty_like(x)
    bits_view(out)[dest] = bits_view(x)
    return out


def radix_pass(keys: torch.Tensor, values, shift: int, num_chunks: int = 1):
    """One stable 8-bit LSD pass: returns the reordered ``(keys, values)``
    (``values`` may be None)."""
    n = keys.shape[0]
    digits = extract_digit(keys, shift)
    base = exclusive_bin_offsets(chunk_histograms(keys, shift, num_chunks))
    rank = rank_in_chunk(digits.view(num_chunks, n // num_chunks)).view(-1)
    chunk_id = torch.arange(n, device=keys.device) // (n // num_chunks)
    dest = base.view(-1)[chunk_id * NUM_BINS + digits].to(torch.int64) + rank
    return scatter(keys, dest), None if values is None else scatter(values, dest)


def radix_sort_encoded(keys: torch.Tensor, values, num_chunks: int = 1):
    """Every LSD pass over encoded (uint32/uint64) keys, carrying one
    payload or None."""
    if keys.shape[0] == 0:
        return keys.clone(), None if values is None else values.clone()
    for p in range(num_passes(keys.dtype)):
        keys, values = radix_pass(keys, values, p * BITS_PER_PASS, num_chunks)
    return keys, values


def sort_encoded(enc: torch.Tensor, vals: tuple, config=None):
    """``backend="reference"``: one payload or none rides the LSD passes; a
    set rides as positions, then is gathered. ``(sorted_keys, vals_tuple)``."""
    if len(vals) <= 1:
        out_k, out_v = radix_sort_encoded(enc, vals[0] if vals else None)
        return out_k, (out_v,) if vals else ()
    out_k, perm = radix_sort_encoded(enc, torch.arange(enc.shape[0], device=enc.device))
    return out_k, tuple(take(v, perm) for v in vals)


def radix_sort_reference(keys: torch.Tensor, values=None, num_chunks: int = 1):
    """Full stable LSD radix sort of ``keys`` (any key dtype), carrying
    ``values``: the sorted keys, or ``(keys, values)`` when values are given."""
    out_keys, out_values = radix_sort_encoded(encode_keys(keys), values, num_chunks)
    out_keys = decode_keys(out_keys, keys.dtype)
    if values is None:
        return out_keys
    return out_keys, out_values


def argsort_reference(keys: torch.Tensor, num_chunks: int = 1) -> torch.Tensor:
    """Stable argsort from the same radix passes (uint32 indices below 2^32)."""
    _, perm = radix_sort_reference(keys, positions(keys.shape[0], keys.device), num_chunks)
    return perm
