"""Sort primitives on the library sort, in sign-flipped int space.

Port of ``vkradixsort_tpu/ops/segsort.py``. Encoded (unsigned) keys move into
order-isomorphic int32/int64 space, where ``torch.sort`` is implemented on
every device; payloads of any dtype ride along by indexing with the
permutation the stable sort returns. ``torch.sort`` returns that permutation
(int64) whatever it sorts, so an argsort is the permutation itself,
narrowed, and 64-bit keys with payloads sort in one int64 sort, where the
JAX package chained two 32-bit passes for the TPU.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops.common import _MIN32, _MIN64, take
from vkradixsort_tpu_torch.utils import profiling

_SIGNED_OF = {torch.uint32: torch.int32, torch.uint64: torch.int64}


def to_signed_order(enc: torch.Tensor) -> torch.Tensor:
    """Map unsigned keys to same-width signed ints with identical order."""
    if enc.dtype == torch.uint32:
        return enc.view(torch.int32) ^ _MIN32
    if enc.dtype == torch.uint64:
        return enc.view(torch.int64) ^ _MIN64
    raise TypeError(enc.dtype)


def from_signed_order(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype not in _SIGNED_OF:
        raise TypeError(dtype)
    sign = _MIN32 if dtype == torch.uint32 else _MIN64
    return (s ^ sign).view(dtype)


def sort_flat(enc: torch.Tensor) -> torch.Tensor:
    """Keys-only flat sort of uint32/uint64-encoded keys."""
    s, _ = torch.sort(to_signed_order(enc), stable=True)
    return from_signed_order(s, enc.dtype)


def sort_flat_pairs(enc: torch.Tensor, values: tuple = ()):
    """Stable flat sort of uint32/uint64-encoded keys, carrying ``values``:
    one ``torch.sort`` and one gather a payload, 64-bit keys too (the
    former two chained 32-bit passes took 29.2 ms against 17.1 at 1e8 u64
    kv on the H100, PERF.md section 5). Spans: ``vkrs/tiled/sort``, then
    ``vkrs/tiled/gather`` a payload."""
    with profiling.span("vkrs/tiled/sort"):
        s, perm = torch.sort(to_signed_order(enc), stable=True)
        out = from_signed_order(s, enc.dtype)
    gathered = []
    for v in values:
        with profiling.span("vkrs/tiled/gather"):
            gathered.append(take(v, perm))
    return out, tuple(gathered)


def narrow_indices(perm: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.sort``'s int64 permutation in the JAX argsort's index dtype:
    uint32 below 2^32 (the truncation keeps the bits), else uint64."""
    if n < 1 << 32:
        return perm.to(torch.int32).view(torch.uint32)
    return perm.view(torch.uint64)


def argsort_flat(enc: torch.Tensor) -> torch.Tensor:
    """Stable argsort of uint32/uint64-encoded keys: the permutation of one
    stable ``torch.sort``, with no payload to gather (span
    ``vkrs/tiled/sort``)."""
    with profiling.span("vkrs/tiled/sort"):
        _, perm = torch.sort(to_signed_order(enc), stable=True)
        return narrow_indices(perm, enc.shape[0])


def sort_segments(enc2d: torch.Tensor, values2d: tuple = ()):
    """Independent stable ascending sort of every row of a 2-D encoded array,
    carrying 2-D payloads of the same shape."""
    s, perm = torch.sort(to_signed_order(enc2d), dim=1, stable=True)
    if values2d:
        rows, cols = enc2d.shape
        flat = (perm + cols * torch.arange(rows, device=perm.device)[:, None]).reshape(-1)
        values2d = tuple(take(v.reshape(-1), flat).reshape(rows, cols) for v in values2d)
    return from_signed_order(s, enc2d.dtype), tuple(values2d)


def argsort_segments(enc2d: torch.Tensor) -> torch.Tensor:
    """Stable argsort of every row of a 2-D encoded array: the permutation
    of ``torch.sort(dim=1)``, with no positions to gather."""
    _, perm = torch.sort(to_signed_order(enc2d), dim=1, stable=True)
    return narrow_indices(perm, enc2d.shape[1])
