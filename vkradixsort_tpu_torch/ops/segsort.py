"""Sort primitives on the library sort, in sign-flipped int space.

Port of ``vkradixsort_tpu/ops/segsort.py``. Encoded (unsigned) keys move into
order-isomorphic int32/int64 space, where ``torch.sort`` is implemented on
every device; payloads of any dtype ride along by indexing with the
permutation the stable sort returns. 64-bit keys with payloads sort as two
stable passes over 32-bit digits (LSD radix), as the JAX package does.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops.common import _MIN32, _MIN64, take

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


def sort_flat_u32(enc: torch.Tensor, values: tuple = ()):
    """Stable flat sort of uint32-encoded keys, carrying ``values``."""
    s, perm = torch.sort(to_signed_order(enc), stable=True)
    return from_signed_order(s, torch.uint32), tuple(take(v, perm) for v in values)


def sort_flat_u64(enc: torch.Tensor, values: tuple = ()):
    """uint64 keys: one direct int64 sort when keys-only, else two chained
    stable 32-bit-digit passes (low digit first), each carrying the other
    digit and the payloads."""
    if not values:
        return sort_flat(enc), ()
    bits = enc.view(torch.int64)
    lo = bits.to(torch.int32).view(torch.uint32)
    hi = (bits >> 32).to(torch.int32).view(torch.uint32)
    lo_s, rest = sort_flat_u32(lo, (hi,) + tuple(values))
    hi_s, rest2 = sort_flat_u32(rest[0], (lo_s,) + tuple(rest[1:]))
    out = (hi_s.view(torch.int32).to(torch.int64) << 32) | (
        rest2[0].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    )
    return out.view(torch.uint64), tuple(rest2[1:])


def sort_segments(enc2d: torch.Tensor, values2d: tuple = ()):
    """Independent stable ascending sort of every row of a 2-D encoded array,
    carrying 2-D payloads of the same shape."""
    s, perm = torch.sort(to_signed_order(enc2d), dim=1, stable=True)
    if values2d:
        rows, cols = enc2d.shape
        flat = (perm + cols * torch.arange(rows, device=perm.device)[:, None]).reshape(-1)
        values2d = tuple(take(v.reshape(-1), flat).reshape(rows, cols) for v in values2d)
    return from_signed_order(s, enc2d.dtype), tuple(values2d)
