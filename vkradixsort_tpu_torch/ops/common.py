"""Key encodings and shape helpers shared by every sort path.

Port of ``vkradixsort_tpu/ops/common.py``: every key dtype maps to an
unsigned int (uint32 for keys of at most 4 bytes, uint64 above) whose
ascending order is the key order, and back. Floats sort in IEEE-754 total
order: ``-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN``.

torch implements shifts, comparisons, ``~`` and ``where`` for int32/int64 but
not for uint32/uint64, so the bit work here runs on same-width signed views
and only the results are viewed as unsigned. Signed-view tricks used below:
"sign bit set" is ``bits < 0``, and XOR with ``-1`` is the bit complement.
"""

from __future__ import annotations

import torch

_MIN32 = -(1 << 31)  # 0x80000000 as an int32 scalar
_MIN64 = -(1 << 63)  # 0x8000000000000000 as an int64 scalar
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

# Radix configuration of the radix engines: 8-bit digits, 256 bins; 4 LSD
# passes for 32-bit keys, 8 for 64-bit.
BITS_PER_PASS = 8
NUM_BINS = 1 << BITS_PER_PASS


def num_passes(dtype: torch.dtype) -> int:
    """Number of 8-bit LSD passes for a sortable unsigned dtype."""
    return dtype.itemsize * 8 // BITS_PER_PASS


def extract_digit(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """``(key >> shift) & 0xFF`` as int32, for keys of any integer dtype.
    The shift runs on the signed view: the mask drops the bits an arithmetic
    shift brings in."""
    return ((bits_view(keys) >> shift) & (NUM_BINS - 1)).to(torch.int32)


def sortable_dtype(dtype: torch.dtype) -> torch.dtype:
    """The unsigned dtype whose ascending order realizes ``dtype``'s order."""
    _check_key_dtype(dtype)
    return torch.uint32 if dtype.itemsize <= 4 else torch.uint64


def _check_key_dtype(dtype: torch.dtype) -> None:
    if dtype == torch.bool or dtype.is_complex or dtype.itemsize not in _SIGNED:
        raise TypeError(f"unsupported key dtype {dtype}")


def _is_unsigned(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_signed


def encode_keys(keys: torch.Tensor) -> torch.Tensor:
    """Map keys to unsigned ints whose ascending uint order is the key order.

    - unsigned ints: identity (widened to uint32 / uint64)
    - signed ints: flip the sign bit
    - floats: negative values get all bits flipped, the rest get the sign bit
      set (IEEE-754 total order)
    """
    dtype = keys.dtype
    _check_key_dtype(dtype)
    size = dtype.itemsize
    if _is_unsigned(dtype):
        if size == 4 or size == 8:
            return keys
        return keys.to(torch.int32).view(torch.uint32)
    if not dtype.is_floating_point:
        if size == 8:
            return (keys ^ _MIN64).view(torch.uint64)
        if size == 4:
            return (keys ^ _MIN32).view(torch.uint32)
        nbits = 8 * size
        flipped = (keys.to(torch.int32) ^ (1 << (nbits - 1))) & ((1 << nbits) - 1)
        return flipped.view(torch.uint32)
    if size == 2:
        bits = keys.view(torch.int16).to(torch.int32) & 0xFFFF
        mask = torch.where(bits >= 0x8000, 0xFFFF, 0x8000).to(torch.int32)
        return (bits ^ mask).view(torch.uint32)
    bits = keys.view(_SIGNED[size])
    sign = _MIN64 if size == 8 else _MIN32
    mask = torch.where(bits < 0, -1, sign).to(bits.dtype)
    return (bits ^ mask).view(sortable_dtype(dtype))


def decode_keys(encoded: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`encode_keys` back to ``dtype``."""
    _check_key_dtype(dtype)
    size = dtype.itemsize
    bits = encoded.view(_SIGNED[encoded.dtype.itemsize])
    if _is_unsigned(dtype):
        if size == 4 or size == 8:
            return bits.view(dtype)
        return bits.to(dtype)
    if not dtype.is_floating_point:
        if size == 8:
            return bits ^ _MIN64
        if size == 4:
            return bits ^ _MIN32
        return (bits ^ (1 << (8 * size - 1))).to(dtype)
    if size == 2:
        low = bits & 0xFFFF
        mask = torch.where(low >= 0x8000, 0x8000, 0xFFFF).to(torch.int32)
        return (low ^ mask).to(torch.int16).view(dtype)
    sign = _MIN64 if size == 8 else _MIN32
    mask = torch.where(bits < 0, sign, -1).to(bits.dtype)
    return (bits ^ mask).view(dtype)


def complement(enc: torch.Tensor) -> torch.Tensor:
    """Bit complement of encoded keys: an order-reversing involution on the
    unsigned domain (the ``descending=`` transform)."""
    return (enc.view(_SIGNED[enc.dtype.itemsize]) ^ -1).view(enc.dtype)


def bits_view(x: torch.Tensor) -> torch.Tensor:
    """Same-width signed int view of any 1/2/4/8-byte tensor (bool as int8),
    for the ops torch lacks on unsigned dtypes."""
    if x.dtype == torch.bool:
        return x.view(torch.int8)
    return x.view(_SIGNED[x.dtype.itemsize])


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for any dtype (CUDA has no indexing of unsigned dtypes)."""
    return bits_view(x)[idx].view(x.dtype)


def positions(n: int, device) -> torch.Tensor:
    """0..n-1 as uint32 (uint64 from 2^32 on), like the JAX argsort; made
    in int32 where it fits, without an int64 pass."""
    if n < 1 << 31:
        return torch.arange(n, dtype=torch.int32, device=device).view(torch.uint32)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if n < 1 << 32:
        return idx.to(torch.int32).view(torch.uint32)
    return idx.view(torch.uint64)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def signed_bits(value: int, itemsize: int) -> int:
    """The ``itemsize``-byte two's-complement reading of the bit pattern of
    ``value`` (e.g. 0xFFFFFFFF -> -1 for 4 bytes): how an unsigned value is
    written into a tensor's :func:`bits_view`."""
    nbits = 8 * itemsize
    value &= (1 << nbits) - 1
    return value - (1 << nbits) if value >> (nbits - 1) else value


def pad_sentinel(dtype: torch.dtype) -> int:
    """Max value of the integer key dtype; padding sorts to the end."""
    _check_key_dtype(dtype)
    nbits = 8 * dtype.itemsize
    if _is_unsigned(dtype):
        return (1 << nbits) - 1
    return (1 << (nbits - 1)) - 1


def pad_to(keys: torch.Tensor, n_padded: int) -> torch.Tensor:
    """Pad a 1-D integer key tensor with end-sorting sentinels to length
    ``n_padded``."""
    n = keys.shape[0]
    if n == n_padded:
        return keys
    fill = signed_bits(pad_sentinel(keys.dtype), keys.element_size())
    out = torch.full((n_padded,), fill, dtype=_SIGNED[keys.element_size()], device=keys.device)
    out[:n] = bits_view(keys)
    return out.view(keys.dtype)


def _order_view(x: torch.Tensor) -> torch.Tensor:
    """Same-width signed ints whose order is ``x``'s (sign bit flipped for
    unsigned dtypes)."""
    if _is_unsigned(x.dtype):
        return bits_view(x) ^ (_MIN64 if x.element_size() == 8 else _MIN32)
    return x


def composite_searchsorted(k_sorted, g_sorted, qk, qg) -> torch.Tensor:
    """Count of pairs (k, g) lexicographically < (qk, qg), vectorized over
    the queries; int32. ``(k_sorted, g_sorted)`` (``g`` int32 or int64) must be
    lexicographically sorted along the last dimension; leading dimensions
    batch (queries broadcast over them). Keys of up to 4 bytes with an int32
    ``g`` pack into one int64 and take one ``torch.searchsorted``; 8-byte
    keys or an int64 ``g`` take the bisection loop of the JAX package, in
    O(|q| log n)."""
    k_s, q_s = _order_view(k_sorted), _order_view(qk)
    qg = qg.expand(*k_s.shape[:-1], qg.shape[-1]).contiguous()
    q_s = q_s.expand(qg.shape).contiguous()
    if k_s.element_size() <= 4 and g_sorted.dtype == torch.int32:
        def pack(k, g):
            return (k.to(torch.int64) << 32) | (g.to(torch.int64) - _MIN32)

        return torch.searchsorted(pack(k_s, g_sorted), pack(q_s, qg)).to(torch.int32)
    n = k_s.shape[-1]
    lo = torch.zeros(qg.shape, dtype=torch.int64, device=qg.device)
    hi = torch.full(qg.shape, n, dtype=torch.int64, device=qg.device)
    for _ in range((max(n, 2) - 1).bit_length() + 1):  # ceil(log2(max(n, 2))) + 1
        mid = (lo + hi) // 2
        safe = mid.clamp(max=n - 1)
        mk = torch.gather(k_s, -1, safe)
        mg = torch.gather(g_sorted, -1, safe)
        lt = (mk < q_s) | ((mk == q_s) & (mg < qg))
        active = lo < hi
        lo = torch.where(active & lt, mid + 1, lo)
        hi = torch.where(active & ~lt, mid, hi)
    return lo.to(torch.int32)
