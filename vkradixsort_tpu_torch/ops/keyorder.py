"""The key-order transform: keys to the unsigned order every engine sorts,
and back.

Every engine sorts uint32/uint64 keys in ascending order. :func:`encode`
maps keys to that order (``common.encode_keys``), bit-complemented when
``descending`` (``common.complement``); :func:`decode` is its inverse
(``complement``, then ``common.decode_keys``). For keys of 4 and 8 bytes
each direction is one XOR of every key with one of two masks, chosen by the
key's top bit (:func:`masks`): on a CUDA tensor one launch of the kernel
``csrc/keyorder.cu`` (:func:`key_order`, counter ``launch.key_order``), on
a CPU tensor its plain version (:func:`key_order_plain`). Unsigned keys in
ascending order are the identity both ways: no launch and no new buffer.
Keys of 1 and 2 bytes, which widen to uint32, keep the composed torch
transform on every device.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops import kernels
from vkradixsort_tpu_torch.ops.common import (
    _is_unsigned,
    bits_view,
    complement,
    decode_keys,
    encode_keys,
    signed_bits,
    sortable_dtype,
)
from vkradixsort_tpu_torch.utils import profiling

KEY_BYTES = (4, 8)  # key widths the kernel maps


def identity(dtype: torch.dtype, descending: bool) -> bool:
    """Whether the transform of ``dtype`` keys is the identity: unsigned
    keys of 4 or 8 bytes in ascending order."""
    return _is_unsigned(dtype) and dtype.itemsize in KEY_BYTES and not descending


def masks(dtype: torch.dtype, descending: bool, inverse: bool) -> tuple[int, int]:
    """``(set_mask, clear_mask)``, as unsigned ints, of the transform of
    4- or 8-byte ``dtype`` keys: each key is XORed with ``set_mask`` where
    its top bit is set and with ``clear_mask`` where it is clear. Forward
    (``inverse`` False) the input is the key; inverse it is the encoded
    key, complemented if ``descending``."""
    sortable_dtype(dtype)  # raises for what no sort takes
    if dtype.itemsize not in KEY_BYTES:
        raise TypeError(f"the key-order kernel maps keys of {KEY_BYTES} bytes, got {dtype}")
    nbits = 8 * dtype.itemsize
    ones, sign = (1 << nbits) - 1, 1 << (nbits - 1)
    flip = ones if descending else 0
    if not dtype.is_floating_point:  # unsigned: the complement alone; signed: the sign bit too
        m = flip if _is_unsigned(dtype) else sign ^ flip
        return m, m
    if not inverse:  # negative floats: every bit; the rest: the sign bit
        return ones ^ flip, sign ^ flip
    if descending:  # top bit set: a negative key, complemented twice
        return 0, ones ^ sign
    return sign, ones


def _check(x: torch.Tensor, out) -> None:
    if x.element_size() not in KEY_BYTES:
        raise TypeError(f"key_order maps keys of {KEY_BYTES} bytes, got {x.dtype}")
    if out is not None and (out.shape != x.shape or out.element_size() != x.element_size()
                            or out.device != x.device):
        raise ValueError("out must have the keys' shape, width and device")


def key_order_plain(x: torch.Tensor, set_mask: int, clear_mask: int, out=None) -> torch.Tensor:
    """Plain version of :func:`key_order`: the mask of each key from its
    top bit (``where``), then one XOR."""
    _check(x, out)
    bits = bits_view(x)
    size = x.element_size()
    mask = torch.where(bits < 0, signed_bits(set_mask, size),
                       signed_bits(clear_mask, size)).to(bits.dtype)
    if out is None:
        return bits ^ mask
    return torch.bitwise_xor(bits, mask, out=bits_view(out))


def key_order(x: torch.Tensor, set_mask: int, clear_mask: int, out=None) -> torch.Tensor:
    """Every 4- or 8-byte key of ``x`` XORed with ``set_mask`` where its top
    bit is set and with ``clear_mask`` where it is clear, as same-width
    signed ints, into ``out`` when given (``x`` itself is allowed). On a
    CUDA tensor one launch of ``csrc/keyorder.cu`` (counter
    ``launch.key_order``); on a CPU tensor :func:`key_order_plain`."""
    _check(x, out)
    if x.device.type == "cpu":
        return key_order_plain(x, set_mask, clear_mask, out)
    if x.device.type != "cuda":
        raise ValueError(f"key_order runs on CUDA tensors, got {x.device}")
    x = x.contiguous()
    if out is None:
        out = torch.empty_like(bits_view(x))
    elif not out.is_contiguous():
        raise ValueError("key_order writes a contiguous out")
    n = x.numel()
    if n:
        kernels.call("key_order", x.device, x.data_ptr(), out.data_ptr(), n, x.element_size(),
                     set_mask, clear_mask)
        profiling.count("launch.key_order")
    return bits_view(out)


def encode(keys: torch.Tensor, descending: bool) -> torch.Tensor:
    """Keys as uint32/uint64 whose ascending order is the key order
    (descending: its reverse); ``keys`` itself where :func:`identity`."""
    dtype = keys.dtype
    if identity(dtype, descending):
        return keys
    if dtype.itemsize not in KEY_BYTES:
        enc = encode_keys(keys)
        return complement(enc) if descending else enc
    set_mask, clear_mask = masks(dtype, descending, inverse=False)
    return key_order(keys, set_mask, clear_mask).view(sortable_dtype(dtype))


def decode(enc: torch.Tensor, dtype: torch.dtype, descending: bool,
           in_place: bool = False) -> torch.Tensor:
    """The inverse of :func:`encode` back to ``dtype``. ``in_place``: the
    caller owns ``enc``, and a contiguous ``enc`` of 4 or 8 bytes a key is
    overwritten with the answer."""
    if identity(dtype, descending):
        return enc.view(dtype)
    if dtype.itemsize not in KEY_BYTES:
        return decode_keys(complement(enc) if descending else enc, dtype)
    set_mask, clear_mask = masks(dtype, descending, inverse=True)
    out = enc if in_place and enc.is_contiguous() else None
    return key_order(enc, set_mask, clear_mask, out).view(dtype)
