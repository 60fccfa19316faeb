"""Digit histograms of the radix sort.

Port of ``vkradixsort_tpu/ops/histogram.py``. ``tile_histograms``, per-tile
256-bin counts of one pass's digit (the JAX package's API, kernel
``csrc/histogram.cu``), and ``digit_histograms``, every pass's 256 counts
from one read of the keys, scanned into each digit's first output slot (the
card's sort route, kernel ``csrc/onesweep.cu``). Each launches its kernel
on a CUDA tensor and runs its plain version (``bincount``) on a CPU tensor.

The JAX kernel padded the keys to 8 tiles (a Mosaic block-shape artifact)
with dtype-max sentinels, which landed in bin 255 of the last tiles. Here the
table has exactly ``cdiv(n, tile)`` rows and counts only real elements.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.engine.config import DEFAULT_CONFIG
from vkradixsort_tpu_torch.ops import kernels, reference
from vkradixsort_tpu_torch.ops.common import (
    BITS_PER_PASS,
    NUM_BINS,
    cdiv,
    extract_digit,
    num_passes,
)
from vkradixsort_tpu_torch.utils import profiling


def check_digit_input(enc: torch.Tensor, shift: int, tile: int) -> None:
    """Raise on what the radix kernels do not take."""
    if enc.dtype not in (torch.uint32, torch.uint64) or enc.dim() != 1:
        raise TypeError(f"radix kernels take 1-D uint32/uint64 keys, got {enc.dtype} "
                        f"{tuple(enc.shape)}")
    if not 0 <= shift < 8 * enc.element_size() or tile < 1:
        raise ValueError(f"bad shift {shift} or tile {tile} for {enc.dtype} keys")


def digit_half(enc: torch.Tensor, shift: int):
    """The 32-bit half of each key that holds digit ``shift``, as a strided
    int32 view of contiguous CUDA keys (no copy), and the shift within it:
    ``(x, stride, shift)``. Raises on what the kernels do not take."""
    if enc.device.type != "cuda":
        raise ValueError(f"the radix kernels run on CUDA tensors, got {enc.device}")
    if not enc.is_contiguous():
        raise ValueError("the radix kernels take contiguous keys")
    if enc.dtype == torch.uint32:
        return enc.view(torch.int32), 1, shift
    halves = enc.view(torch.int32)  # little-endian: low half first
    return (halves[0::2], 2, shift) if shift < 32 else (halves[1::2], 2, shift - 32)


def tile_histograms_plain(enc: torch.Tensor, shift: int,
                          tile: int = DEFAULT_CONFIG.chunk) -> torch.Tensor:
    """Plain version of the histogram kernel: one ``bincount`` over
    ``tile_id * 256 + digit``."""
    return reference.digit_counts(extract_digit(enc, shift), tile)


def tile_histograms(enc: torch.Tensor, shift: int,
                    tile: int = DEFAULT_CONFIG.chunk) -> torch.Tensor:
    """``[cdiv(n, tile), 256]`` int32 counts of the digit
    ``(enc >> shift) & 0xFF`` in every ``tile`` consecutive keys (the last
    tile may be short). ``enc``: uint32 or uint64 encoded keys."""
    check_digit_input(enc, shift, tile)
    if enc.device.type == "cpu":
        return tile_histograms_plain(enc, shift, tile)
    x, stride, sh = digit_half(enc, shift)
    n = enc.shape[0]
    out = torch.empty((cdiv(n, tile), NUM_BINS), dtype=torch.int32, device=enc.device)
    if n:
        kernels.call("histogram", enc.device, x.data_ptr(), n, stride, sh, tile, out.data_ptr())
        profiling.count("launch.tile_histograms")
    return out


def digit_histograms_plain(enc: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`digit_histograms`: a ``bincount`` of each
    pass's digit, then an exclusive cumsum."""
    counts = torch.stack([torch.bincount(extract_digit(enc, p * BITS_PER_PASS),
                                         minlength=NUM_BINS)
                          for p in range(num_passes(enc.dtype))])
    return (torch.cumsum(counts, 1) - counts).to(torch.int32)


def digit_histograms(enc: torch.Tensor) -> torch.Tensor:
    """``[passes, 256]`` int32: ``offset[p, d]``, the number of keys whose
    digit ``(enc >> 8p) & 0xFF`` is below ``d``, so the first output slot
    of digit ``d`` in the stable pass ``p``. ``enc``: uint32 (4 passes) or
    uint64 (8) encoded keys, n < 2^31."""
    check_digit_input(enc, 0, 1)
    if enc.shape[0] >= 1 << 31:
        raise ValueError(f"the radix offsets are int32, so n must be below 2^31; "
                         f"got {enc.shape[0]}")
    if enc.device.type == "cpu":
        return digit_histograms_plain(enc)
    if enc.device.type != "cuda":
        raise ValueError(f"the radix kernels run on CUDA tensors, got {enc.device}")
    if not enc.is_contiguous():
        raise ValueError("the radix kernels take contiguous keys")
    passes, n = num_passes(enc.dtype), enc.shape[0]
    out = torch.empty(passes * NUM_BINS + 1, dtype=torch.int32, device=enc.device)
    if n:  # the kernel zeroes out, counts, and keeps its done count in the last word
        kernels.call("digit_histograms", enc.device, enc.data_ptr(), enc.element_size(), n,
                     out.data_ptr())
        profiling.count("launch.digit_histograms")
    else:
        out.zero_()
    return out[:-1].view(passes, NUM_BINS)
