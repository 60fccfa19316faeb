"""Digit histograms of the radix sort.

Port of ``vkradixsort_tpu/ops/histogram.py``. ``tile_histograms``, per-tile
256-bin counts of one pass's digit (the JAX package's API, kernel
``csrc/histogram.cu``), ``digit_histograms``, every pass's 256 counts from
one read of the keys, scanned into each digit's first output slot (the
card's sort route, kernel ``csrc/onesweep.cu``), and
``digit_histograms_rows``, the same for every row of a 2-D array (the row
sort's route, the same file). Each launches its kernel
on a CUDA tensor and runs its plain version (``bincount``) on a CPU tensor.

The JAX kernel padded the keys to 8 tiles (a Mosaic block-shape artifact)
with dtype-max sentinels, which landed in bin 255 of the last tiles. Here the
table has exactly ``cdiv(n, tile)`` rows and counts only real elements.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops import kernels, reference
from vkradixsort_tpu_torch.ops.common import (
    BITS_PER_PASS,
    NUM_BINS,
    cdiv,
    extract_digit,
    num_passes,
)
from vkradixsort_tpu_torch.utils import profiling

# The per-pass API's default tile (keys a histogram row and a scatter block
# cover): the fastest of the H100 sweep of its 1e8 u32 kv sort over 2048 to
# 16384 (PERF.md; JAX takes 2048). No sorted result depends on it.
TILE = 16384


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


def tile_histograms_plain(enc: torch.Tensor, shift: int, tile: int = TILE) -> torch.Tensor:
    """Plain version of the histogram kernel: one ``bincount`` over
    ``tile_id * 256 + digit``."""
    return reference.digit_counts(extract_digit(enc, shift), tile)


def tile_histograms(enc: torch.Tensor, shift: int, tile: int = TILE) -> torch.Tensor:
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


def check_rows_input(enc2d: torch.Tensor) -> None:
    """Raise on what the row kernels do not take: 2-D uint32/uint64 keys of
    fewer than 2^31 elements (int32 slots)."""
    if enc2d.dtype not in (torch.uint32, torch.uint64) or enc2d.dim() != 2:
        raise TypeError(f"the row kernels take 2-D uint32/uint64 keys, got {enc2d.dtype} "
                        f"{tuple(enc2d.shape)}")
    if enc2d.numel() >= 1 << 31:
        raise ValueError(f"the row slots are int32, so rows x width must be below 2^31; "
                         f"got {tuple(enc2d.shape)}")


def digit_histograms_rows_plain(enc2d: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`digit_histograms_rows`: a ``bincount`` of
    ``row * 256 + digit`` a pass, an exclusive cumsum along each row, and
    each row's first slot."""
    rows, width = enc2d.shape
    flat = enc2d.reshape(-1)
    row_of = torch.arange(rows * width, device=enc2d.device) // max(width, 1)
    first = (torch.arange(rows, device=enc2d.device) * width)[:, None]
    out = []
    for p in range(num_passes(enc2d.dtype)):
        counts = torch.bincount(row_of * NUM_BINS + extract_digit(flat, p * BITS_PER_PASS),
                                minlength=rows * NUM_BINS).view(rows, NUM_BINS)
        out.append(first + torch.cumsum(counts, 1) - counts)
    return torch.stack(out).to(torch.int32)


def digit_histograms_rows(enc2d: torch.Tensor) -> torch.Tensor:
    """``[passes, rows, 256]`` int32: ``offset[p, r, d]``, row ``r``'s first
    slot (``r * width``) plus the number of its keys whose digit
    ``(key >> 8p) & 0xFF`` is below ``d``: the first output slot of digit
    ``d`` of row ``r`` in the stable pass ``p`` of a sort of each row on its
    own. ``enc2d``: ``[rows, width]`` uint32 (4 passes) or uint64 (8)
    encoded keys, rows x width < 2^31. One launch of
    ``digit_histograms_rows_kernel`` on a CUDA tensor (counter
    ``launch.digit_histograms_rows``)."""
    check_rows_input(enc2d)
    if enc2d.device.type == "cpu":
        return digit_histograms_rows_plain(enc2d)
    if enc2d.device.type != "cuda":
        raise ValueError(f"the radix kernels run on CUDA tensors, got {enc2d.device}")
    if not enc2d.is_contiguous():
        raise ValueError("the radix kernels take contiguous keys")
    passes, (rows, width) = num_passes(enc2d.dtype), enc2d.shape
    out = torch.empty((passes * NUM_BINS + 1) * rows, dtype=torch.int32, device=enc2d.device)
    if enc2d.numel():  # the kernel zeroes out, and keeps a row's done count after the offsets
        kernels.call("digit_histograms_rows", enc2d.device, enc2d.data_ptr(),
                     enc2d.element_size(), rows, width, out.data_ptr())
        profiling.count("launch.digit_histograms_rows")
    else:
        out.zero_()
    return out[:passes * rows * NUM_BINS].view(passes, rows, NUM_BINS)
