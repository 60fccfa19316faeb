"""One-launch LSD radix sort of a small array: VkRadixSort's single_radixsort.

Port of ``vkradixsort_tpu/ops/fused.py``. ``sort_fused`` launches the CUDA
kernel ``csrc/fused.cu`` (a cluster of eight blocks runs every 8-bit pass
with the array held on chip, in registers and shared memory) on a CUDA
tensor and runs its plain version ``sort_fused_plain``, the plain radix sort
of ``ops/reference.py`` with one chunk, on a CPU tensor. It takes
``N <= SortConfig.fused_max_n``, and the kernel at most ``MAX_N``; dispatch
routes to it on explicit ``backend="fused"`` only.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.engine.config import DEFAULT_CONFIG, SortConfig
from vkradixsort_tpu_torch.ops import kernels, reference
from vkradixsort_tpu_torch.ops.common import only_one_payload
from vkradixsort_tpu_torch.utils import profiling

# Most keys the kernel takes (csrc/fused.cu kFusedMaxN): positions fit 15
# bits, and the array fits the shared memory of the kernel's cluster.
MAX_N = 1 << 15


def sort_fused_plain(enc: torch.Tensor, values=None):
    """Plain version of the fused kernel: every LSD pass of the reference
    radix sort over one chunk."""
    return reference.radix_sort_encoded(enc, values, num_chunks=1)


def sort_fused(enc: torch.Tensor, values=None, config: SortConfig = DEFAULT_CONFIG):
    """Stable sort of at most ``config.fused_max_n`` uint32/uint64 encoded
    keys, carrying one 4- or 8-byte payload (or None), in one kernel launch.
    Returns ``(sorted_keys, sorted_values)``; the inputs are not modified."""
    if enc.dtype not in (torch.uint32, torch.uint64) or enc.dim() != 1:
        raise TypeError(f"fused engine sorts 1-D uint32/uint64 keys, got {enc.dtype}")
    if values is not None:
        if values.element_size() not in (4, 8):
            raise TypeError(f"values must be 4- or 8-byte typed, got {values.dtype}")
        if values.shape != enc.shape or values.device != enc.device:
            raise ValueError("values must have the keys' shape and device")
    n = enc.shape[0]
    if n > config.fused_max_n:
        raise ValueError(
            f"fused engine accepts N <= config.fused_max_n ({config.fused_max_n}); "
            "one block runs every pass, so larger arrays take 'radix_tiled', "
            "'merge' or 'tiled', or raise config.fused_max_n explicitly"
        )
    if enc.device.type == "cpu":
        return sort_fused_plain(enc, values)
    if enc.device.type != "cuda":
        raise ValueError(f"the fused kernel runs on CUDA tensors, got {enc.device}")
    if n > MAX_N:
        raise ValueError(f"the fused kernel takes n <= {MAX_N}, got {n}")
    if n <= 1:
        return enc.clone(), None if values is None else values.clone()
    keys_in = enc.contiguous()
    keys_out = torch.empty_like(keys_in)
    vals_in = vals_out = None
    if values is not None:
        vals_in = values.contiguous()
        vals_out = torch.empty_like(vals_in)
    kernels.call(
        "fused", enc.device,
        keys_in.data_ptr(), _ptr(vals_in), keys_out.data_ptr(), _ptr(vals_out),
        n, enc.element_size(), 0 if values is None else values.element_size(),
    )
    profiling.count("launch.sort_fused")
    return keys_out, vals_out


def sort_encoded(enc: torch.Tensor, vals: tuple, config: SortConfig = DEFAULT_CONFIG):
    """``backend="fused"``: :func:`sort_fused` with at most one payload;
    ``(sorted_keys, sorted_vals_tuple)``."""
    only_one_payload("fused", vals)
    out_k, out_v = sort_fused(enc, vals[0] if vals else None, config)
    return out_k, (out_v,) if vals else ()


def _ptr(t):
    return None if t is None else t.data_ptr()
