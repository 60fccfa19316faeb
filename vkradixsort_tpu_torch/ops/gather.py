"""Payload columns moved through one permutation: ``gather_columns``.

The radix_tiled sort of a payload set (``radix_tiled.sort_radix_tiled``)
sorts the keys with their u32 positions, then moves every column through
the sorted positions here: on a CUDA tensor in one launch of the kernel
``csrc/gather.cu`` per :data:`kernels.MAX_COLUMNS` columns, which reads each
position once a row; on a CPU tensor by its plain version, the torch
indexing of the library route (``common.take``, one int64 index).
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops import kernels
from vkradixsort_tpu_torch.ops.common import bits_view, take
from vkradixsort_tpu_torch.utils import profiling

COLUMN_BYTES = (1, 2, 4, 8)  # element widths the kernel moves


def _check(perm: torch.Tensor, columns: tuple) -> None:
    if perm.dtype != torch.uint32 or perm.dim() != 1:
        raise TypeError(f"perm must be 1-D uint32, got {perm.dtype} {tuple(perm.shape)}")
    for c in columns:
        if c.shape != perm.shape or c.device != perm.device:
            raise ValueError("every column must have the permutation's shape and device")
        if c.element_size() not in COLUMN_BYTES:
            raise TypeError(f"gather_columns moves columns of {COLUMN_BYTES} bytes, got {c.dtype}")


def gather_columns_plain(perm: torch.Tensor, columns: tuple) -> tuple:
    """Plain version of :func:`gather_columns`: each column indexed by the
    permutation widened to int64."""
    idx = bits_view(perm).to(torch.int64) & 0xFFFFFFFF
    return tuple(take(c, idx) for c in columns)


def gather_columns(perm: torch.Tensor, columns: tuple) -> tuple:
    """``(c[perm] for c in columns)``: every column (1, 2, 4 or 8 bytes an
    element, the permutation's length) moved through the uint32 permutation
    ``perm``, each read once a row. On a CUDA tensor one launch per
    :data:`kernels.MAX_COLUMNS` columns (counter ``launch.gather_columns``);
    on a CPU tensor :func:`gather_columns_plain`. The inputs are not
    modified."""
    columns = tuple(columns)
    _check(perm, columns)
    if perm.device.type == "cpu":
        return gather_columns_plain(perm, columns)
    if perm.device.type != "cuda":
        raise ValueError(f"gather_columns runs on CUDA tensors, got {perm.device}")
    perm = perm.contiguous()
    columns = tuple(c.contiguous() for c in columns)
    outs = tuple(torch.empty_like(c) for c in columns)
    n = perm.shape[0]
    for i in range(0, len(columns) if n else 0, kernels.MAX_COLUMNS):
        group = slice(i, i + kernels.MAX_COLUMNS)
        src, widths = kernels.columns(columns[group])
        dst, _ = kernels.columns(outs[group])
        kernels.call("gather_columns", perm.device, perm.data_ptr(), n, len(outs[group]), src,
                     dst, widths)
        profiling.count("launch.gather_columns")
    return outs
