"""The library-sort path: ``torch.sort`` in sign-flipped int space.

Port of ``vkradixsort_tpu/ops/tiled.py``. It is the route of every call the
merge engine does not take, at every size and on every device, and the
route of every CPU tensor unless ``backend="merge"`` is explicit.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops import segsort


def sort_tiled(enc: torch.Tensor, vals: tuple = ()):
    """Sort encoded (unsigned) keys and any number of payloads. Returns
    ``(sorted_keys, sorted_vals_tuple)``; stable."""
    if enc.dtype == torch.uint32:
        return segsort.sort_flat_u32(enc, vals)
    if enc.dtype == torch.uint64:
        return segsort.sort_flat_u64(enc, vals)
    raise TypeError(f"encoded keys must be uint32/uint64, got {enc.dtype}")
