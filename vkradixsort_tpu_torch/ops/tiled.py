"""The library-sort path: ``torch.sort`` in sign-flipped int space.

Port of ``vkradixsort_tpu/ops/tiled.py``. It is the route of every call
``engine/config.ROUTE_TABLE`` sends nowhere else, and of every CPU tensor
unless ``backend=`` names another engine.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.ops import segsort


def sort_tiled(enc: torch.Tensor, vals: tuple = ()):
    """Sort encoded (unsigned) keys and any number of payloads. Returns
    ``(sorted_keys, sorted_vals_tuple)``; stable."""
    return segsort.sort_flat_pairs(enc, vals)


def argsort_tiled(enc: torch.Tensor) -> torch.Tensor:
    """Stable argsort of encoded (unsigned) keys: ``torch.sort``'s own
    permutation, uint32 below 2^32 indices, else uint64."""
    return segsort.argsort_flat(enc)
