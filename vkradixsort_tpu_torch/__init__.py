"""vkradixsort_tpu_torch: the sort engine ported to PyTorch and CUDA.

The port of ``vkradixsort_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It imports ``torch`` and never ``jax``. Public API, as in the JAX package:

    sort(keys)                  -> sorted keys
    sort_pairs(keys, values)    -> (sorted keys, values permuted alongside)
    argsort(keys)               -> stable argsort indices
    sort_segments(keys_2d)      -> every row sorted

On a CUDA tensor the default route (``engine/config.ROUTE_TABLE``) sends
32- and 64-bit keys with one 4-byte payload (``stable=False`` too) and
32-bit keys alone above 2^23 elements, and 64-bit keys alone and the
argsort of 32-bit keys above 2^25, to
the radix_tiled engine's hand-written kernels (``csrc/``, built with
``nvcc`` at first use) and everything else to ``torch.sort``.
``backend="merge"`` runs the merge engine's tile-sort and merge-path
kernels, ``backend="fused"`` the one-launch radix kernel,
``backend="bitonic"`` the bitonic network's kernels,
``backend="samplesort"`` the sample sort with its run-placement kernel, and
``backend="reference"`` the plain radix sort. The distributed sort is in
``vkradixsort_tpu_torch.parallel.distributed``.
"""

from vkradixsort_tpu_torch.engine.config import SortConfig
from vkradixsort_tpu_torch.engine.context import GPUContext
from vkradixsort_tpu_torch.ops.common import decode_keys, encode_keys, sortable_dtype
from vkradixsort_tpu_torch.ops.dispatch import argsort, sort, sort_pairs, sort_segments

__version__ = "0.1.0"

__all__ = [
    "sort",
    "sort_pairs",
    "argsort",
    "sort_segments",
    "encode_keys",
    "decode_keys",
    "sortable_dtype",
    "SortConfig",
    "GPUContext",
    "__version__",
]
