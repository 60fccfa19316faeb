"""The JAX package's distributed sort under one ``jax.jit``, for the tests.

Called eagerly, ``sort_sharded``'s ``shard_map`` body runs one primitive at
a time across the 8 CPU devices: about 20-40 s a call. Jitted, the same body
(splitters, exchange, local engines) compiles once and runs in a few
seconds, and tests with the same shapes and static arguments share that
compile, since there is one jit object. The port's tests call
``jax_dist.sort_sharded`` for the JAX package's answers.
"""

import jax

from vkradixsort_tpu.parallel import distributed

sort_sharded = jax.jit(
    distributed.sort_sharded,
    static_argnames=(
        "mesh",
        "axis_name",
        "slack",
        "oversample",
        "descending",
        "overlap_chunks",
        "gidx_dtype",
        "local_engine",
    ),
)
