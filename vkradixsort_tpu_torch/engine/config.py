"""Sort configuration and the default-routing table.

Port of ``vkradixsort_tpu/engine/config.py``. The JAX package's tables were
measured on another chip; none of their rows carries over. Every row here
is a measurement on the H100.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Knobs for the sort pipelines.

    Attributes:
      fused_max_n: largest N the fused one-launch radix kernel accepts when
        it is selected (``backend="fused"``), the analog of the reference's
        single-workgroup regime (VkRadixSort recommends it below about 10k
        keys); above this dispatch raises. One cluster of blocks holds the
        whole array on chip, so on the card the kernel itself takes at most
        ``ops/fused.MAX_N`` (32768, the default).
      chunk: elements per tile of the radix_tiled pipeline: each histogram
        row and each block of the rank-and-scatter kernel covers ``chunk``
        consecutive keys. 16384, the fastest of the H100 sweep of a 1e8
        stable u32 kv sort over 2048 to 16384 (PERF.md; the JAX package
        takes 2048): a tile's run of each digit fills more of its write
        sectors, and the ``[tiles, 256]`` table and its scan shrink. The
        sorted result does not depend on it.
      tile: grain size in elements per tile. The merge engine's tile-sort
        kernel sorts tiles of ``tile`` elements, floored to a power of two
        and capped at ``ops/merge.default_tile`` as the JAX package floors
        it; the samplesort engine takes it as its tile and bucket target,
        as in the JAX package. ``None`` (default): merge takes the largest tile whose
        keys, positions and digit counters fit one tile-sort block's shared
        memory (``ops/merge.default_tile``);
        samplesort takes the JAX package's defaults, 2^19 keys-only and
        2^21 key-value, which were measured on a TPU v5e, not on the H100.
    """

    fused_max_n: int = 1 << 15
    chunk: int = 16384
    tile: int | None = None

    def replace(self, **kw) -> "SortConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SortConfig()


# Default route of ``backend=None`` for CUDA tensors, per operation and size:
# rows are (max_n, engine), scanned in order; the first row with n <= max_n
# wins, and an operation without rows routes to "tiled". The operations are
# stable sorts of 32-bit encoded keys: "keys" alone, "kv" with one 4-byte
# payload, "kv2" with two; 64-bit keys would look up the same name with "64"
# appended (no such rows: not measured), and other payload sets take
# "tiled" (ops/dispatch._route).
#
# Every row is an H100 measurement (chip_smoke.py's crossover phase, PERF.md
# section 5, 700 W): at 2^16, 2^18, ..., 2^26 and 1e8, each engine in turns,
# in five runs. An engine leaves the library ("tiled", torch.sort) only at
# sizes where it was faster in both turns of every run; a row's bound is
# the geometric middle between the last size measured on one side and the
# first on the other.
#   - kv and keys: torch.sort up to 2^22 (kv 0.374-0.463 ms there against
#     radix_tiled's 0.486-0.487); radix_tiled from 2^24 (kv 0.90 against
#     1.47 ms; 1e8 4.94 against 9.22; keys 1e8 3.64 against 5.75). Merge
#     beat torch.sort on keys at 2^22 in three runs (0.266 against 0.325 ms)
#     and lost in two whose host was slower, so it has no row.
#   - kv2: torch.sort at every size from 2^18 (1e8: 12.68 against merge's
#     18.98 ms); radix_tiled takes one payload.
#   - dist_local: the distributed sort's shard-local sort of (u32 key,
#     gidx) with one payload, by the size of a shard's chunk
#     (parallel/distributed._pick_local_engine; "tiled" there means
#     torch.sort), at 2^16, 2^18, ..., 2^24 in three runs (chip_smoke.py
#     phase 11): merge from 2^22, the least measured size where it won both
#     turns of every run (2^22: 0.70 against 0.90 ms; 2^24: 2.89 against
#     3.92). Below, it won at 2^16 and 2^18 but lost a turn at 2^20 in the
#     two runs whose small calls were slower; sizes between 2^20 and 2^22
#     were not measured and stay on torch.sort. The final sort of what a
#     shard received runs on the engine this row picks for the local sort.
#     dist_local64 (u64 keys, three compare planes) has no row: merge won
#     every run at 2^24 only.
ROUTE_TABLE: dict = {
    "keys": [(1 << 23, "tiled"), (float("inf"), "radix_tiled")],
    "kv": [(1 << 23, "tiled"), (float("inf"), "radix_tiled")],
    "dist_local": [((1 << 22) - 1, "tiled"), (float("inf"), "merge")],
}


def route_for(op: str, n: int, wide: bool = False) -> str:
    """Default engine for ``op`` ("keys" | "kv") at size ``n`` on a CUDA
    device; ``wide`` selects the 64-bit-key rows."""
    for max_n, engine in ROUTE_TABLE.get(op + ("64" if wide else ""), []):
        if n <= max_n:
            return engine
    return "tiled"
