"""Sort configuration and the default-routing table.

Port of ``vkradixsort_tpu/engine/config.py``. The JAX package's tables were
measured on another chip; none of their rows carries over. The tables here
start with one provisional row and grow only with measurements on the card.
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
        row and each block of the destination kernel covers ``chunk``
        consecutive keys.
      tile: grain size in elements per tile. The merge engine's tile-sort
        kernel sorts tiles of ``tile`` elements (a power of two); the
        samplesort engine takes it as its tile and bucket target, as in the
        JAX package. ``None`` (default): merge takes the largest tile whose
        keys, positions and digit counters fit one tile-sort block's shared
        memory (``ops/merge.default_tile``);
        samplesort takes the JAX package's defaults, 2^19 keys-only and
        2^21 key-value, which were measured on a TPU v5e, not on the H100.
    """

    fused_max_n: int = 1 << 15
    chunk: int = 2048
    tile: int | None = None

    def replace(self, **kw) -> "SortConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SortConfig()


# Default route of ``backend=None`` for CUDA tensors, per operation and size:
# rows are (max_n, engine), scanned in order; the first row with n <= max_n
# wins, and an operation without rows routes to "tiled". "kv" means 32-bit
# encoded keys with at most two payloads, all 4 bytes wide; 64-bit keys look up the
# same name with "64" appended.
#
# PROVISIONAL: 2^20 is where the main path's sizes begin, not a measured
# crossover between the merge engine and torch.sort on the H100. Measuring
# the crossovers (and adding rows for the other operations) is ROADMAP
# queue 1 item 6.
ROUTE_TABLE: dict = {
    "kv": [((1 << 20) - 1, "tiled"), (float("inf"), "merge")],
}


def route_for(op: str, n: int, wide: bool = False) -> str:
    """Default engine for ``op`` ("keys" | "kv") at size ``n`` on a CUDA
    device; ``wide`` selects the 64-bit-key rows."""
    for max_n, engine in ROUTE_TABLE.get(op + ("64" if wide else ""), []):
        if n <= max_n:
            return engine
    return "tiled"
