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
      tile: elements per tile of the merge engine's tile-sort kernel (a power
        of two). ``None`` (default) takes the largest tile whose key and
        position planes fit shared memory twice over on one SM, so two
        tile-sort blocks share each SM (``ops/merge.default_tile``).
    """

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
