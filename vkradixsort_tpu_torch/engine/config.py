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
      chunk: elements per tile of the radix_tiled per-pass API
        (``tile_histograms``, ``tile_scatter``, ``radix_pass_tiled``) and of
        the radix_tiled sort of a CPU tensor: each histogram row and each
        block of the rank-and-scatter kernel covers ``chunk`` consecutive
        keys. 16384, the fastest of the H100 sweep of a 1e8 stable u32 kv
        sort through those passes over 2048 to 16384 (PERF.md; the JAX
        package takes 2048). The card's radix_tiled sort (onesweep) does
        not read it: its kernels' tiles follow the key and payload widths.
        The sorted result does not depend on it.
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
# wins, and an operation without rows routes to "tiled". The operations:
# stable sorts of 32-bit encoded keys, "keys" alone, "kv" with one 4-byte
# payload, "kv2" with two; "argsort"; "kv_unstable" (``stable=False``, one
# 4-byte payload); each with its "64" twin for 64-bit keys. Other payload
# sets take "tiled" (ops/dispatch._route).
#
# Every row is an H100 measurement (chip_smoke.py phases 10 and 11, PERF.md
# section 5, 700 W): at 2^16, 2^18, ..., 2^26 and 1e8, each engine in turns.
# An engine leaves the library ("tiled", torch.sort) only at sizes where it
# was faster in both turns of every run, and for 64-bit keys on uniform
# full-width and on Zipf keys (BASELINE.json config 4) alike; a row's bound
# is the geometric middle between the last size measured on one side and
# the first on the other.
#   - kv and keys: torch.sort up to 2^22 (kv 0.374-0.463 ms there against
#     radix_tiled's 0.486-0.487); radix_tiled from 2^24 (kv 0.90 against
#     1.47 ms; 1e8 4.94 against 9.22; keys 1e8 3.64 against 5.75). Merge
#     beat torch.sort on keys at 2^22 in three runs (0.266 against 0.325 ms)
#     and lost in two whose host was slower, so it has no row.
#   - kv2: torch.sort at every size from 2^18 (1e8: 12.68 against merge's
#     18.98 ms); radix_tiled takes one payload.
#   - kv64: torch.sort up to 2^22, radix_tiled from 2^24 on both key sets
#     (2^24: 2.70-2.73 against 2.81-2.83 ms uniform, 2.20-2.24 against
#     2.39-2.40 Zipf; 1e8: 14.11 against 17.06, 11.45 against 14.03).
#   - keys64: torch.sort up to 2^24, radix_tiled from 2^26 (1e8: 9.43
#     against 13.60 uniform, 9.07 against 11.76 Zipf). At 2^24 radix_tiled
#     won eight runs of nine (Zipf 1.83-1.86 against 2.08-2.09 ms) and lost
#     the one whose small calls were all slower (2.23-2.26 against 2.08):
#     its 56 launches wait on the host there. Merge lost every size.
#   - kv_unstable: every engine runs its stable pipeline, so these are kv's
#     rows, measured again (radix_tiled won 2^22 in one run of two, 0.368
#     against 0.378 ms, and every size from 2^24: 1e8 4.71 against 9.13).
#     kv_unstable64 is kv64's: 64-bit keys have no packed path, so unstable
#     is the stable carry there too.
#   - argsort (u32): torch.sort's own permutation up to 2^24 (1.054-1.061
#     against radix_tiled's 1.118-1.128 ms); radix_tiled, which sorts the
#     keys with their positions, from 2^26 (3.849-3.877 against 4.078-4.096;
#     1e8: 5.653-5.666 against 5.802-5.821), in the three runs made since
#     the positions are built in int32 (before, radix_tiled lost 1e8 by
#     0.26 ms). argsort64: no row; torch.sort won every size on both key
#     sets (1e8: 13.44-13.49 against 15.04-15.06 uniform, 11.62 against
#     12.40-12.43 Zipf). Merge lost every argsort size.
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
#   - dist_local64 (u64 keys, three compare planes), 2^16 to 2^26 in three
#     runs: merge won both turns of every run at 2^24 only (5.24-5.26
#     against 5.57-5.59 ms); at 2^26 it won five turns of six (21.9-22.0
#     against 23.8-24.3) and lost one (24.48 against 24.27), and up to 2^22
#     it lost (2^22: 1.276-1.284 against 1.269-1.277). So the rule gives it
#     the sizes around 2^24 alone, and torch.sort the rest.
ROUTE_TABLE: dict = {
    "keys": [(1 << 23, "tiled"), (float("inf"), "radix_tiled")],
    "kv": [(1 << 23, "tiled"), (float("inf"), "radix_tiled")],
    "keys64": [(1 << 25, "tiled"), (float("inf"), "radix_tiled")],
    "kv64": [(1 << 23, "tiled"), (float("inf"), "radix_tiled")],
    "kv_unstable": [(1 << 23, "tiled"), (float("inf"), "radix_tiled")],
    "argsort": [(1 << 25, "tiled"), (float("inf"), "radix_tiled")],
    "dist_local": [((1 << 22) - 1, "tiled"), (float("inf"), "merge")],
    "dist_local64": [(1 << 23, "tiled"), (1 << 25, "merge"), (float("inf"), "tiled")],
}
# 64-bit keys have no packed path, so unstable kv is the stable carry there
ROUTE_TABLE["kv_unstable64"] = ROUTE_TABLE["kv64"]


def route_for(op: str, n: int, wide: bool = False) -> str:
    """Default engine for ``op`` (a ROUTE_TABLE operation without its "64")
    at size ``n`` on a CUDA device; ``wide`` selects the 64-bit-key rows."""
    for max_n, engine in ROUTE_TABLE.get(op + ("64" if wide else ""), []):
        if n <= max_n:
            return engine
    return "tiled"
