"""Public sort API: ``sort``, ``sort_pairs``, ``argsort``, ``sort_segments``.

Port of ``vkradixsort_tpu/ops/dispatch.py``. The engines so far:

  engine         what runs
  -------------  ------------------------------------------------------------
  "tiled"        ``torch.sort(stable=True)`` in sign-flipped int space
                 (ops/tiled.py); every device, every dtype
  "merge"        tile-sort + merge-path ladder (ops/merge.py)
  "radix_tiled"  LSD radix passes (ops/radix_tiled.py): one histogram of
                 every pass's digits, then per pass one kernel that ranks,
                 looks back for its tiles' bases and moves keys and
                 payload; any set of 1-, 2-, 4- and 8-byte payloads (one
                 rides the passes; a wider set rides as u32 positions,
                 made by the first pass, then one gather kernel moves every
                 column, ops/gather.py), and argsort on the same positions,
                 n < 2^31
  "fused"        the whole LSD radix sort in one launch of one block
                 (ops/fused.py); N <= ``SortConfig.fused_max_n``, at most
                 one payload of 4 or 8 bytes
  "reference"    the plain radix sort (ops/reference.py); any payloads
  "bitonic"      the whole padded array through one bitonic network
                 (ops/bitonic.py); N up to a size contract, any payloads
  "samplesort"   row sorts, splitters, run placement, bucket sorts
                 (ops/samplesort.py); at most one payload

2-D keys (``sort_segments``, and ``sort``, ``sort_pairs`` and ``argsort``
given 2-D keys) sort every row on its own, on one of two engines:

  engine         what runs
  -------------  ------------------------------------------------------------
  "tiled"        ``torch.sort(dim=1, stable=True)`` in sign-flipped int space,
                 then one gather a payload (ops/segsort.py); any payloads
  "radix_tiled"  the row-segmented onesweep (``radix_tiled.sort_rows``): one
                 histogram of every row's digits, then per pass one kernel
                 whose tiles never cross a row; no payload or one that
                 rides with its key, and argsort on row-local positions made
                 by the first pass; rows x width < 2^31

The merge, radix_tiled, fused, bitonic and samplesort engines launch
hand-written CUDA kernels on CUDA tensors and run their plain versions on
CPU tensors. Each engine's entry (:data:`SORTS`) holds its own rules: what
payloads it moves, its size contract, its key order. ``backend=None``
decides from the tensor, up front: CUDA
tensors follow ``engine/config.ROUTE_TABLE`` (tiled or radix_tiled, by
operation, payload set, key width and size, as measured on the H100; 2-D
keys by their row width, rows ``rows`` and ``rows64``); CPU tensors take
"tiled". No default route leads to merge, fused, reference,
bitonic or samplesort. Every entry point is stable,
``sort_pairs(stable=False)`` too, and bitwise-exact against the JAX
package's stable results on the same inputs.

Keys reach the engines in the unsigned order they sort, and go back after
them, through ``ops/keyorder.py``: for keys of 4 and 8 bytes one
``key_order`` launch each way on the card, none for unsigned keys in
ascending order. ``argsort`` decodes nothing: it does not return the keys.

Each entry point runs in the span ``vkrs/<entry point>``, the engine a
call takes in ``vkrs/engine/<engine>``, and a transform that is not the
identity in ``vkrs/keys/encode`` and ``vkrs/keys/decode``
(``utils/profiling.span``); each call where the dispatcher chose an engine
counts one ``route.<engine>``, 2-D calls too.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.engine.config import DEFAULT_CONFIG, SortConfig, route_for
from vkradixsort_tpu_torch.ops import (
    bitonic,
    fused,
    keyorder,
    merge,
    radix_tiled,
    reference,
    samplesort,
    segsort,
    tiled,
)
from vkradixsort_tpu_torch.ops.common import positions, sortable_dtype
from vkradixsort_tpu_torch.utils import profiling

# Each engine's sort of encoded keys and a payload set, ``(enc, vals, config)
# -> (sorted_keys, sorted_vals_tuple)``; each raises on what it refuses.
SORTS = {
    "tiled": lambda enc, vals, config: tiled.sort_tiled(enc, vals),
    "merge": lambda enc, vals, config: merge.sort_merge(enc, vals, tile=config.tile),
    "radix_tiled": lambda enc, vals, config: radix_tiled.sort_radix_tiled(enc, vals),
    "fused": fused.sort_encoded,
    "reference": reference.sort_encoded,
    "bitonic": bitonic.sort_encoded,
    "samplesort": samplesort.sort_encoded,
}
ENGINES = tuple(SORTS)
# The engines with an argsort of their own, ``enc -> permutation``; the
# others sort the keys carrying their positions as one payload.
ARGSORTS = {"tiled": tiled.argsort_tiled, "radix_tiled": radix_tiled.argsort_radix_tiled}


def _table_op(op: str, vals: tuple, wide: bool) -> str:
    """The ``ROUTE_TABLE`` operation, without its "64", of a call ``op``
    ("kv" or "argsort") with payloads ``vals`` on 32-bit keys, or on 64-bit
    keys if ``wide``: "kv" with no payload reads "keys"; one payload of any
    width keeps "kv"; two 4-byte payloads on 32-bit keys read "kv2"; every
    other set of two or more reads "kvw"."""
    if len(vals) > 1:
        four = all(v.element_size() == 4 for v in vals)
        return "kv2" if not wide and len(vals) == 2 and four else "kvw"
    return "keys" if op == "kv" and not vals else op


def _route(keys: torch.Tensor, backend: str | None, vals: tuple = (), op: str = "kv") -> str:
    """The engine of a call: ``backend`` when given; else "tiled" for CPU
    tensors, and for CUDA tensors the ``ROUTE_TABLE`` row of the call's
    payload set (:func:`_table_op`: "keys", "kv", "kv2", "kvw", "argsort";
    each with its "64" twin for u64-encoded keys) at the call's size. A row
    never sends a call to an engine that refuses it (JAX's rule): what
    radix_tiled refuses (``radix_tiled.accepts``) goes to "tiled"."""
    if backend is not None:
        if backend not in ENGINES:
            raise ValueError(f"unknown backend {backend!r}; pick from {ENGINES}")
        return backend
    if keys.device.type != "cuda":
        return "tiled"
    wide = sortable_dtype(keys.dtype) == torch.uint64
    n = keys.shape[0]
    path = route_for(_table_op(op, vals, wide), n, wide)
    if path == "radix_tiled" and not radix_tiled.accepts(n, vals):
        return "tiled"
    return path


def _route_rows(keys: torch.Tensor, vals: tuple = ()) -> str:
    """The engine of a 2-D call: "tiled" (``torch.sort`` along the rows) for
    CPU tensors; for CUDA tensors the ``ROUTE_TABLE`` row ``rows`` (``rows64``
    for u64-encoded keys) at the row width, where "radix_tiled" takes the
    call (``radix_tiled.accepts_rows``: no payload or one that rides its
    key) and "tiled" otherwise."""
    if keys.device.type != "cuda":
        return "tiled"
    wide = sortable_dtype(keys.dtype) == torch.uint64
    path = route_for("rows", keys.shape[1], wide)
    if path == "radix_tiled" and not radix_tiled.accepts_rows(keys.numel(), 8 if wide else 4,
                                                              vals):
        return "tiled"
    return path


def _encode(keys: torch.Tensor, descending: bool) -> torch.Tensor:
    """The keys in the order the engines sort (``keyorder.encode``: one
    ``key_order`` launch on the card for keys of 4 and 8 bytes), in the span
    ``vkrs/keys/encode`` where that is not the identity."""
    if keyorder.identity(keys.dtype, descending):
        return keys
    with profiling.span("vkrs/keys/encode"):
        return keyorder.encode(keys, descending)


def _decode(out_enc: torch.Tensor, dtype: torch.dtype, descending: bool) -> torch.Tensor:
    """The engine's sorted keys back to ``dtype``, in place (the dispatcher
    owns them), in the span ``vkrs/keys/decode`` where that is not the
    identity."""
    if keyorder.identity(dtype, descending):
        return out_enc.view(dtype)
    with profiling.span("vkrs/keys/decode"):
        return keyorder.decode(out_enc, dtype, descending, in_place=True)


def _sort_encoded(enc, vals, config, path):
    with profiling.span("vkrs/engine/" + path):
        return SORTS[path](enc, vals, config)


def _sort_keys(keys, vals, config, path, descending):
    out_k, out_vs = _sort_encoded(_encode(keys, descending), vals, config, path)
    return _decode(out_k, keys.dtype, descending), out_vs


def sort(
    keys: torch.Tensor,
    *,
    config: SortConfig = DEFAULT_CONFIG,
    backend: str | None = None,
    descending: bool = False,
) -> torch.Tensor:
    """Stable ascending (or descending) sort of a 1-D key tensor.

    Float keys sort by IEEE-754 total order (``-0.0`` strictly before
    ``+0.0``; NaNs placed by their sign bit). ``descending=True`` reverses the
    key order and keeps ties in input order: the encoded keys are
    bit-complemented before and after an ascending stable sort. 2-D keys
    sort every row (:func:`sort_segments`).
    """
    with profiling.span("vkrs/sort"):
        if keys.dim() == 2:
            if backend is not None:
                raise ValueError("2-D keys route to sort_segments; backend= does not apply")
            return sort_segments(keys, descending=descending)
        if keys.dim() != 1:
            raise ValueError(f"sort expects 1-D or 2-D keys, got shape {tuple(keys.shape)}")
        path = _route(keys, backend)
        profiling.count("route." + path)
        out, _ = _sort_keys(keys, (), config, path, descending)
        return out


def sort_pairs(
    keys: torch.Tensor,
    values,
    *,
    config: SortConfig = DEFAULT_CONFIG,
    backend: str | None = None,
    descending: bool = False,
    stable: bool = True,
):
    """Stable key-value sort; values ride along with their keys.

    ``values`` may be one tensor or a tuple/list of tensors (all length-N):
    every payload is permuted by the same stable key order in one sort.
    Returns ``(sorted_keys, values_like)`` with the container type kept.

    ``stable=False`` relaxes the order of equal keys, and the call takes the
    route of the stable one: every engine runs its stable pipeline, also a
    valid unstable answer. The port's merge has no tie plane to drop, unlike
    the JAX engine's. The JAX package's packed path for "tiled" (32-bit key
    and 4-byte payload in one 64-bit sort key) lost to the stable carry at
    every size on the H100, so it is not ported (PERF.md section 5).
    """
    with profiling.span("vkrs/sort_pairs"):
        multi = isinstance(values, (tuple, list))
        vals = tuple(values) if multi else (values,)
        if keys.dim() == 2:
            if backend is not None:
                raise ValueError("2-D keys route to sort_segments; backend= does not apply")
            return sort_segments(keys, values, descending=descending)
        if keys.dim() != 1 or any(v.shape[:1] != keys.shape[:1] or v.dim() != 1 for v in vals):
            raise ValueError(
                "sort_pairs expects matching 1-D tensors, got "
                f"{tuple(keys.shape)} / {[tuple(v.shape) for v in vals]}"
            )
        if any(v.device != keys.device for v in vals):
            raise ValueError("keys and values must lie on one device")
        path = _route(keys, backend, vals)
        profiling.count("route." + path)
        out_k, out_vs = _sort_keys(keys, vals, config, path, descending)
        return out_k, (type(values)(out_vs) if multi else out_vs[0])


def argsort(
    keys: torch.Tensor,
    *,
    config: SortConfig = DEFAULT_CONFIG,
    backend: str | None = None,
    descending: bool = False,
) -> torch.Tensor:
    """Stable argsort indices (uint32 for N < 2^32, else uint64).

    Follows ``ROUTE_TABLE["argsort"]`` (``"argsort64"`` for 64-bit keys).
    An engine in :data:`ARGSORTS` gives the permutation itself: on "tiled"
    ``torch.sort``'s own (``tiled.argsort_tiled``), on "radix_tiled" the
    onesweep sort of the keys with the u32 positions its first pass makes
    (``radix_tiled.argsort_radix_tiled``: no positions tensor). Every other
    engine sorts the keys with their positions (``common.positions``) as
    one payload, and leaves the sorted keys encoded. On merge that is the
    plane set the JAX package's ``merge.argsort_merge`` moves (key planes
    and positions), so it needs no twin of its own. 2-D keys give each
    row's permutation (uint32 row-local positions below 2^32), routed by
    the row width (``ROUTE_TABLE["rows"]``, ``"rows64"``): on "radix_tiled"
    ``radix_tiled.argsort_rows``, whose first pass makes the positions; on
    "tiled", CPU tensors and narrower rows, ``torch.sort(dim=1)``'s own.
    """
    with profiling.span("vkrs/argsort"):
        if keys.dim() == 2:
            if backend is not None:
                raise ValueError("2-D keys route to sort_segments; backend= does not apply")
            path = _route_rows(keys)
            profiling.count("route." + path)
            enc = _encode(keys, descending)
            with profiling.span("vkrs/engine/" + path):
                if path == "tiled":
                    return segsort.argsort_segments(enc)
                return radix_tiled.argsort_rows(enc)
        if keys.dim() != 1:
            raise ValueError(f"argsort expects 1-D or 2-D keys, got shape {tuple(keys.shape)}")
        path = _route(keys, backend, op="argsort")
        profiling.count("route." + path)
        enc = _encode(keys, descending)
        if path in ARGSORTS:
            with profiling.span("vkrs/engine/" + path):
                return ARGSORTS[path](enc)
        _, (perm,) = _sort_encoded(enc, (positions(keys.shape[0], keys.device),), config, path)
        return perm


def sort_segments(keys: torch.Tensor, values=None, *, descending: bool = False):
    """Sort every row of a 2-D tensor independently (batched segment sort),
    stably: ties in input order, ``descending=True`` too.

    ``values`` may be one 2-D tensor or a tuple/list of them. Returns
    ``sorted_keys`` or ``(sorted_keys, permuted_values)`` with the container
    type kept. CUDA tensors follow ``ROUTE_TABLE["rows"]`` (``"rows64"`` for
    64-bit keys) by the row width: "radix_tiled", the row-segmented
    onesweep (``radix_tiled.sort_rows``), where it was measured faster and
    the call carries no payload or one that rides its key; "tiled",
    ``torch.sort`` along the rows with one gather a payload
    (``segsort.sort_segments``), at narrower rows, for every other payload
    set, and for CPU tensors. Counts one ``route.<engine>``.
    """
    with profiling.span("vkrs/sort_segments"):
        if keys.dim() != 2:
            raise ValueError(f"sort_segments expects 2-D keys, got {tuple(keys.shape)}")
        multi = isinstance(values, (tuple, list))
        vals = () if values is None else (tuple(values) if multi else (values,))
        if any(v.shape != keys.shape for v in vals):
            raise ValueError("sort_segments payloads must have the keys' shape")
        if any(v.device != keys.device for v in vals):
            raise ValueError("keys and values must lie on one device")
        path = _route_rows(keys, vals)
        profiling.count("route." + path)
        enc = _encode(keys, descending)
        with profiling.span("vkrs/engine/" + path):
            if path == "tiled":
                out_enc, out_vs = segsort.sort_segments(enc, vals)
            else:
                out_enc, out_v = radix_tiled.sort_rows(enc, vals[0] if vals else None)
                out_vs = (out_v,) if vals else ()
        out_k = _decode(out_enc, keys.dtype, descending)
        if values is None:
            return out_k
        return out_k, (type(values)(out_vs) if multi else out_vs[0])
