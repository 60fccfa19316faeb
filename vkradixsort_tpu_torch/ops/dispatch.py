"""Public sort API: ``sort``, ``sort_pairs``, ``argsort``, ``sort_segments``.

Port of ``vkradixsort_tpu/ops/dispatch.py``. The engines so far:

  engine         what runs
  -------------  ------------------------------------------------------------
  "tiled"        ``torch.sort(stable=True)`` in sign-flipped int space
                 (ops/tiled.py); every device, every dtype
  "merge"        tile-sort + merge-path ladder (ops/merge.py)
  "radix_tiled"  LSD radix passes (ops/radix_tiled.py): on CUDA tensors
                 one histogram of every pass's digits, then per pass one
                 kernel that ranks, looks back for its tiles' bases and
                 moves keys and payload; at most one payload, n < 2^31
  "fused"        the whole LSD radix sort in one launch of one block
                 (ops/fused.py); N <= ``SortConfig.fused_max_n``, at most
                 one payload of 4 or 8 bytes
  "reference"    the plain radix sort (ops/reference.py); any payloads
  "bitonic"      the whole padded array through one bitonic network
                 (ops/bitonic.py); N up to a size contract, any payloads
  "samplesort"   row sorts, splitters, run placement, bucket sorts
                 (ops/samplesort.py); at most one payload

The merge, radix_tiled, fused, bitonic and samplesort engines launch
hand-written CUDA kernels on CUDA tensors and run their plain versions on
CPU tensors. ``backend=None`` decides from the tensor, up front: CUDA
tensors follow ``engine/config.ROUTE_TABLE`` (tiled or radix_tiled, by
operation, key width and size, as measured on the H100); CPU tensors take
"tiled". No default route leads to merge, fused, reference, bitonic or
samplesort. Every entry point is stable, ``sort_pairs(stable=False)`` too,
and bitwise-exact against the JAX package's stable results on the same
inputs.

Each entry point runs in the span ``vkrs/<entry point>`` and the engine a
call takes in ``vkrs/engine/<engine>`` (``utils/profiling.span``); each
call where the dispatcher chose an engine counts one ``route.<engine>``.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.engine.config import DEFAULT_CONFIG, SortConfig, route_for
from vkradixsort_tpu_torch.ops import (
    bitonic,
    fused,
    merge,
    radix_tiled,
    reference,
    samplesort,
    segsort,
    tiled,
)
from vkradixsort_tpu_torch.ops.common import (
    complement,
    decode_keys,
    encode_keys,
    positions,
    sortable_dtype,
    take,
)
from vkradixsort_tpu_torch.utils import profiling

ENGINES = ("tiled", "merge", "radix_tiled", "fused", "reference", "bitonic", "samplesort")


def _route(keys: torch.Tensor, backend: str | None, vals: tuple = (), op: str = "kv") -> str:
    """The engine of a call: ``backend`` when given; else "tiled" for CPU
    tensors, and for CUDA tensors the ``ROUTE_TABLE`` row of ``op`` at the
    call's size: "kv" reads "keys", "kv" or "kv2" by the number of 4-byte
    payloads; "argsort"; "kv_unstable" (one payload); each with its "64"
    twin for u64-encoded keys. Other payload sets take "tiled": the rows
    were measured for at most two 4-byte payloads (merge carries a wider set
    as a local index and a gather a payload, which no row has timed). A row
    never sends a call to an engine that refuses it (JAX's rule):
    radix_tiled takes one payload (argsort's positions are one) and
    n < 2^31."""
    if backend is not None:
        if backend not in ENGINES:
            raise ValueError(f"unknown backend {backend!r}; pick from {ENGINES}")
        return backend
    if keys.device.type != "cuda":
        return "tiled"
    if any(v.element_size() != 4 for v in vals) or len(vals) > merge.MAX_KERNEL_CARRY:
        return "tiled"  # the table's rows are for at most two 4-byte payloads
    if op == "kv":
        op = ("keys", "kv", "kv2")[len(vals)]
    n = keys.shape[0]
    path = route_for(op, n, sortable_dtype(keys.dtype) == torch.uint64)
    if path == "radix_tiled" and (len(vals) > 1 or n >= 1 << 31):
        return "tiled"
    return path


def _sort_encoded(enc: torch.Tensor, vals: tuple, config: SortConfig, path: str):
    """Sort encoded keys (and payloads) on ``path``; returns
    ``(sorted_keys, sorted_vals_tuple)``."""
    if path == "tiled":
        return tiled.sort_tiled(enc, vals)
    if path == "merge":
        return merge.sort_merge(enc, vals, tile=config.tile)
    if path == "radix_tiled":
        _only_one_payload(path, vals)
        out_k, out_v = radix_tiled.sort_radix_tiled(enc, vals[0] if vals else None,
                                                    tile=config.chunk)
        return out_k, (out_v,) if vals else ()
    if path == "fused":
        _only_one_payload(path, vals)
        out_k, out_v = fused.sort_fused(enc, vals[0] if vals else None, config)
        return out_k, (out_v,) if vals else ()
    if path == "reference":
        if len(vals) <= 1:
            out_k, out_v = reference._sort_encoded(enc, vals[0] if vals else None)
            return out_k, (out_v,) if vals else ()
        # several payloads: one sort carrying the positions, then a gather
        out_k, perm = reference._sort_encoded(enc, torch.arange(enc.shape[0], device=enc.device))
        return out_k, tuple(take(v, perm) for v in vals)
    if path == "bitonic":
        # the size contract counts resident int32 planes: key planes (two
        # for 64-bit keys), one per 4 payload bytes, and the position plane
        # that payloads imply (ops/bitonic.max_n)
        kp = 2 if enc.dtype == torch.uint64 else 1
        nplanes = kp + sum(v.element_size() // 4 for v in vals) + (1 if vals else 0)
        max_n = bitonic.max_n(enc.device, nplanes)
        if enc.shape[0] > max_n:
            raise ValueError(
                "bitonic engine holds the whole (padded) array in one network; at "
                f"{nplanes} resident plane(s) this device is bound to ~{max_n:,} keys; "
                "use the 'tiled' or 'merge' engines for larger arrays"
            )
        out_s, out_v = bitonic.bitonic_sort_block(segsort.to_signed_order(enc), vals,
                                                  stable=bool(vals))
        return segsort.from_signed_order(out_s, enc.dtype), tuple(out_v)
    if path == "samplesort":
        _only_one_payload(path, vals)
        grain = {} if config.tile is None else dict(tile_target=config.tile,
                                                    bucket_target=config.tile)
        if not vals:
            return samplesort.sort_samplesort(enc, **grain), ()
        out_k, out_v = samplesort.sort_pairs_samplesort(enc, vals[0], **grain)
        return out_k, (out_v,)
    raise ValueError(f"unknown sort path {path!r}")


def _only_one_payload(path: str, vals: tuple) -> None:
    if len(vals) > 1:
        raise NotImplementedError(
            f"engine {path!r} moves a single payload plane; pass one values "
            "tensor, or use the 'tiled'/'merge'/'bitonic'/'reference' engines for "
            "multi-payload sorts"
        )


def _encode(keys: torch.Tensor, descending: bool) -> torch.Tensor:
    enc = encode_keys(keys)
    return complement(enc) if descending else enc


def _sort_encoded_keys(keys, vals, config, path, descending):
    enc = _encode(keys, descending)
    with profiling.span("vkrs/engine/" + path):
        out_k, out_vs = _sort_encoded(enc, vals, config, path)
    if descending:
        out_k = complement(out_k)
    return decode_keys(out_k, keys.dtype), out_vs


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
        out, _ = _sort_encoded_keys(keys, (), config, path, descending)
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

    ``stable=False`` relaxes the order of equal keys and follows
    ``ROUTE_TABLE["kv_unstable"]`` (``"kv_unstable64"`` for 64-bit keys) for
    one 4-byte payload; every engine then runs its stable pipeline, also a
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
        path = _route(keys, backend, vals,
                      "kv_unstable" if not stable and len(vals) == 1 else "kv")
        profiling.count("route." + path)
        out_k, out_vs = _sort_encoded_keys(keys, vals, config, path, descending)
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
    On "tiled" the answer is ``torch.sort``'s own permutation
    (``tiled.argsort_tiled``); every other engine sorts the keys with their
    positions as one payload, as ``sort_pairs(keys, arange)``. On merge that
    is the plane set the JAX package's ``merge.argsort_merge`` moves (key
    planes and positions), so it needs no twin of its own. 2-D keys give
    each row's permutation, from ``torch.sort(dim=1)``.
    """
    with profiling.span("vkrs/argsort"):
        if keys.dim() == 2:
            if backend is not None:
                raise ValueError("2-D keys route to sort_segments; backend= does not apply")
            return segsort.argsort_segments(_encode(keys, descending))
        if keys.dim() != 1:
            raise ValueError(f"argsort expects 1-D or 2-D keys, got shape {tuple(keys.shape)}")
        path = _route(keys, backend, op="argsort")
        profiling.count("route." + path)
        if path == "tiled":
            enc = _encode(keys, descending)
            with profiling.span("vkrs/engine/tiled"):
                return tiled.argsort_tiled(enc)
        idx = positions(keys.shape[0], keys.device)
        _, (perm,) = _sort_encoded_keys(keys, (idx,), config, path, descending)
        return perm


def sort_segments(keys: torch.Tensor, values=None, *, descending: bool = False):
    """Sort every row of a 2-D tensor independently (batched segment sort),
    stably, with ``torch.sort`` along the rows.

    ``values`` may be one 2-D tensor or a tuple/list of them. Returns
    ``sorted_keys`` or ``(sorted_keys, permuted_values)`` with the container
    type kept.
    """
    with profiling.span("vkrs/sort_segments"):
        if keys.dim() != 2:
            raise ValueError(f"sort_segments expects 2-D keys, got {tuple(keys.shape)}")
        multi = isinstance(values, (tuple, list))
        vals = () if values is None else (tuple(values) if multi else (values,))
        if any(v.shape != keys.shape for v in vals):
            raise ValueError("sort_segments payloads must have the keys' shape")
        out_enc, out_vs = segsort.sort_segments(_encode(keys, descending), vals)
        if descending:
            out_enc = complement(out_enc)
        out_k = decode_keys(out_enc, keys.dtype)
        if values is None:
            return out_k
        return out_k, (type(values)(out_vs) if multi else out_vs[0])
