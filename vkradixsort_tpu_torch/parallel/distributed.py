"""The distributed sort: a sample sort over the shards of a mesh.

Port of ``vkradixsort_tpu/parallel/distributed.py``. The algorithm is the
JAX package's, step for step, so that both give the same shards, counts and
overflow flags for the same input and P:

  1. each shard carries its elements' global positions (gidx) and is padded
     to a multiple of P * chunks with (key sentinel, gidx max) pairs; one
     all-to-all deals every shard's P blocks round-robin over the mesh (the
     block interleave), so that no value range stays on one shard;
  2. each shard sorts its chunks by (key, gidx), a total order that is the
     stable order of the input;
  3. every shard contributes an oversampled set of splitter candidates; the
     gathered sample's P - 1 quantiles are the global splitters;
  4. each sorted chunk is cut at the splitters into P buckets, placed in a
     (P, cap) send buffer padded with (sentinel, gidx max, 0), and
     exchanged by one all-to-all (per chunk: ``overlap_chunks`` > 1 sorts
     chunk k while chunk k - 1's buckets are in flight);
  5. each shard sorts everything it received by (key, gidx): shard d then
     holds the d-th range of the stable global order in its first
     ``counts[d]`` slots.

The body is written once, as steps over the list of shards this process
holds, with the mesh's collectives between them (``parallel/mesh.py``): a
``LocalMesh`` holds all P shards in one process (several may share a card),
a ``GroupMesh`` one shard per rank of a process group. Nothing in
``sort_sharded`` waits on the device: counts and overflow flags stay
tensors. ``gather_sorted`` and ``sort_distributed`` read them on the host.

On a 2-D mesh (``LocalMesh2D``, ``GroupMesh2D``) the sort runs along one
named axis (``axis_name``) and is replicated over the other, as the JAX
package's ``shard_map`` with ``P(axis_name)`` on a 2-D mesh is: the body
runs unchanged over each 1-D mesh along that axis that this process holds,
one after another, and P is the size of that axis.

The local sorts run on one of two engines (``local_engine``): "xla", the
library sort (``torch.sort``, stable, on the packed (key, gidx) or on each
in turn, payloads gathered), or "merge", the merge engine's tile-sort and
merge-path kernels with gidx as a compare plane (``ops/merge.py``). The
final sort of what a shard received runs on the same engine.

Each step of the body runs in a span (``utils/profiling.span``) named
``vkrs/sort_sharded/<step>`` (:data:`STEPS`), so a profiler trace gives the
device time by step.
"""

from __future__ import annotations

import torch

from vkradixsort_tpu_torch.engine.config import route_for
from vkradixsort_tpu_torch.ops import keyorder, merge
from vkradixsort_tpu_torch.ops.common import (
    _MIN32,
    bits_view,
    composite_searchsorted,
    round_up,
    take,
)
from vkradixsort_tpu_torch.ops.segsort import from_signed_order, to_signed_order
from vkradixsort_tpu_torch.parallel.mesh import GroupMesh, GroupMesh2D, LocalMesh, LocalMesh2D
from vkradixsort_tpu_torch.utils import profiling

__all__ = ["sort_sharded", "gather_sorted", "sort_distributed", "LocalMesh", "GroupMesh",
           "LocalMesh2D", "GroupMesh2D"]

LOCAL_ENGINES = ("xla", "merge")
STEPS = ("interleave", "local sort", "splitters", "send build", "exchange", "final sort")


def _step(name: str):
    return profiling.span("vkrs/sort_sharded/" + name)


def _quantile_positions(n: int, m: int, device) -> torch.Tensor:
    """m regular sample positions (bucket midpoints) in [0, n)."""
    pos = torch.arange(m, dtype=torch.int64, device=device) * n // m + n // (2 * m)
    return pos.clamp(max=n - 1)


def _idx_sort(keys: torch.Tensor, gidx: torch.Tensor, values: list):
    """Sort by (key, gidx), the library way: keys are signed-order ints.
    A 32-bit key and an int32 gidx pack into one int64; otherwise gidx is
    sorted first and the key second, both stably. Payloads are gathered."""
    if keys.element_size() == 4 and gidx.dtype == torch.int32:
        packed = (keys.to(torch.int64) << 32) | (gidx.to(torch.int64) - _MIN32)
        _, perm = torch.sort(packed, stable=True)
    else:
        _, perm = torch.sort(gidx, stable=True)
        perm = perm[torch.sort(keys[perm], stable=True)[1]]
    return keys[perm], gidx[perm], [take(v, perm) for v in values]


def _idx_sort_merge(keys: torch.Tensor, gidx: torch.Tensor, values: list):
    """The same (key, gidx) order on the merge engine: the key's int32
    planes (one, or (hi, lo) for 64-bit keys) and gidx are the compare
    planes, the payloads ride as ``merge.carry_planes`` lays them out (as
    carry planes, or past ``merge.MAX_KERNEL_CARRY`` as one local index and
    a gather each after the sort)."""
    if keys.element_size() == 4:
        kp = [keys]
    else:
        kp = [(keys >> 32).to(torch.int32), keys.to(torch.int32) ^ _MIN32]
    carry, unpack = merge.carry_planes(values, keys.shape[0], keys.device)
    planes = [p.contiguous() for p in kp + [gidx] + carry]  # a chunk is a strided view
    out = merge.sort_merge_planes(planes, len(kp) + 1)
    if len(kp) == 1:
        out_k = out[0]
    else:
        out_k = (out[0].to(torch.int64) << 32) | ((out[1] ^ _MIN32).to(torch.int64) & 0xFFFFFFFF)
    nk = len(kp)
    return out_k, out[nk], unpack(out[nk + 1:])


def _pick_local_engine(local_engine, gdt, vals, n_chunk: int, nck: int, device) -> str:
    """The engine of the shard-local sorts.

    The merge engine takes int32 position carries and 4-byte payloads; it
    has no size bound (its offsets are 64-bit), so unlike the JAX package's
    there is no split envelope to check. ``None`` consults
    ``ROUTE_TABLE["dist_local"]`` (``"dist_local64"`` for 64-bit keys, nck
    2) at the per-shard chunk size, on a CUDA device and inside that
    envelope; everything else runs the library sort ("xla"). An explicit
    "merge" is honored on any device (plain versions on the CPU)."""
    outside = gdt != torch.int32 or any(v.element_size() != 4 for v in vals)
    if local_engine is not None:
        if local_engine not in LOCAL_ENGINES:
            raise ValueError(f"local_engine must be 'xla' or 'merge', got {local_engine!r}")
        if local_engine == "merge" and outside:
            raise ValueError(
                "local_engine='merge' needs int32 position carries and 4-byte payload "
                "planes; use 'xla' here")
        return local_engine
    if outside or device.type != "cuda":
        return "xla"
    return "merge" if route_for("dist_local", n_chunk, wide=nck == 2) == "merge" else "xla"


def _build_send(k_sorted, g_sorted, vs, splitters, splitters_g, cap: int, n_real, gmax: int,
                sentinel: int):
    """Cut a sorted chunk at the splitters into P contiguous buckets and lay
    them out in sentinel-padded (P, cap) send buffers: one gather per plane,
    the buckets' starts on the device. ``vs`` has the gidx carry first (fill
    gidx max, so padding sorts after every real pair, even one whose key
    equals the sentinel), then the payloads (fill 0). ``n_real`` bounds the
    chunk's valid prefix: alignment pads sort to its tail and are never
    sent. Returns (send_k, send_vs, lens, overflow)."""
    n = k_sorted.shape[0]
    dev = k_sorted.device
    bounds = composite_searchsorted(k_sorted, g_sorted, splitters, splitters_g)
    bounds = torch.minimum(bounds, n_real)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    starts = torch.cat([zero, bounds])
    lens = torch.cat([bounds, n_real.view(1)]) - starts
    overflow = (lens > cap).any()
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    idx = (starts.to(torch.int64)[:, None] + j).clamp(max=n - 1)
    valid = j < lens[:, None]
    send_k = torch.where(valid, k_sorted[idx], sentinel)
    fills = [gmax] + [0] * (len(vs) - 1)
    send_vs = [torch.where(valid, bits_view(v)[idx], f).view(v.dtype) for v, f in zip(vs, fills)]
    return send_k, send_vs, lens, overflow


def _partition(mesh, keys: list, values: list, *, cap: int, oversample: int, chunks: int, gdt,
               local_sort):
    """The per-shard body over this process's shards: ``keys[i]`` the
    signed-order keys of local shard i, ``values[i]`` its payloads. Returns
    per local shard (keys, count of shape (1,), overflow of shape (1,),
    payloads), keys and payloads padded to chunks * P * cap."""
    P = mesh.size
    C = chunks
    n = keys[0].shape[0]
    L = len(keys)
    dev = [k.device for k in keys]
    gmax = torch.iinfo(gdt).max
    sentinel = torch.iinfo(keys[0].dtype).max

    # 0a. global positions, carried so stability survives the shuffles; the
    # alignment pads to the P * chunks grain are (sentinel, gidx max, 0)
    gidx = [sid * n + torch.arange(n, dtype=gdt, device=d)
            for sid, d in zip(mesh.shard_ids, dev)]
    npl = round_up(n, P * C)
    if npl != n:
        def pad(x, fill):
            return torch.cat([x, torch.full((npl - n,), fill, dtype=x.dtype, device=x.device)])

        keys = [pad(k, sentinel) for k in keys]
        gidx = [pad(g, gmax) for g in gidx]
        values = [[pad(bits_view(v), 0).view(v.dtype) for v in vs] for vs in values]

    # 0b. block interleave: shard q's block p goes to shard p, so no value
    # range stays on one shard (a descending input would else send a whole
    # shard into one bucket)
    def interleave(xs):
        return [y.reshape(-1) for y in mesh.all_to_all([x.reshape(P, npl // P) for x in xs])]

    with _step("interleave"):
        keys = interleave(keys)
        gidx = interleave(gidx)
        nv = len(values[0])
        vals_t = [interleave([vs[j] for vs in values]) for j in range(nv)]
        values = [[vals_t[j][i] for j in range(nv)] for i in range(L)]

    n_chunk = npl // C

    def chunk(x, c):
        return x.view(n_chunk, C)[:, c] if C > 1 else x

    def sort_chunks(c):
        out = []
        with _step("local sort"):
            for i in range(L):
                kc, gc, vc = local_sort(chunk(keys[i], c), chunk(gidx[i], c),
                                        [chunk(v, c) for v in values[i]])
                n_real = (n_chunk - (gc == gmax).sum()).to(torch.int32)
                out.append((kc, gc, [gc] + vc, n_real))
        return out

    sorted0 = sort_chunks(0)

    # splitter candidates: at C = 1 the exact quantiles of the sorted shard;
    # at C > 1 half from sorted chunk 0, the rest raw strided samples of
    # every other chunk (a key pattern periodic in the stride C would skew
    # the other chunks' buckets away from a chunk-0 estimate)
    num_s = min(oversample * P, n_chunk)
    cand_k, cand_g = [], []
    with _step("splitters"):
        for i in range(L):
            k0, g0 = sorted0[i][0], sorted0[i][1]
            if C == 1:
                pos = _quantile_positions(n_chunk, num_s, dev[i])
                cand_k.append(k0[pos])
                cand_g.append(g0[pos])
            else:
                half = max(num_s // 2, 1)
                pos0 = _quantile_positions(n_chunk, half, dev[i])
                m = max((num_s - half) // (C - 1), 1)
                raw = _quantile_positions(n_chunk, m, dev[i])[:, None] * C + torch.arange(
                    1, C, device=dev[i])  # element c of row r of the (n_chunk, C) view
                raw = raw.t().reshape(-1)  # chunk by chunk
                cand_k.append(torch.cat([k0[pos0], keys[i][raw]]))
                cand_g.append(torch.cat([g0[pos0], gidx[i][raw]]))
        all_k = mesh.all_gather(cand_k)
        all_g = mesh.all_gather(cand_g)
        splitters = []
        for i, (ak, ag) in enumerate(zip(all_k, all_g)):
            if i and ak is all_k[i - 1] and ag is all_g[i - 1]:  # shards that share a device
                splitters.append(splitters[-1])
                continue
            sk, sg, _ = _idx_sort(ak.reshape(-1), ag.reshape(-1), [])
            step = max(sk.shape[0] // P, 1)
            splitters.append((sk[step::step][: P - 1], sg[step::step][: P - 1]))

    # the pipeline: chunk c's buckets are built while chunk c - 1's are in
    # flight; one all-to-all per plane and chunk
    def build(srt):
        with _step("send build"):
            return [_build_send(kc, gc, vsc, splitters[i][0], splitters[i][1], cap, nrc, gmax,
                                sentinel) for i, (kc, gc, vsc, nrc) in enumerate(srt)]

    def exchange(sends):
        with _step("exchange"):
            rk = mesh.all_to_all([s[0] for s in sends])
            rv = [mesh.all_to_all([s[1][j] for s in sends]) for j in range(nv + 1)]
            return [(rk[i], [r[i] for r in rv]) for i in range(L)]

    prev = build(sorted0)
    overflow = [p[3] for p in prev]
    lens_total = [p[2] for p in prev]
    received = []
    for c in range(1, C):
        srt = sort_chunks(c)
        received.append(exchange(prev))
        prev = build(srt)
        overflow = [o | p[3] for o, p in zip(overflow, prev)]
        lens_total = [t + p[2] for t, p in zip(lens_total, prev)]
    received.append(exchange(prev))

    # the final sort of everything received; the per-chunk lens sum before
    # the one exchange that tells each shard its count
    with _step("exchange"):
        counts = [r.sum(dtype=torch.int32).view(1)
                  for r in mesh.all_to_all([t.view(P, 1) for t in lens_total])]
    out = []
    with _step("final sort"):
        for i in range(L):
            all_k = torch.cat([r[i][0].reshape(-1) for r in received])
            all_g = torch.cat([r[i][1][0].reshape(-1) for r in received])
            all_v = [torch.cat([r[i][1][1 + j].reshape(-1) for r in received])
                     for j in range(nv)]
            ok, _, ov = local_sort(all_k, all_g, all_v)
            out.append((ok, counts[i], overflow[i].view(1), ov))
    return out


def _as_shards(mesh, x) -> list:
    return mesh.shard(x) if isinstance(x, torch.Tensor) else list(x)


def _axis_meshes(mesh, axis_name) -> list:
    """The 1-D meshes the body runs over in this process: a 1-D mesh itself
    (``axis_name`` None), or those along ``axis_name`` of a 2-D mesh that
    this process holds (every row or column of a ``LocalMesh2D``, this
    rank's one of a ``GroupMesh2D``)."""
    if isinstance(mesh, (LocalMesh, GroupMesh)):
        if axis_name is not None:
            raise ValueError(f"a 1-D mesh has no axis names; got axis_name={axis_name!r}")
        return [mesh]
    if axis_name is None:
        raise ValueError(f"a 2-D mesh needs axis_name, one of {mesh.axis_names}")
    lines = mesh.along(axis_name)
    return lines if isinstance(lines, list) else [lines]


def _payloads(shards, values) -> tuple:
    """(several payloads?, the payloads): a list of tensors is one payload's
    shards when the keys come as shards, else several payloads."""
    multi = isinstance(values, tuple) or isinstance(values, list) and (
        not values or not isinstance(values[0], torch.Tensor)
        or isinstance(shards, torch.Tensor))
    return multi, () if values is None else (tuple(values) if multi else (values,))


def sort_sharded(shards, mesh, values=None, *, slack: float = 2.0, oversample: int = 32,
                 descending: bool = False, overlap_chunks: int = 1, gidx_dtype=None,
                 local_engine: str | None = None, axis_name: str | None = None):
    """Distributed stable sort over the shards of ``mesh``.

    ``shards``: the list of this process's shards of the keys, one per
    entry of ``mesh.shard_ids``, all of one length (P of them on a
    ``LocalMesh``, one on a ``GroupMesh``); a ``LocalMesh`` also takes the
    whole 1-D tensor, whose length must divide by P, and a ``GroupMesh``
    this rank's shard as a tensor. ``values``: None, one payload or a tuple
    or list of payloads, each in the form of ``shards`` (a tensor, or a
    list of shards), any dtype.

    Returns ``(padded_keys, counts, overflow[, padded_values])``:
    ``padded_keys`` the list of this process's output shards, local shard i
    holding the ``mesh.shard_ids[i]``-th contiguous range of the globally
    sorted order in its first ``counts[i]`` slots (the rest is padding);
    ``counts`` and ``overflow`` one entry per local shard, on the first
    shard's device. ``padded_values`` follows the container of ``values``:
    one list of shards, or a tuple or list of them. If any overflow flag is
    set (on any rank), a bucket exceeded its capacity and the output is
    truncated: retry with a larger ``slack``/``oversample``, as
    :func:`sort_distributed` does. Equal keys keep their input order;
    ``descending=True`` reverses the key order by the encoded keys' bit
    complement, ties still in input order. Float keys sort in IEEE total
    order. The keys go to that order and back through ``ops/keyorder.py``,
    as the dispatcher's do: one ``key_order`` launch a shard each way on
    the card for keys of 4 and 8 bytes, none for unsigned ascending keys.

    ``overlap_chunks=K > 1`` splits each shard into K strided chunks and
    exchanges chunk k - 1's buckets while chunk k sorts; ``cap`` is then
    per chunk. Global positions carry as int32 below N = 2^31 - 1 and as
    int64 from there; ``gidx_dtype=torch.int64`` opts in. ``local_engine``:
    "xla" (``torch.sort``), "merge" (the merge engine's kernels) or None
    (``ROUTE_TABLE["dist_local"]``; the library sort where it has no row).

    ``axis_name``: None on a 1-D mesh; on a 2-D mesh the axis to sort along
    (required), P its size. A ``LocalMesh2D`` takes the whole 1-D tensor,
    whose length must divide by P, cut into P shards each placed on the
    devices of its index in every replica, or the list of its shards in the
    output's order; a ``GroupMesh2D`` takes this rank's shard. On a
    ``LocalMesh2D`` ``padded_keys`` and ``padded_values`` are replica-major,
    every device keeping its copy: each 1-D mesh's P shards in axis order
    (its rows along the second axis, its columns along the first), one mesh
    after another. ``counts`` and ``overflow`` take the JAX package's global
    shape, (P,): ``counts`` the first replica's (the replicas are bitwise
    equal), ``overflow`` the OR over the replicas, so a retry sees every
    one. ``gather_sorted`` then strips the first replica. A ``GroupMesh2D``
    gives this rank's one shard.
    """
    kw = dict(slack=slack, oversample=oversample, descending=descending,
              overlap_chunks=overlap_chunks, gidx_dtype=gidx_dtype, local_engine=local_engine)
    meshes = _axis_meshes(mesh, axis_name)
    if len(meshes) == 1:
        return _sort_1d(shards, meshes[0], values, **kw)
    # the replicas of a LocalMesh2D, one after another: where they share a
    # card, its peak memory is one replica's working set plus the outputs
    P = meshes[0].size
    if not isinstance(shards, torch.Tensor) and len(shards) != len(meshes) * P:
        raise ValueError(f"this process holds {len(meshes) * P} shards of the mesh, "
                         f"got {len(shards)}")
    multi, payloads = _payloads(shards, values)

    def cut(x, i):
        return meshes[i].shard(x) if isinstance(x, torch.Tensor) else list(x)[i * P:(i + 1) * P]

    res = []
    for i, m in enumerate(meshes):
        vals = None if values is None else (
            type(values)(cut(v, i) for v in payloads) if multi else cut(values, i))
        res.append(_sort_1d(cut(shards, i), m, vals, **kw))
    overflow = res[0][2]
    for r in res[1:]:
        overflow = overflow | r[2].to(overflow.device)
    out = ([s for r in res for s in r[0]], res[0][1], overflow)
    if values is None:
        return out
    if multi:
        return out + (type(values)([s for r in res for s in r[3][j]]
                                   for j in range(len(payloads))),)
    return out + ([s for r in res for s in r[3]],)


def _sort_1d(shards, mesh, values, *, slack, oversample, descending, overlap_chunks,
             gidx_dtype, local_engine):
    """:func:`sort_sharded` over one 1-D mesh."""
    if overlap_chunks < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {overlap_chunks}")
    keys = _as_shards(mesh, shards)
    multi, payloads = _payloads(shards, values)
    pay = [_as_shards(mesh, v) for v in payloads]
    L = len(mesh.shard_ids)
    if len(keys) != L or any(len(p) != L for p in pay):
        raise ValueError(f"this process holds {L} shards of the mesh, got {len(keys)}")
    n = keys[0].shape[0]
    if any(k.shape != (n,) for k in keys) or any(v.shape != (n,) for p in pay for v in p):
        raise ValueError("shards must be 1-D tensors of one length, payloads like their keys")
    P = mesh.size
    total = n * P
    gdt = torch.int64 if gidx_dtype == torch.int64 or total >= (1 << 31) - 1 else torch.int32
    if gidx_dtype not in (None, torch.int32, torch.int64):
        raise ValueError(f"gidx_dtype must be torch.int32 or torch.int64, got {gidx_dtype}")
    dev0 = keys[0].device

    def result(out_k, counts, overflow, out_v):
        if values is None:
            return out_k, counts, overflow
        if multi:
            return out_k, counts, overflow, type(values)(out_v)
        return out_k, counts, overflow, out_v[0]

    if n == 0:  # nothing to exchange: zero counts, no overflow, input passes through
        return result(keys, torch.zeros(L, dtype=torch.int32, device=dev0),
                      torch.zeros(L, dtype=torch.bool, device=dev0), pay)

    key_dtype = keys[0].dtype
    enc = [keyorder.encode(k, descending) for k in keys]
    enc_dtype = enc[0].dtype
    grain = P * overlap_chunks
    n_local_padded = round_up(n, grain)
    cap = int(slack * n_local_padded / (overlap_chunks * P)) + 64
    eng = _pick_local_engine(local_engine, gdt, [p[0] for p in pay],
                             n_local_padded // overlap_chunks,
                             2 if enc_dtype == torch.uint64 else 1, dev0)
    # the body sorts and compares same-width signed ints of the keys' order
    out = _partition(mesh, [to_signed_order(e) for e in enc],
                     [[p[i] for p in pay] for i in range(L)], cap=cap, oversample=oversample,
                     chunks=overlap_chunks, gdt=gdt,
                     local_sort=_idx_sort_merge if eng == "merge" else _idx_sort)
    out_k = []
    for ok, *_ in out:
        out_k.append(keyorder.decode(from_signed_order(ok, enc_dtype), key_dtype, descending))
    counts = torch.cat([o[1].to(dev0) for o in out])
    overflow = torch.cat([o[2].to(dev0) for o in out])
    out_v = [[o[3][j] for o in out] for j in range(len(pay))]
    return result(out_k, counts, overflow, out_v)


def _gathered(mesh, shards: list) -> list:
    """Every shard of the mesh in shard order: all-gathered to every rank of
    a ``GroupMesh``, as they are on a ``LocalMesh``."""
    if isinstance(mesh, GroupMesh):
        return list(mesh.all_gather(shards)[0].unbind(0))
    return shards


def gather_sorted(padded_keys, counts, padded_values=None, *, mesh=None,
                  axis_name: str | None = None):
    """Strip the padding of ``sort_sharded``'s output and concatenate the
    shards: the sorted keys (and payloads, in the container of
    ``padded_values``) as one tensor on the first shard's device. Reads the
    counts on the host and strips the first ``len(counts)`` shards: every
    shard of a 1-D ``LocalMesh``'s output, the first replica of a
    ``LocalMesh2D``'s (its counts have one entry per shard of one replica),
    the JAX package's answer in both. With a ``GroupMesh`` (pass it as
    ``mesh``) every rank receives the whole sorted array; with a 2-D mesh
    and the ``axis_name`` of the sort, the same over its ``GroupMesh2D``
    row or column (a ``LocalMesh2D`` needs neither). Without ``mesh``, a
    one-shard output in a process group of more than one rank raises
    ``ValueError``: it may be this rank's shard of a process-group mesh,
    whose layout only the mesh knows."""
    if mesh is not None:
        mesh = _axis_meshes(mesh, axis_name)[0]
    elif axis_name is not None:
        raise ValueError("axis_name needs the mesh the output was sorted on")
    elif len(padded_keys) == 1 and _world_size() > 1:
        raise ValueError("in a process group of more than one rank, a one-shard output may be "
                         "this rank's shard of a GroupMesh or GroupMesh2D: pass mesh= (and "
                         "axis_name= on a 2-D mesh) so every rank gathers the whole array")
    if isinstance(mesh, GroupMesh):
        counts = mesh.all_gather([counts])[0].reshape(-1)
    cs = counts.tolist()
    dev0 = padded_keys[0].device

    def strip(shards):
        shards = _gathered(mesh, list(shards)[:len(cs)])
        return torch.cat([bits_view(s.to(dev0))[:c] for s, c in zip(shards, cs)]).view(
            shards[0].dtype)

    out_k = strip(padded_keys)
    if padded_values is None:
        return out_k
    if isinstance(padded_values, tuple) or (
            padded_values and not isinstance(padded_values[0], torch.Tensor)):
        return out_k, type(padded_values)(strip(pv) for pv in padded_values)
    return out_k, strip(padded_values)


def _world_size() -> int:
    """Ranks of the default process group; 1 where there is none."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def sort_distributed(shards, mesh, values=None, *, slack: float = 2.0, oversample: int = 32,
                     descending: bool = False, overlap_chunks: int = 1, gidx_dtype=None,
                     local_engine: str | None = None, axis_name: str | None = None):
    """:func:`sort_sharded`, its overflow flags read on the host (every
    replica's, every rank's), retried with doubled ``slack`` (up to P) and
    ``oversample`` (up to 256) until nothing overflows, then
    :func:`gather_sorted`. At ``slack >= P`` a bucket holds a whole shard,
    so the loop ends. P is the size of ``axis_name`` on a 2-D mesh. Returns
    the sorted keys, or ``(keys, values_like)``."""
    P = _axis_meshes(mesh, axis_name)[0].size
    while True:
        res = sort_sharded(shards, mesh, values, slack=slack, oversample=oversample,
                           descending=descending, overlap_chunks=overlap_chunks,
                           gidx_dtype=gidx_dtype, local_engine=local_engine,
                           axis_name=axis_name)
        flags = res[2]
        if isinstance(mesh, GroupMesh):
            flags = mesh.all_gather([flags])[0]
        elif isinstance(mesh, GroupMesh2D):  # every rank retries, or none does
            flags = GroupMesh(device=mesh.device).all_gather([flags])[0]
        if not bool(flags.any()):
            return gather_sorted(res[0], res[1], None if values is None else res[3], mesh=mesh,
                                 axis_name=axis_name)
        if slack >= P:
            raise AssertionError("overflow at slack >= P cannot happen")
        slack = min(slack * 2.0, float(P))
        oversample = min(oversample * 2, 256)
