"""The two meshes the distributed sort runs on, with their two collectives.

Port of what ``jax.sharding.Mesh`` and the collectives ``lax.all_gather``
and ``lax.all_to_all`` give the JAX package's ``parallel/distributed.py``.
The sort's body (``parallel/distributed.py``) is written once, as steps over
the list of shards this process holds; between steps it calls the mesh's
collectives, which take and return one tensor per local shard:

  * ``all_gather(xs)``: ``xs[i]`` of shape (m, ...) from every shard; each
    local shard receives the (P, m, ...) stack of all P shards' tensors, in
    shard order;
  * ``all_to_all(xs)``: ``xs[i]`` of shape (P, m, ...), block p bound for
    shard p; each local shard receives the (P, m, ...) stack whose block q
    came from shard q.

Two kinds of mesh:

  * ``LocalMesh(devices)``: one process holds all P shards, shard p on
    ``devices[p]``; a device may repeat, so P logical shards can live on one
    card, as the JAX package runs its distributed tests on 8 logical devices
    of one CPU. Its collectives are copies: a stack, and on one device a
    transpose of the (P, P, m) stack, one copy whatever P is.
  * ``GroupMesh(group, device)``: one shard per rank of a
    ``torch.distributed`` process group, on NCCL between cards or on gloo
    between CPU processes; ``all_to_all_single`` and
    ``all_gather_into_tensor``. ``order`` maps shards to ranks (shard s on
    group rank ``order[s]``), which ``multihost.global_mesh_1d`` sets
    host-major.

Two 2-D meshes, the counterparts of ``jax.sharding.Mesh`` over a 2-D grid
of devices with two axis names: a sort runs along one named axis and is
replicated over the other. Neither has collectives of its own;
``along(axis_name)`` gives the 1-D meshes of that axis, and the sort's body
runs over them unchanged:

  * ``LocalMesh2D(devices_2d, axis_names)``: an R x C grid held by this
    process (a device may repeat); along the second axis the R rows, along
    the first the C columns, each a ``LocalMesh``;
  * ``GroupMesh2D(shape, axis_names, device, order)``: one position per rank
    of the default group, position (r, c) on rank ``order[r * C + c]``; one
    process group per row and per column, and ``along`` gives this rank's
    row or column as a ``GroupMesh``.

Collectives move same-width views the backends take (gloo refuses unsigned
ints and int16): 1-byte as int8, 2-byte as float16, 4-byte as int32, 8-byte
as int64. They copy bits and compute nothing, so every dtype arrives intact.
"""

from __future__ import annotations

import torch

_WIRE = {1: torch.int8, 2: torch.float16, 4: torch.int32, 8: torch.int64}


def _wire(x: torch.Tensor) -> torch.Tensor:
    """The same bits as a dtype every backend moves."""
    if x.dtype == torch.bool:
        return x.view(torch.int8)
    return x.view(_WIRE[x.element_size()])


class LocalMesh:
    """P shards held by this process, shard p on ``devices[p]``."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.size = len(self.devices)
        self.shard_ids = list(range(self.size))  # the shards this process holds
        self._one_device = all(d == self.devices[0] for d in self.devices)

    def shard(self, x: torch.Tensor) -> list:
        """The global 1-D ``x`` cut into P equal shards, each on its device
        (views when they share ``x``'s device)."""
        if x.shape[0] % self.size:
            raise ValueError(
                f"N={x.shape[0]} must be a multiple of P={self.size} so the input can shard "
                "evenly over the mesh (pad the caller array; any other divisibility is "
                "handled internally)")
        return [s.to(d) for s, d in zip(x.chunk(self.size) if x.numel() else
                                        [x] * self.size, self.devices)]

    def all_gather(self, xs: list) -> list:
        d0 = self.devices[0]
        stacked = torch.stack([_wire(x).to(d0) for x in xs]).view(xs[0].dtype)
        return [stacked.to(d) for d in self.devices]

    def all_to_all(self, xs: list) -> list:
        if self._one_device:
            # block p of shard q to block q of shard p: one transposed copy
            t = torch.stack([_wire(x) for x in xs]).transpose(0, 1).contiguous()
            return list(t.view(xs[0].dtype).unbind(0))
        return [torch.stack([_wire(x[p]).to(d) for x in xs]).view(xs[0].dtype)
                for p, d in enumerate(self.devices)]


class GroupMesh:
    """One shard per rank of a ``torch.distributed`` process group: shard s
    on group rank ``order[s]`` (default: shard s on rank s), every shard on
    this rank's ``device`` (default: the current CUDA device)."""

    def __init__(self, group=None, device=None, order=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.order = list(range(self.size)) if order is None else [int(r) for r in order]
        if sorted(self.order) != list(range(self.size)):
            raise ValueError(f"order must be a permutation of the group's ranks, got {order}")
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.devices = [torch.device(device)]
        self.shard_ids = [self.order.index(rank)]
        identity = self.order == list(range(self.size))
        # rows by shard -> rows by rank, and back
        self._by_rank = None if identity else torch.tensor(
            [self.order.index(r) for r in range(self.size)], device=self.devices[0])
        self._by_shard = None if identity else torch.tensor(self.order, device=self.devices[0])

    def shard(self, x: torch.Tensor) -> list:
        """``x`` is this rank's shard."""
        return [x.to(self.devices[0])]

    def all_gather(self, xs: list) -> list:
        (x,) = xs
        w = _wire(x).contiguous()
        out = torch.empty((self.size * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype,
                          device=w.device)
        self._dist.all_gather_into_tensor(out, w, group=self.group)
        out = out.view((self.size,) + tuple(w.shape))
        if self._by_shard is not None:
            out = out[self._by_shard]
        return [out.view(x.dtype)]

    def all_to_all(self, xs: list) -> list:
        (x,) = xs
        w = _wire(x)
        w = (w if self._by_rank is None else w[self._by_rank]).contiguous()
        out = torch.empty_like(w)
        self._dist.all_to_all_single(out, w, group=self.group)
        if self._by_shard is not None:
            out = out[self._by_shard]
        return [out.view(x.dtype)]


def _axes(axis_names, shape) -> dict:
    names = tuple(axis_names)
    if len(names) != 2 or names[0] == names[1]:
        raise ValueError(f"a 2-D mesh needs two distinct axis names, got {axis_names}")
    return dict(zip(names, shape))


class _Mesh2D:
    """What both 2-D meshes share: ``axis_names`` and ``shape``, a
    ``{name: size}`` dict as JAX's ``mesh.shape`` is."""

    axis_names: tuple
    shape: dict

    def axis(self, axis_name) -> int:
        """The index (0 or 1) of ``axis_name``; a name the mesh lacks raises."""
        if axis_name not in self.axis_names:
            raise ValueError(f"axis_name {axis_name!r} is not an axis of this mesh; its axes "
                             f"are {self.axis_names}")
        return self.axis_names.index(axis_name)


class LocalMesh2D(_Mesh2D):
    """An R x C grid of devices held by this process, with two axis names
    (default ``("host", "chip")``, as JAX's ``mesh_2d``); a device may
    repeat, so R * C logical shards can sit on one card."""

    def __init__(self, devices_2d, axis_names=("host", "chip")):
        self.devices = [[torch.device(d) for d in row] for row in devices_2d]
        rows, cols = len(self.devices), len(self.devices[0]) if self.devices else 0
        if not cols or any(len(row) != cols for row in self.devices):
            raise ValueError("a 2-D mesh needs a non-empty rectangular grid of devices")
        self.shape = _axes(axis_names, (rows, cols))
        self.axis_names = tuple(self.shape)

    def along(self, axis_name) -> list:
        """The 1-D meshes along ``axis_name``, in order of the other axis's
        index: the R rows along the second axis, the C columns along the
        first, each a ``LocalMesh``."""
        if self.axis(axis_name) == 1:
            return [LocalMesh(row) for row in self.devices]
        return [LocalMesh(list(col)) for col in zip(*self.devices)]


class GroupMesh2D(_Mesh2D):
    """One position of an R x C grid per rank of the default process group:
    position (r, c) on rank ``order[r * C + c]`` (default: rank r * C + c),
    this rank's shards on ``device`` (default: the current CUDA device).

    Every rank builds one process group per row and then one per column, in
    that order (``torch.distributed.new_group`` must be called by every rank
    of the default group, in the same order, for every group), so every rank
    must build the mesh, with the same shape and order."""

    def __init__(self, shape, axis_names=("host", "chip"), device=None, order=None):
        import torch.distributed as dist

        rows, cols = (int(x) for x in shape)
        self.shape = _axes(axis_names, (rows, cols))
        self.axis_names = tuple(self.shape)
        world = dist.get_world_size()
        if rows * cols != world:
            raise ValueError(f"a {rows} x {cols} mesh needs {rows * cols} ranks, the default "
                             f"group has {world}")
        self.order = list(range(world)) if order is None else [int(r) for r in order]
        if sorted(self.order) != list(range(world)):
            raise ValueError(f"order must be a permutation of the ranks, got {order}")
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        pos = self.order.index(dist.get_rank())
        self.position = (pos // cols, pos % cols)
        grid = [self.order[r * cols:(r + 1) * cols] for r in range(rows)]
        lines = grid + [list(col) for col in zip(*grid)]  # the rows, then the columns
        mine = {}
        for i, ranks in enumerate(lines):  # the same calls, in the same order, on every rank
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                # shard s of the line sits on its group rank of global rank ranks[s]
                mine[1 if i < rows else 0] = (group, [dist.get_group_rank(group, r)
                                                      for r in ranks])
        self._lines = mine

    def along(self, axis_name) -> GroupMesh:
        """This rank's row (along the second axis) or column (along the
        first) as a ``GroupMesh``: its subgroup, shard s on the rank at
        index s of the line."""
        group, order = self._lines[self.axis(axis_name)]
        return GroupMesh(group, device=self.device, order=order)
