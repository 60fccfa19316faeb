"""Multi-process support for the distributed sort, on ``torch.distributed``.

Port of ``vkradixsort_tpu/parallel/multihost.py``. The process group owns
bootstrap and collectives (NCCL between cards, gloo between CPU
processes); this module only

  * initializes the default process group once (``ensure_initialized``: a
    no-op without a launcher's environment or arguments),
  * builds the 1-D mesh over every rank, host-major, so that the bulk of
    ``sort_sharded``'s all-to-all stays between the cards of one host
    (``global_mesh_1d``), and the 2-D mesh over every rank in that order,
    row by row, as the JAX package's ``mesh_2d`` lays out its devices
    (``global_mesh_2d``: with a row per host, a sort along its second
    axis stays on one host),
  * puts this rank's shard on its device (``global_array_from_host_data``).

``parallel.distributed.sort_sharded`` then runs over that mesh unchanged.
Nothing on a machine tells a program of a cluster: pass ``init_method``
(for example ``tcp://localhost:<port>``), ``world_size`` and ``rank``, or
launch under ``torchrun``, which sets ``MASTER_ADDR`` and ``WORLD_SIZE``.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from vkradixsort_tpu_torch.parallel.mesh import GroupMesh, GroupMesh2D


def ensure_initialized(init_method: str | None = None, world_size: int | None = None,
                       rank: int | None = None, backend: str = "nccl") -> bool:
    """Initialize the default process group once; returns True if it spans
    more than one process. With no argument and no launcher environment
    (``MASTER_ADDR`` or ``WORLD_SIZE``) it does nothing and returns False.
    ``backend`` is the caller's choice: nothing switches from NCCL to gloo
    when there is no card."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    launched = os.environ.get("MASTER_ADDR") or os.environ.get("WORLD_SIZE")
    if init_method is None and world_size is None and not launched:
        return False
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    return dist.get_world_size() > 1


def global_mesh_1d(device=None) -> GroupMesh:
    """A ``GroupMesh`` over every rank of the default group, host-major:
    the hosts in the order of their lowest rank, the ranks of one host by
    their local rank (``LOCAL_RANK``, else the current CUDA device, else 0).
    ``device``: this rank's device (default: the current CUDA device)."""
    return GroupMesh(device=device, order=_host_major_order())


def global_mesh_2d(shape, axis_names=("host", "chip"), device=None) -> GroupMesh2D:
    """A ``GroupMesh2D`` of ``shape`` (R x C, R * C ranks) over every rank of
    the default group, its positions filled row by row in
    :func:`global_mesh_1d`'s host-major order: DCN-major, ICI-minor, as the
    JAX package's ``mesh_2d``. Every rank must call it, with the same
    arguments: it makes a process group per row and per column."""
    return GroupMesh2D(shape, axis_names, device=device, order=_host_major_order())


def _host_major_order() -> list:
    """Every rank of the default group, host-major (an all-gather)."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = torch.cuda.current_device() if torch.cuda.is_available() else 0
    me = (socket.gethostname(), int(local), dist.get_rank())
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, me)
    first = {}
    for host, _, r in everyone:
        first[host] = min(first.get(host, r), r)
    return [r for host, lr, r in sorted(everyone, key=lambda e: (first[e[0]], e[1], e[2]))]


def global_array_from_host_data(local_data, mesh: GroupMesh) -> torch.Tensor:
    """This rank's shard of the keys (or of a payload), a numpy array or a
    tensor of equal length on every rank, as a tensor on the rank's device;
    it feeds ``sort_sharded`` as the rank's shard."""
    if isinstance(local_data, np.ndarray):
        local_data = torch.from_numpy(np.ascontiguousarray(local_data))
    return local_data.to(mesh.devices[0])
