"""GPUContext: device discovery, meshes and the limits that size the kernels.

Port of ``vkradixsort_tpu/engine/context.py``. The JAX package kept a table
of VMEM budgets per TPU generation; here the CUDA runtime reports the limits
of the card itself, through ``torch.cuda.get_device_properties``. Its 1-D
mesh is a ``parallel.mesh.LocalMesh`` of the visible cards, one shard each;
its 2-D mesh a ``parallel.mesh.LocalMesh2D`` of them, reshaped row-major as
the JAX package's ``mesh_2d`` reshapes its devices, for a sort along one of
its two named axes.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from vkradixsort_tpu_torch.parallel.mesh import LocalMesh, LocalMesh2D


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    name: str
    sm_count: int
    smem_per_block_optin: int  # bytes of dynamic shared memory one block may opt into
    smem_per_sm: int  # bytes of shared memory one SM holds for all its resident blocks
    l2_bytes: int


class GPUContext:
    """One CUDA device and its limits."""

    def __init__(self, device: torch.device | str | int | None = None):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible")
        device = torch.device("cuda" if device is None else device)
        if device.type != "cuda":
            raise ValueError(f"GPUContext needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    @property
    def info(self) -> DeviceInfo:
        p = torch.cuda.get_device_properties(self.device)
        return DeviceInfo(
            name=p.name,
            sm_count=p.multi_processor_count,
            smem_per_block_optin=p.shared_memory_per_block_optin,
            smem_per_sm=p.shared_memory_per_multiprocessor,
            l2_bytes=p.L2_cache_size,
        )

    @property
    def devices(self) -> list:
        """Every visible card, in index order. Raises if none is visible."""
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible")
        return [torch.device("cuda", i) for i in range(n)]

    def mesh_1d(self, num_devices: int | None = None) -> LocalMesh:
        """A 1-D mesh over all (or the first ``num_devices``) visible cards,
        one shard each: the counterpart of the JAX package's 1-D ``Mesh``."""
        devs = self.devices
        n = len(devs) if num_devices is None else num_devices
        if not 1 <= n <= len(devs):
            raise ValueError(f"a mesh of {n} cards needs 1 to {len(devs)} (the visible cards)")
        return LocalMesh(devs[:n])

    def mesh_2d(self, shape: tuple, axis_names: tuple = ("host", "chip")) -> LocalMesh2D:
        """A 2-D mesh over the first R * C visible cards, one shard each,
        reshaped row-major (host-major, chip-minor): the counterpart of the
        JAX package's ``mesh_2d``."""
        rows, cols = shape
        devs = self.devices
        n = rows * cols
        if n > len(devs):
            raise ValueError(f"mesh {tuple(shape)} needs {n} devices, have {len(devs)}")
        return LocalMesh2D([devs[r * cols:(r + 1) * cols] for r in range(rows)], axis_names)


@functools.lru_cache(maxsize=1)
def default_context() -> GPUContext:
    """The context of the current card, made once. Raises without a card."""
    return GPUContext()
