"""GPUContext: device discovery and the limits that size the kernels.

Port of ``vkradixsort_tpu/engine/context.py``. The JAX package kept a table
of VMEM budgets per TPU generation; here the CUDA runtime reports the limits
of the card itself, through ``torch.cuda.get_device_properties``.
"""

from __future__ import annotations

import dataclasses

import torch


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
