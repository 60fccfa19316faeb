"""Build and bind the merge engine's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/`` for sm_90a into
one shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, named by a hash of the sources and the flags; ``ctypes``
loads it. Nothing here runs at import, and nothing falls back: a missing
``nvcc``, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_VOIDP4 = ctypes.c_void_p * 4


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"libvkrs_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library with the suffix ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = pathlib.Path(td) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    planes = [ctypes.c_int, _VOIDP4, _VOIDP4, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    lib.vkrs_tilesort.argtypes = planes + [ctypes.c_int, ctypes.c_void_p]
    lib.vkrs_tilesort.restype = ctypes.c_int
    lib.vkrs_mergepath.argtypes = planes + [ctypes.c_longlong, ctypes.c_void_p]
    lib.vkrs_mergepath.restype = ctypes.c_int
    lib.vkrs_error_string.argtypes = [ctypes.c_int]
    lib.vkrs_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, ins: list, outs: list, nck: int, *scalars) -> None:
    """Launch ``vkrs_<name>`` on the current stream of the planes' device.

    ``ins``/``outs`` are equal-length lists of contiguous CUDA int32 tensors
    on one device (the caller checks that), compare planes first; the
    kernel's scalars follow the plane counts. Raises if the launch fails."""
    lib = load()
    device = ins[0].device
    err = getattr(lib, f"vkrs_{name}")(
        device.index,
        _VOIDP4(*(t.data_ptr() for t in ins)),
        _VOIDP4(*(t.data_ptr() for t in outs)),
        nck,
        len(ins) - nck,
        *scalars,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"vkrs_{name} failed: {lib.vkrs_error_string(err).decode()} (cudaError {err})"
        )
