"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/`` for sm_90a, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, named by a hash of the sources and the flags;
``ctypes`` loads it. Nothing here runs at import, and nothing falls back: a
missing ``nvcc``, a failed build or a failed launch raises.
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
import time

import torch

from vkradixsort_tpu_torch.utils import profiling

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_VOIDP4 = ctypes.c_void_p * 4
_VOIDP5 = ctypes.c_void_p * 5  # a plane bundle of the merge kernels (csrc/planes.cuh)
MAX_COLUMNS = 8  # columns of one gather_columns launch (csrc/gather.cu)
_VOIDP8 = ctypes.c_void_p * MAX_COLUMNS
_INT32X8 = ctypes.c_int * MAX_COLUMNS
_U64X4 = ctypes.c_ulonglong * 4


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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"libvkrs_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library with the suffix ``.log``. A
    build runs in the span ``vkrs/kernels/build`` and counts one
    ``kernels.builds``."""
    out = library_path()
    if out.exists():
        return out
    with profiling.span("vkrs/kernels/build"):
        _compile(out)
    profiling.count("kernels.builds")
    return out


def _compile(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        jobs = []
        for src in _sources():
            obj = pathlib.Path(td) / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:  # wait for every compiler before raising
            report = proc.communicate()[0]
            log.append(f"$ {' '.join(cmd)}\n{report}")
            if proc.returncode != 0:
                failed.append(log[-1])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        tmp = pathlib.Path(td) / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel link failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call; its seconds, build
    included, add to the counter ``kernels.load_s``."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ints = ctypes.POINTER(ctypes.c_int)
    planes = [_VOIDP5, _VOIDP5, i32, i32, i64]
    # the arguments between the device (first) and the stream (last)
    signatures = {
        "tilesort": planes + [i32],
        "mergepath": planes + [i64, i32],
        "histogram": [ptr, i64, i32, i32, i32, ptr],
        "radix_dest": [ptr, i64, i32, i32, i32, ptr, ptr],
        "radix_scatter": [ptr, i32, ptr, i32, i64, i32, i32, ptr, ptr, ptr],
        "digit_histograms": [ptr, i32, i64, ptr],
        "onesweep_pass": [ptr, i32, ptr, i32, i64, i32, ptr, ptr, ptr, ptr],
        "fused": [ptr, ptr, ptr, ptr, i32, i32, i32],
        "bitonic_block": [ptr, ptr, ptr, i32, i64, i64, i32, i32, ints, i32],
        "bitonic_group": [ptr, i32, i64, i32, i32, i32],
        "bitonic_gather": [ptr, ptr, ptr, i64, i32],
        "placement": [_VOIDP4, _VOIDP4, _U64X4, i32, i32, i32, ptr, ptr, i32, i64, i32, i32],
        "gather_columns": [ptr, i64, i32, _VOIDP8, _VOIDP8, ints],
    }
    for name, args in signatures.items():
        fn = getattr(lib, f"vkrs_{name}")
        fn.argtypes = [i32, *args, ptr]
        fn.restype = i32
    lib.vkrs_onesweep_shape.argtypes = [i32, i32, i32, ints]
    lib.vkrs_onesweep_shape.restype = i32
    lib.vkrs_error_string.argtypes = [i32]
    lib.vkrs_error_string.restype = ctypes.c_char_p
    profiling.count("kernels.load_s", time.perf_counter() - t0)
    return lib


def call(name: str, device: torch.device, *args) -> None:
    """Launch ``vkrs_<name>(device, *args, stream)`` on the current stream of
    ``device``; pointers are passed as ints (``tensor.data_ptr()``). The
    caller checks devices, dtypes and shapes. Raises if the launch fails."""
    lib = load()
    # the raw handle of the current stream (what Stream.cuda_stream holds,
    # without building a Stream object: a few microseconds a launch)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = getattr(lib, f"vkrs_{name}")(device.index, *args, stream)
    if err != 0:
        raise RuntimeError(
            f"vkrs_{name} failed: {lib.vkrs_error_string(err).decode()} (cudaError {err})"
        )


def pointers(tensors: list):
    """The data pointers of up to four tensors, as a C array."""
    return _VOIDP4(*(t.data_ptr() for t in tensors))


def columns(tensors: list):
    """The data pointers of up to :data:`MAX_COLUMNS` tensors, and their
    element widths, as C arrays."""
    return (_VOIDP8(*(t.data_ptr() for t in tensors)),
            _INT32X8(*(t.element_size() for t in tensors)))


def u64s(values: list):
    """Up to four unsigned 64-bit values (bit patterns), as a C array."""
    return _U64X4(*(v & 0xFFFFFFFFFFFFFFFF for v in values))


def launch(name: str, ins: list, outs: list, nck: int, *scalars) -> None:
    """Launch the merge engine's ``vkrs_<name>`` on plane bundles.

    ``ins``/``outs`` are equal-length lists of up to five contiguous CUDA
    int32 tensors on one device (the caller checks that), compare planes
    first; the kernel's scalars follow the plane counts. Raises if the
    launch fails."""
    call(
        name,
        ins[0].device,
        _VOIDP5(*(t.data_ptr() for t in ins)),
        _VOIDP5(*(t.data_ptr() for t in outs)),
        nck,
        len(ins) - nck,
        *scalars,
    )
