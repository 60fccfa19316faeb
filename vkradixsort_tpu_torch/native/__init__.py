"""Native (C++) host runtime: ctypes bindings with an on-demand g++ build.

The port's copy of ``vkradixsort_tpu.native``, with the same public names,
signatures and answers, so that the port reaches it without importing JAX:
this module imports numpy and the standard library only. It covers the host
side of the reference's checks:

  * fixture generation (mt19937, reference SingleRadixSort.cpp:85-98),
    seeded on a fixed grid of 64 chunks, so the thread count of the machine
    does not change the keys;
  * CPU oracle sorts: ``std::sort`` plus a multi-threaded stable LSD radix
    sort and argsort (the reference's ``std::sort`` baseline is the
    bottleneck of verification at 1e8 keys);
  * exact element-wise verification (reference SingleRadixSort.cpp:113-126).

At first use ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` (``CXX``
overrides the compiler) builds ``host_runtime.cpp`` into ``build/native/``
at the root of the checkout, named by a hash of the source, the flags and
the compiler's ``--version``, and written atomically; ``ctypes`` loads it.
Every entry point has a numpy fallback, taken when the library cannot be
built or ``VKRS_NO_NATIVE`` is set (``available()`` says which one runs).
The fallback's oracle and check answers are the library's, but its
``generate_uniform`` draws other keys, and as an oracle it is about ten
times slower.

The fixtures are reproducible per standard library, not across standard
libraries: ``std::uniform_int_distribution`` is implementation-defined, so
one seed gives the same keys wherever the same C++ standard library builds
the runtime (the JAX package's copy and this one agree when one compiler
builds both), and may give others elsewhere.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).with_name("host_runtime.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 1
_LIB = None
_LIB_ERR = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> pathlib.Path:
    """Where the library for this source, these flags and this compiler
    lives. Raises if the compiler cannot be run."""
    version = subprocess.run([_compiler(), "--version"], check=True, capture_output=True,
                             text=True).stdout
    h = hashlib.sha256(_SRC.read_bytes())
    h.update("\0".join((*FLAGS, version)).encode())
    return BUILD_DIR / f"host_runtime_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the runtime unless its library exists; returns its path.
    Raises if the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = pathlib.Path(td) / out.name
        cmd = [_compiler(), *FLAGS, str(_SRC), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host runtime build failed ({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def _load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    if os.environ.get("VKRS_NO_NATIVE"):
        _LIB_ERR = RuntimeError("disabled via VKRS_NO_NATIVE")
        return None
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _LIB_ERR = e  # no compiler, a failed build or a library that does not load
        return None

    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    st = ctypes.c_size_t
    sigs = {
        "vkrs_generate_u32": (None, [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, u32p, st]),
        "vkrs_generate_u64": (None, [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, u64p, st]),
        "vkrs_generate_descending_u32": (None, [u32p, st]),
        "vkrs_std_sort_u32": (None, [u32p, st]),
        "vkrs_std_sort_u64": (None, [u64p, st]),
        "vkrs_radix_sort_u32": (None, [u32p, st]),
        "vkrs_radix_sort_u64": (None, [u64p, st]),
        "vkrs_radix_sort_kv_u32": (None, [u32p, u32p, st]),
        "vkrs_radix_sort_kv_u64": (None, [u64p, u64p, st]),
        "vkrs_stable_argsort_u32": (None, [u32p, u32p, st]),
        "vkrs_first_mismatch_u32": (ctypes.c_int64, [u32p, u32p, st]),
        "vkrs_first_mismatch_u64": (ctypes.c_int64, [u64p, u64p, st]),
        "vkrs_first_unsorted_u32": (ctypes.c_int64, [u32p, st]),
        "vkrs_abi_version": (ctypes.c_int, []),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    if lib.vkrs_abi_version() != ABI_VERSION:
        raise RuntimeError(f"host runtime ABI {lib.vkrs_abi_version()}, expected {ABI_VERSION}")
    _LIB = lib
    return lib


def available() -> bool:
    """True if the compiled native library is loaded (vs numpy fallback)."""
    return _load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# ---- public API (numpy in, numpy out; native when available) ----


def generate_uniform(seed: int, n: int, lo: int = 0, hi: int = 0x0FFFFFFF,
                     dtype=np.uint32) -> np.ndarray:
    """Uniform keys in [lo, hi] — the reference's fixture distribution
    (SingleRadixSort.cpp:85-98 caps u32 values at 0x0FFFFFFF)."""
    dtype = np.dtype(dtype)
    lib = _load()
    out = np.empty(n, dtype)
    if lib is not None and dtype == np.uint32:
        lib.vkrs_generate_u32(seed, lo, hi, _ptr(out, ctypes.c_uint32), n)
        return out
    if lib is not None and dtype == np.uint64:
        lib.vkrs_generate_u64(seed, lo, hi, _ptr(out, ctypes.c_uint64), n)
        return out
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=n, dtype=dtype, endpoint=True)


def generate_descending(n: int) -> np.ndarray:
    """The reference's commented-out descending fixture
    (SingleRadixSort.cpp:96: ``numElements - i``)."""
    lib = _load()
    out = np.empty(n, np.uint32)
    if lib is not None:
        lib.vkrs_generate_descending_u32(_ptr(out, ctypes.c_uint32), n)
        return out
    return (n - np.arange(n, dtype=np.int64)).astype(np.uint32)


def oracle_sort(keys: np.ndarray, algorithm: str = "radix") -> np.ndarray:
    """CPU oracle sort (copy; input untouched).

    algorithm='std' uses std::sort exactly like the reference baseline
    (SingleRadixSort.cpp:106-111); 'radix' uses the multi-threaded LSD
    radix sort (identical output, much faster at 1e8).
    """
    if algorithm not in ("std", "radix"):
        raise ValueError(f"algorithm must be 'std' or 'radix', got {algorithm!r}")
    lib = _load()
    out = np.ascontiguousarray(keys).copy()
    if lib is None:
        out.sort(kind="stable")
        return out
    n = out.size
    if out.dtype == np.uint32:
        fn = lib.vkrs_std_sort_u32 if algorithm == "std" else lib.vkrs_radix_sort_u32
        fn(_ptr(out, ctypes.c_uint32), n)
    elif out.dtype == np.uint64:
        fn = lib.vkrs_std_sort_u64 if algorithm == "std" else lib.vkrs_radix_sort_u64
        fn(_ptr(out, ctypes.c_uint64), n)
    else:
        out.sort(kind="stable")
    return out


def oracle_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort oracle (uint32 indices; requires n < 2^32)."""
    keys = np.ascontiguousarray(keys)
    if keys.size >= 2**32:
        raise ValueError(f"oracle_argsort returns uint32 indices; n={keys.size} needs more")
    lib = _load()
    if lib is not None and keys.dtype == np.uint32:
        idx = np.empty(keys.size, np.uint32)
        lib.vkrs_stable_argsort_u32(
            _ptr(keys, ctypes.c_uint32), _ptr(idx, ctypes.c_uint32), keys.size
        )
        return idx
    return np.argsort(keys, kind="stable").astype(np.uint32)


def first_mismatch(a: np.ndarray, b: np.ndarray) -> int:
    """First index where a != b, or -1 — the reference's testSort check
    (SingleRadixSort.cpp:113-126) as a fast primitive."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"first_mismatch compares arrays of one shape and dtype, got "
                         f"{a.shape} {a.dtype} and {b.shape} {b.dtype}")
    lib = _load()
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    if lib is not None and a.dtype == np.uint32:
        return int(lib.vkrs_first_mismatch_u32(
            _ptr(a, ctypes.c_uint32), _ptr(b, ctypes.c_uint32), a.size))
    if lib is not None and a.dtype == np.uint64:
        return int(lib.vkrs_first_mismatch_u64(
            _ptr(a, ctypes.c_uint64), _ptr(b, ctypes.c_uint64), a.size))
    neq = np.nonzero((a != b).ravel())[0]
    return int(neq[0]) if neq.size else -1


def first_unsorted(a: np.ndarray) -> int:
    """First index i with a[i] > a[i+1], or -1 if non-decreasing."""
    lib = _load()
    a = np.ascontiguousarray(a)
    if lib is not None and a.dtype == np.uint32:
        return int(lib.vkrs_first_unsorted_u32(_ptr(a, ctypes.c_uint32), a.size))
    bad = np.nonzero(a[:-1] > a[1:])[0]
    return int(bad[0]) if bad.size else -1
