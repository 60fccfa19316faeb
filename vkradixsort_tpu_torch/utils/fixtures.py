"""Key-distribution fixtures for the tests and ``chip_smoke.py``.

A numpy-only copy of ``vkradixsort_tpu/utils/fixtures.py::make_keys`` (the
port imports nothing of the JAX package): uniform 28-bit keys (the
reference's generator caps at 0x0FFFFFFF), full-width uniform, descending,
constant, and Zipf-skewed (``BASELINE.json`` config 4). The same ``rng`` and
arguments give the same keys as the JAX package's fixture.
"""

from __future__ import annotations

import numpy as np


def make_keys(rng, n, dtype=np.uint32, distribution="uniform28"):
    dtype = np.dtype(dtype)
    if distribution == "uniform28":
        hi = min(1 << 28, int(np.iinfo(dtype).max)) if dtype.kind == "u" else 1 << 28
        return rng.integers(
            0, hi, size=n, dtype=dtype if dtype.kind == "u" else np.uint64
        ).astype(dtype)
    if distribution == "uniform":
        if dtype.kind in "ui":
            info = np.iinfo(dtype)
            # endpoint=True: the dtype's maximum is reachable, so tests meet
            # keys equal to the padding sentinel
            return rng.integers(info.min, int(info.max), size=n, dtype=dtype, endpoint=True)
        return (rng.random(n) * 2 - 1).astype(dtype) * 1e6
    if distribution == "descending":
        if dtype.kind == "f":
            return np.arange(n, 0, -1).astype(dtype)
        # through uint64: iinfo(uint64).max does not fit the int64 arange
        arr = np.arange(n, 0, -1).astype(np.uint64)
        return (arr % np.uint64(np.iinfo(dtype).max)).astype(dtype)
    if distribution == "constant":
        return np.full(n, 42, dtype=dtype)
    if distribution == "zipf":
        raw = rng.zipf(1.3, size=n).astype(np.uint64)
        mod = np.uint64(np.iinfo(dtype).max) if dtype.kind == "u" else np.uint64(1 << 30)
        return (raw % mod).astype(dtype)
    raise ValueError(distribution)
