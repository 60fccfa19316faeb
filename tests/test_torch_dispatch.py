"""The PyTorch port's public API (``sort_pairs``, ``sort``, ``argsort``,
``sort_segments``, ``descending=``) on CPU tensors, through the merge
engine's plain versions (``backend="merge"``) and the default route, held
against the JAX package's public API on the same numpy inputs.

Tolerance: exact (bitwise). Every entry point is a stable sort, which has
one right answer; floats compare as bit patterns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
import vkradixsort_tpu_torch as vt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


CFG = vt.SortConfig(tile=4096)  # small tiles: several merge levels at test sizes
N = 3 * 4096 + 555
BACKENDS = [None, "merge"]


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(want.dtype), want)


def _u32_keys(rng, n=N):
    keys = rng.integers(0, 1 << 32, size=n, dtype=np.uint32) % 97  # heavy ties
    keys[rng.random(n) < 0.05] = np.uint32(0xFFFFFFFF)
    return keys


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sort_pairs_u32_main_path(rng, backend, descending):
    keys = _u32_keys(rng)
    vals = np.arange(N, dtype=np.uint32)
    ok, ov = vt.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals), config=CFG,
                           backend=backend, descending=descending)
    jk, jv = vk.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), backend="tiled",
                           descending=descending)
    _eq(ok, jk)
    _eq(ov, jv)
    assert ok.dtype == torch.uint32 and ov.dtype == torch.uint32


@pytest.mark.parametrize("backend", BACKENDS)
def test_sort_pairs_multi_payload_keeps_container(rng, backend):
    keys = rng.integers(-(1 << 62), 1 << 62, size=N, dtype=np.int64) % 1000
    a = rng.standard_normal(N).astype(np.float32)
    b = rng.integers(-(1 << 31), 1 << 31, size=N, dtype=np.int32)  # two carry planes in all
    ok, ov = vt.sort_pairs(torch.from_numpy(keys), [torch.from_numpy(a), torch.from_numpy(b)],
                           config=CFG, backend=backend, stable=False)
    jk, jv = vk.sort_pairs(jnp.asarray(keys), [jnp.asarray(a), jnp.asarray(b)], backend="tiled")
    assert isinstance(ov, list)
    _eq(ok, jk)
    _eq(ov[0], jv[0])
    _eq(ov[1], jv[1])


@pytest.mark.parametrize(
    "dtype", [np.float32, np.float16, np.uint64, np.float64]
)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sort_keys(rng, backend, dtype):
    if np.dtype(dtype).kind == "f":
        keys = (rng.standard_normal(N) * 100).astype(dtype)
        keys[:6] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan], dtype)
    else:
        info = np.iinfo(dtype)
        keys = rng.integers(info.min, int(info.max), size=N, dtype=dtype, endpoint=True)
    for descending in (False, True):
        out = vt.sort(torch.from_numpy(keys), config=CFG, backend=backend, descending=descending)
        _eq(out, vk.sort(jnp.asarray(keys), backend="tiled", descending=descending))


@pytest.mark.parametrize("backend", BACKENDS)
def test_argsort(rng, backend):
    keys = _u32_keys(rng)
    for descending in (False, True):
        perm = vt.argsort(torch.from_numpy(keys), config=CFG, backend=backend,
                          descending=descending)
        _eq(perm, vk.argsort(jnp.asarray(keys), backend="tiled", descending=descending))
        assert perm.dtype == torch.uint32


def test_sort_segments_and_2d_routes(rng):
    keys = rng.standard_normal((5, 900)).astype(np.float32).round(1)
    vals = rng.integers(0, 1 << 31, size=(5, 900)).astype(np.int32)
    for descending in (False, True):
        ok, ov = vt.sort_segments(torch.from_numpy(keys), torch.from_numpy(vals),
                                  descending=descending)
        jk, jv = vk.sort_segments(jnp.asarray(keys), jnp.asarray(vals), descending=descending)
        _eq(ok, jk)
        _eq(ov, jv)
        _eq(vt.sort(torch.from_numpy(keys), descending=descending), jk)
        _eq(vt.argsort(torch.from_numpy(keys), descending=descending),
            vk.argsort(jnp.asarray(keys), descending=descending))


def test_default_route_decides_from_the_tensor():
    from vkradixsort_tpu_torch.engine.config import route_for
    from vkradixsort_tpu_torch.ops.dispatch import _route

    cpu = torch.zeros(1 << 21, dtype=torch.int32).view(torch.uint32)
    assert _route(cpu, None, (cpu,)) == "tiled"
    assert _route(cpu, "merge", (cpu,)) == "merge"
    # the H100 rows, stable sorts of 32-bit keys (engine/config.ROUTE_TABLE)
    assert route_for("kv", 1 << 23) == "tiled"
    assert route_for("kv", (1 << 23) + 1) == "radix_tiled"
    assert route_for("keys", 1 << 23) == "tiled"
    assert route_for("keys", 1 << 24) == "radix_tiled"
    assert route_for("kv2", 1 << 23) == "tiled"
    assert route_for("kv2", (1 << 23) + 1) == "radix_tiled"
    assert route_for("kvw", 1 << 25) == "tiled"  # wide payload sets: positions and a gather
    assert route_for("kvw", (1 << 25) + 1) == "radix_tiled"
    assert route_for("kvw", 1 << 23, wide=True) == "tiled"
    assert route_for("kvw", (1 << 23) + 1, wide=True) == "radix_tiled"
    assert route_for("kv", 1 << 23, wide=True) == "tiled"  # 64-bit keys: the kv64 rows
    assert route_for("kv", 1 << 27, wide=True) == "radix_tiled"


@pytest.mark.parametrize("op,widths,wide,row", [
    ("kv", (), False, "keys"), ("kv", (4,), False, "kv"), ("kv", (1,), False, "kv"),
    ("kv", (8,), True, "kv"), ("kv", (4, 4), False, "kv2"), ("kv", (4, 4), True, "kvw"),
    ("kv", (2, 4), False, "kvw"), ("kv", (4, 4, 4), False, "kvw"),
    ("kv", (2,), True, "kv"), ("kv", (8, 4), True, "kvw"),
    ("argsort", (), True, "argsort"),
])
def test_payload_set_reads_its_route_row(op, widths, wide, row):
    from vkradixsort_tpu_torch.ops.dispatch import _table_op

    dtypes = {1: torch.int8, 2: torch.int16, 4: torch.float32, 8: torch.int64}
    assert _table_op(op, tuple(torch.zeros(2, dtype=dtypes[w]) for w in widths), wide) == row


def test_bad_calls_raise():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        vt.sort(k, backend="no-such-engine")
    with pytest.raises(ValueError):
        vt.sort(k.view(2, 4), backend="merge")
    with pytest.raises(ValueError):
        vt.sort(k.view(2, 2, 2))
    with pytest.raises(ValueError):
        vt.sort_pairs(k, torch.zeros(7, dtype=torch.int32))
    with pytest.raises(ValueError):
        vt.sort_pairs(k, torch.zeros(8, dtype=torch.int32, device="meta"))
