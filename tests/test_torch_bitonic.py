"""The PyTorch port's bitonic engine (ops/bitonic.py) on CPU tensors, where
the kernel wrapper runs its plain version, held against the JAX engine in
Pallas interpret mode on the same numpy inputs: the plane split and join,
``bitonic_sort_block`` over sizes, distributions, key widths and payloads,
and the public API through ``backend="bitonic"``, its size contract
included.

Tolerance: exact (bitwise). A sort of keys has one answer, and with payloads
the sort is stable, which has one answer too. Each JAX case runs once, in a
module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
from vkradixsort_tpu.engine.context import default_context
from vkradixsort_tpu.ops import bitonic as jbitonic
from vkradixsort_tpu_torch.ops import bitonic, common

import vkradixsort_tpu_torch as vt

JCFG = vk.SortConfig(interpret=True)
SIZES = [100, 1024, 5000, 16384]
KEY_DTYPES = [np.uint32, np.int32, np.uint64, np.int64]
DISTS = ["uniform", "descending", "constant", "max"]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(common.bits_view(got).numpy().view(want.dtype), want)


def _keys(seed: int, n: int, dtype, dist: str) -> np.ndarray:
    """Seeded keys: "uniform" over the whole dtype, "descending",
    "constant", or "max" (a fifth equal to the dtype's maximum, the padding
    sentinel, the rest 7 values)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if dist == "uniform":
        return rng.integers(info.min, info.max, size=n, dtype=dtype, endpoint=True)
    if dist == "descending":
        return (np.arange(n, 0, -1) * 7919 - n).astype(dtype)
    if dist == "constant":
        return np.full(n, 42, dtype=dtype)
    keys = rng.integers(-3, 4, size=n).astype(dtype)
    keys[rng.random(n) < 0.2] = info.max
    return keys


def _values(seed: int, n: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, size=n, dtype=dtype, endpoint=True)


# ---------------------------------------------------------------------------
# planes


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32, np.uint64, np.int64,
                                   np.float64])
def test_split_and_join_planes_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=4000 * np.dtype(dtype).itemsize, dtype=np.uint8).view(dtype)
    planes = bitonic._split_planes(_t(x))
    jplanes = jbitonic._split_planes(jnp.asarray(x))
    assert len(planes) == len(jplanes)
    for p, jp in zip(planes, jplanes):
        assert p.dtype == torch.int32
        _eq(p, jp)
    _eq(bitonic._join_planes(planes, _t(x).dtype), x)


# ---------------------------------------------------------------------------
# bitonic_sort_block against the JAX kernel (interpret mode)

# keys only: every size with every key dtype, the distributions cycling
KEY_CASES = [(n, dt, DISTS[(i + j) % 4]) for i, n in enumerate(SIZES)
             for j, dt in enumerate(KEY_DTYPES)]
# (n, key dtype, distribution, value dtypes, stable)
PAIR_CASES = [
    (100, np.uint32, "max", (np.uint32,), True),
    (1024, np.int32, "constant", (np.int32,), True),
    (5000, np.int64, "max", (np.uint64,), True),
    (16384, np.uint32, "uniform", (np.float32,), True),
    (5000, np.uint64, "max", (np.float32, np.int64), True),
    (3000, np.int32, "max", (np.float64,), False),  # values imply stable
]


@pytest.fixture(scope="module")
def jax_blocks():
    out = {}
    for i, (n, dt, dist) in enumerate(KEY_CASES):
        keys = _keys(i, n, dt, dist)
        jk, _ = jbitonic.bitonic_sort_block(jnp.asarray(keys), interpret=True)
        out[("keys", i)] = (keys, (), np.asarray(jk), ())
    for i, (n, dt, dist, vdts, stable) in enumerate(PAIR_CASES):
        keys = _keys(100 + i, n, dt, dist)
        vals = tuple(_values(200 + i + j, n, v) for j, v in enumerate(vdts))
        jk, jv = jbitonic.bitonic_sort_block(jnp.asarray(keys), tuple(map(jnp.asarray, vals)),
                                             stable=stable, interpret=True)
        out[("pairs", i)] = (keys, vals, np.asarray(jk), tuple(map(np.asarray, jv)))
    return out


def _check_block(case, stable=False):
    keys, vals, jk, jv = case
    before = bitonic.launch_counts()
    ok, ov = bitonic.bitonic_sort_block(_t(keys), tuple(map(_t, vals)), stable=stable)
    assert bitonic.launch_counts() == before  # CPU: the plain version
    _eq(ok, jk)
    assert len(ov) == len(jv)
    for o, j in zip(ov, jv):
        _eq(o, j)
    if vals:  # stable: the one stable order
        perm = np.argsort(keys, kind="stable")
        for o, v in zip(ov, vals):
            _eq(o, v[perm])
    else:
        _eq(ok, np.sort(keys))


@pytest.mark.parametrize("i", range(len(KEY_CASES)),
                         ids=[f"{c[0]}-{c[1].__name__}-{c[2]}" for c in KEY_CASES])
def test_bitonic_keys_match_jax(jax_blocks, i):
    _check_block(jax_blocks[("keys", i)])


@pytest.mark.parametrize("i", range(len(PAIR_CASES)),
                         ids=[f"{c[0]}-{c[1].__name__}-{c[2]}-{len(c[3])}v" for c in PAIR_CASES])
def test_bitonic_pairs_match_jax(jax_blocks, i):
    _check_block(jax_blocks[("pairs", i)], stable=PAIR_CASES[i][4])


def test_bitonic_plain_is_the_wrapper_on_cpu():
    keys = _keys(7, 2000, np.int64, "max")
    vals = _values(8, 2000, np.uint32)
    ok, (ov,) = bitonic.bitonic_sort_block(_t(keys), (_t(vals),))
    pk, (pv,) = bitonic.bitonic_sort_block_plain(_t(keys), (_t(vals),))
    assert torch.equal(ok, pk) and torch.equal(ov, pv)


def test_bitonic_refuses_other_widths():
    with pytest.raises(TypeError, match="4/8-byte integer keys"):
        bitonic.bitonic_sort_block(torch.zeros(8, dtype=torch.int16))
    with pytest.raises(TypeError, match="4/8-byte values"):
        bitonic.bitonic_sort_block(torch.zeros(8, dtype=torch.int32),
                                   (torch.zeros(8, dtype=torch.uint8),))
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bitonic.bitonic_sort_block(meta)


# ---------------------------------------------------------------------------
# the public API through backend="bitonic"

N_API = 3001


@pytest.fixture(scope="module")
def jax_api():
    rng = np.random.default_rng(31)
    u32 = _keys(32, N_API, np.uint32, "max")
    i64 = _keys(33, N_API, np.int64, "max")
    f32 = (rng.standard_normal(N_API) * 20).round().astype(np.float32)
    f32[:5] = [-0.0, 0.0, np.inf, -np.inf, np.nan]
    v32 = np.arange(N_API, dtype=np.uint32)
    three = (rng.standard_normal(N_API).astype(np.float32), np.arange(N_API, dtype=np.int64),
             rng.integers(0, 1 << 30, size=N_API).astype(np.int32))
    out = {}
    for desc in (False, True):
        out[("kv", desc)] = (u32, v32), vk.sort_pairs(
            jnp.asarray(u32), jnp.asarray(v32), config=JCFG, backend="bitonic", descending=desc)
        out[("sort", desc)] = i64, vk.sort(jnp.asarray(i64), config=JCFG, backend="bitonic",
                                            descending=desc)
    out["argsort"] = f32, vk.argsort(jnp.asarray(f32), config=JCFG, backend="bitonic")
    out["three"] = (i64, three), vk.sort_pairs(jnp.asarray(i64), tuple(map(jnp.asarray, three)),
                                               config=JCFG, backend="bitonic")
    out["sort_i32"] = u32.view(np.int32), vk.sort(jnp.asarray(u32.view(np.int32)), config=JCFG,
                                                  backend="bitonic")
    return out


@pytest.mark.parametrize("descending", [False, True])
def test_api_sort_pairs_and_sort_match_jax(jax_api, descending):
    (k, v), (jk, jv) = jax_api[("kv", descending)]
    ok, ov = vt.sort_pairs(_t(k), _t(v), backend="bitonic", descending=descending)
    _eq(ok, jk)
    _eq(ov, jv)
    k64, jsorted = jax_api[("sort", descending)]
    _eq(vt.sort(_t(k64), backend="bitonic", descending=descending), jsorted)


def test_api_argsort_and_three_payloads_match_jax(jax_api):
    f32, jperm = jax_api["argsort"]
    perm = vt.argsort(_t(f32), backend="bitonic")
    assert perm.dtype == torch.uint32
    _eq(perm, jperm)
    (k, three), (jk, jvs) = jax_api["three"]
    ok, ovs = vt.sort_pairs(_t(k), tuple(map(_t, three)), backend="bitonic")
    assert isinstance(ovs, tuple) and len(ovs) == 3
    _eq(ok, jk)
    for o, j in zip(ovs, jvs):
        _eq(o, j)
    i32, jsorted = jax_api["sort_i32"]
    _eq(vt.sort(_t(i32), backend="bitonic"), jsorted)


@pytest.mark.parametrize("key_dtype,val_dtypes", [
    (np.uint32, ()), (np.uint32, (np.uint32,)), (np.uint64, (np.uint64,)),
    (np.float32, (np.float32, np.float64)),
])
def test_size_contract_refuses_at_the_same_n(key_dtype, val_dtypes):
    kp = 2 if np.dtype(key_dtype).itemsize == 8 else 1
    nplanes = kp + sum(np.dtype(v).itemsize // 4 for v in val_dtypes) + (1 if val_dtypes else 0)
    max_n = bitonic.max_n(torch.device("cpu"), nplanes)
    assert max_n == default_context().info.vmem_bytes // (16 * nplanes)
    assert bitonic.max_n(torch.device("cuda", 0), nplanes) == 64 * 2**20 // (16 * nplanes)
    n = max_n + 1
    keys = np.zeros(n, dtype=key_dtype)
    vals = tuple(np.zeros(n, dtype=v) for v in val_dtypes)
    with pytest.raises(ValueError, match="bound to"):
        if vals:
            vt.sort_pairs(_t(keys), tuple(map(_t, vals)), backend="bitonic")
        else:
            vt.sort(_t(keys), backend="bitonic")
    with pytest.raises(ValueError, match="bound to"):
        if vals:
            vk.sort_pairs(jnp.asarray(keys), tuple(map(jnp.asarray, vals)), config=JCFG,
                          backend="bitonic")
        else:
            vk.sort(jnp.asarray(keys), config=JCFG, backend="bitonic")


def test_cuda_size_contract():
    cuda = torch.device("cuda", 0)
    assert bitonic.max_n(cuda, 1) == 1 << 22  # u32 keys only
    assert bitonic.max_n(cuda, 3) == 1_398_101  # stable u32 kv
    assert bitonic.max_n(cuda, 5) == 838_860  # u64 keys, u64 payload


@pytest.mark.parametrize("n", [0, 1, 2])
def test_api_tiny_inputs(n):
    keys = np.arange(n, dtype=np.uint32)[::-1].copy()
    vals = np.arange(n, dtype=np.float32)
    ok, ov = vt.sort_pairs(_t(keys), _t(vals), backend="bitonic")
    _eq(ok, np.sort(keys))
    _eq(ov, vals[np.argsort(keys, kind="stable")])
