"""The PyTorch port's bitonic engine (ops/bitonic.py) on CPU tensors, where
the kernel wrapper runs its plain version, held against the JAX engine in
Pallas interpret mode on the same numpy inputs: the plane split and join,
``bitonic_sort_block`` over sizes, distributions, key widths and payloads,
and the public API through ``backend="bitonic"``, its size contract
included. The kernels' schedule (``bitonic.plan``: global groups and
in-block rounds) is checked for covering every stage of the network once,
in order, for its launch counts at the contract shapes and for its
thread-to-slot maps; its plain torch run (``scheduled_sort_plain``, with a
small tile) is held against the plain network and against the JAX engine on
the same inputs.

Tolerance: exact (bitwise). A sort of keys has one answer, and with payloads
the sort is stable, which has one answer too. Each JAX case runs once, in a
module-scoped fixture.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
from vkradixsort_tpu.engine.context import default_context
from vkradixsort_tpu.ops import bitonic as jbitonic
from vkradixsort_tpu_torch.ops import bitonic, common

import vkradixsort_tpu_torch as vt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


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


# ---------------------------------------------------------------------------
# the kernels' schedule (bitonic.plan) and its plain torch run

PLAN_NPADS = [1 << e for e in range(10, 24)]


@pytest.mark.parametrize("nk", [1, 2])
@pytest.mark.parametrize("tile", [8192, 16384])
@pytest.mark.parametrize("npad", PLAN_NPADS)
def test_plan_covers_every_stage_once_in_network_order(npad, tile, nk):
    launches = bitonic.plan(npad, tile, nk)
    logn, logt = npad.bit_length() - 1, min(tile, npad).bit_length() - 1
    network = [(s, j) for s in range(1, logn + 1) for j in range(s - 1, -1, -1)]
    assert bitonic.plan_stages(launches) == network
    assert isinstance(launches[0], bitonic.BlockPass) and launches[0].first
    assert sum(isinstance(x, bitonic.BlockPass) and x.first for x in launches) == 1
    for x in launches:
        if isinstance(x, bitonic.GlobalGroup):  # distances from the tile up, r per launch
            assert x.top - x.r + 1 >= logt and 1 <= x.r <= bitonic.GROUP_DISTANCES[nk]
        else:  # distances below the tile, within each round's window
            assert len(x.stages) <= bitonic.MAX_BLOCK_STAGES
            for top, _, b in x.stages:
                assert top - bitonic.ROUND_BITS < b <= top < logt
    counts = bitonic.plan_counts(launches, 0)
    levels = logn - logt
    assert counts["block"] == 1 + levels
    r = bitonic.GROUP_DISTANCES[nk]
    assert counts["global"] == sum(-(-d // r) for d in range(1, levels + 1))


def test_block_rounds_open_a_window_only_when_a_stage_leaves_it():
    first = bitonic.plan(1 << 14, 1 << 14, 1)[0]
    tops = [t for t, _ in itertools.groupby(st[0] for st in first.stages)]
    assert all(a != b for a, b in zip(tops, tops[1:]))
    assert len(tops) == 29  # 105 stages of the first pass at a tile of 16384
    later = bitonic.plan(1 << 15, 1 << 14, 1)[-1]
    assert [t for t, _ in itertools.groupby(st[0] for st in later.stages)] == [13, 9, 5, 3]


# Launches of the three contract shapes on an H100 (PERF.md, PR 4): the
# engine tile is 16384 for one key plane and 8192 for two.
CONTRACT_LAUNCHES = [
    (1 << 22, 1, 0, {"block": 9, "global": 12, "gather": 0}),  # u32 keys
    (1_398_101, 1, 1, {"block": 8, "global": 10, "gather": 1}),  # stable u32 kv
    (838_860, 2, 1, {"block": 8, "global": 10, "gather": 1}),  # u64 keys, u64 payload
]


@pytest.mark.parametrize("n,nk,npayloads,want", CONTRACT_LAUNCHES)
def test_plan_launch_counts_at_the_contract_shapes(n, nk, npayloads, want):
    tile = bitonic.block_tile(nk, torch.device("cpu"))  # the H100's limits
    assert tile == (16384 if nk == 1 else 8192)
    launches = bitonic.plan(bitonic._padded_size(n), tile, nk)
    assert bitonic.plan_counts(launches, npayloads) == want


@pytest.mark.parametrize("logt", range(10, 16))
def test_round_thread_bits_are_a_bijection_on_distinct_banks(logt):
    for top in range(bitonic.ROUND_BITS - 1, logt):
        lo = top - bitonic.ROUND_BITS + 1
        pos = bitonic.thread_bit_positions(top, logt)
        assert sorted(pos + list(range(lo, top + 1))) == list(range(logt))
        for m in range(1 << bitonic.ROUND_BITS):  # one shared-memory access of a warp
            slots = [bitonic.swizzle(sum(((lane >> k) & 1) << p for k, p in enumerate(pos[:5]))
                                     | (m << lo)) for lane in range(32)]
            assert len({s & 31 for s in slots}) == 32
    assert sorted(bitonic.swizzle(i) for i in range(1 << logt)) == list(range(1 << logt))


SCHEDULE_CASES = [  # (n, key dtype, distribution, value dtypes, tile)
    (100, np.uint32, "max", (np.uint32,), 64),
    (5000, np.int64, "max", (np.uint64, np.float32), 64),
    (16384, np.uint32, "uniform", (np.int32,), 1024),
    (3001, np.uint64, "descending", (), 256),
    (1024, np.int32, "constant", (np.float64,), 1024),
]


@pytest.mark.parametrize("n,dt,dist,vdts,tile", SCHEDULE_CASES,
                         ids=[f"{c[0]}-{c[1].__name__}-{c[2]}-t{c[4]}" for c in SCHEDULE_CASES])
def test_scheduled_plain_matches_the_network(n, dt, dist, vdts, tile):
    keys = _t(_keys(n + tile, n, dt, dist))
    vals = tuple(_t(_values(n + j, n, v)) for j, v in enumerate(vdts))
    sk, sv = bitonic.scheduled_sort_plain(keys, vals, tile=tile)
    pk, pv = bitonic.bitonic_sort_block_plain(keys, vals, stable=True)
    _eq(sk, pk.numpy())
    for s, p in zip(sv, pv):
        _eq(s, p.numpy())


@pytest.mark.parametrize("i", range(len(KEY_CASES)),
                         ids=[f"{c[0]}-{c[1].__name__}-{c[2]}" for c in KEY_CASES])
def test_scheduled_plain_keys_match_jax(jax_blocks, i):
    keys, _, jk, _ = jax_blocks[("keys", i)]
    sk, _ = bitonic.scheduled_sort_plain(_t(keys), tile=64)
    _eq(sk, jk)


@pytest.mark.parametrize("i", range(len(PAIR_CASES)),
                         ids=[f"{c[0]}-{c[1].__name__}-{c[2]}-{len(c[3])}v" for c in PAIR_CASES])
def test_scheduled_plain_pairs_match_jax(jax_blocks, i):
    keys, vals, jk, jv = jax_blocks[("pairs", i)]
    sk, sv = bitonic.scheduled_sort_plain(_t(keys), tuple(map(_t, vals)), tile=64)
    _eq(sk, jk)
    for s, j in zip(sv, jv):
        _eq(s, j)


def test_the_engine_never_runs_the_schedule_in_plain_torch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("scheduled_sort_plain is for the tests only")

    monkeypatch.setattr(bitonic, "scheduled_sort_plain", refuse)
    keys = _keys(3, 3000, np.uint32, "max")
    ok, _ = bitonic.bitonic_sort_block(_t(keys))
    _eq(ok, np.sort(keys))
    out = vt.sort(_t(keys), backend="bitonic")
    _eq(out, np.sort(keys))


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="powers of two"):
        bitonic.plan(3000, 8192, 1)
    with pytest.raises(ValueError, match="1 or 2 key planes"):
        bitonic.plan(1 << 12, 1024, 3)
    with pytest.raises(ValueError, match="tile must lie"):
        bitonic.plan(1 << 20, 1 << 16, 1)
