"""The PyTorch port's samplesort engine (ops/samplesort.py) and the composite
search it uses (ops/common.py) on CPU tensors, where the placement wrapper
runs its plain version, held against the JAX engine on the same numpy
inputs: the geometry, splitters, bucket boundaries (the equal-run balancing
included), the composite search, the run placement against the JAX
placement kernel in Pallas interpret mode, the keys-only and stable
key-value pipelines end to end (the overflow fallback included), and the
public API through ``backend="samplesort"``.

Tolerance: exact (bitwise). Boundaries and geometry are integers, and a
sort has one answer (with payloads, the one stable answer). Each JAX
pipeline case runs once, in a module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
from vkradixsort_tpu.ops import common as jcommon
from vkradixsort_tpu.ops import samplesort as jss
from vkradixsort_tpu.utils.fixtures import make_keys
from vkradixsort_tpu_torch.ops import common, samplesort

import vkradixsort_tpu_torch as vt
from vkradixsort_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


SMALL = dict(tile_target=1 << 16, bucket_target=1 << 15)
N = 70_001


def launches(wrapper: str) -> int:
    """The launch counter of a kernel wrapper, ``launch.<wrapper>``."""
    return profiling.counters().get("launch." + wrapper, 0)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def _eq(got, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(common.bits_view(got).numpy().view(want.dtype), want)


def _keys(seed: int, n: int, dtype, dist: str) -> np.ndarray:
    """Seeded keys: the JAX package's fixtures ("uniform", "zipf",
    "constant", ...), or "sentinel" (uniform with every ninth key equal to
    the dtype's maximum, the padding sentinel)."""
    rng = np.random.default_rng(seed)
    if dist == "sentinel":
        keys = make_keys(rng, n, dtype, "uniform")
        keys[::9] = np.iinfo(dtype).max
        return keys
    return make_keys(rng, n, dtype, dist)


def _sorted_rows(seed: int, G: int, C: int, dtype, dist: str) -> np.ndarray:
    return np.sort(_keys(seed, G * C, dtype, dist).reshape(G, C), axis=1)


# ---------------------------------------------------------------------------
# geometry, splitters, boundaries


@pytest.mark.parametrize("n,tile,bucket,slack", [
    (1, 1 << 19, 1 << 19, 1.35), (N, 1 << 16, 1 << 15, 1.35), (100_000_000, 1 << 21, 1 << 21, 1.35),
    (100_000_000, 1 << 19, 1 << 19, 1.35), (123_457, 1 << 14, 1 << 12, 1.01),
    (5_000_000, 1 << 20, 1 << 16, 2.0),
])
def test_pick_geometry_matches_jax(n, tile, bucket, slack):
    assert samplesort._pick_geometry(n, tile, bucket, slack) == jss._pick_geometry(
        n, tile, bucket, slack)


def test_pick_geometry_of_the_1e8_pair_sort():
    assert samplesort._pick_geometry(100_000_000, 1 << 21, 1 << 21, 1.35) == (
        48, 2_083_456, 48, 58_752)


@pytest.mark.parametrize("dtype,dist,B,oversample", [
    (np.uint32, "uniform", 16, 4), (np.uint32, "zipf", 8, 32), (np.uint64, "uniform", 12, 3),
    (np.uint32, "constant", 8, 2),
])
def test_splitters_match_jax(dtype, dist, B, oversample):
    rows = _sorted_rows(5, 3, 2048, dtype, dist)
    got = samplesort._splitters(_t(rows), B, oversample)
    _eq(got, jss._splitters(jnp.asarray(rows), B, oversample))


def _check_bucket_starts(rows, spl, cap):
    starts, lens, overflow = samplesort._bucket_starts(_t(rows), _t(spl), cap)
    js, jl, jo = jss._bucket_starts(jnp.asarray(rows), jnp.asarray(spl), cap)
    assert starts.dtype == lens.dtype == torch.int32
    _eq(starts, np.asarray(js))
    _eq(lens, np.asarray(jl))
    assert bool(overflow) == bool(jo)
    return lens, bool(overflow)


def test_bucket_starts_balance_a_constant_row_as_jax():
    rows = np.full((1, 1024), 7, np.uint32)
    spl = np.full(7, 7, np.uint32)  # 8 buckets, every splitter inside the run
    lens, overflow = _check_bucket_starts(rows, spl, 256)
    assert not overflow
    np.testing.assert_array_equal(lens.numpy()[0], np.full(8, 128))


@pytest.mark.parametrize("dtype,dist,cap", [
    (np.uint32, "zipf", 4096), (np.uint32, "zipf", 200), (np.uint64, "uniform", 600),
    (np.uint32, "constant", 300),
])
def test_bucket_starts_match_jax(dtype, dist, cap):
    rows = _sorted_rows(9, 2, 2048, dtype, dist)
    spl = np.asarray(jss._splitters(jnp.asarray(rows), 16, 4))
    lens, _ = _check_bucket_starts(rows, spl, cap)
    assert (lens.numpy() >= 0).all()


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("batched", [False, True])
def test_composite_searchsorted_matches_jax(dtype, batched):
    rng = np.random.default_rng(11)
    G, n, q = (3, 1000, 40) if batched else (1, 1000, 40)
    k = rng.integers(0, 20, size=(G, n)).astype(dtype)
    k[:, ::7] = np.iinfo(dtype).max
    g = rng.permutation(G * n).astype(np.int32).reshape(G, n)
    order = np.lexsort((g, k), axis=1)
    k, g = np.take_along_axis(k, order, 1), np.take_along_axis(g, order, 1)
    qk = np.concatenate([k[0, ::50][:q - 2], np.array([0, np.iinfo(dtype).max], dtype)])
    qg = np.concatenate([g[0, ::50][:q - 2] + 1, np.array([-5, np.iinfo(np.int32).max], np.int32)])
    if batched:
        got = common.composite_searchsorted(_t(k), _t(g), _t(qk), _t(qg))
        want = np.stack([np.asarray(jcommon.composite_searchsorted(
            jnp.asarray(k[i]), jnp.asarray(g[i]), jnp.asarray(qk), jnp.asarray(qg)))
            for i in range(G)])
    else:
        got = common.composite_searchsorted(_t(k[0]), _t(g[0]), _t(qk), _t(qg))
        want = np.asarray(jcommon.composite_searchsorted(
            jnp.asarray(k[0]), jnp.asarray(g[0]), jnp.asarray(qk), jnp.asarray(qg)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.uint32, np.int64,
                                   np.uint64])
def test_pad_sentinel_and_pad_to_match_jax(dtype):
    tdtype = _t(np.zeros(1, dtype)).dtype
    assert common.pad_sentinel(tdtype) == int(jcommon.pad_sentinel(dtype))
    keys = np.arange(1, 8, dtype=dtype)
    _eq(common.pad_to(_t(keys), 12), jcommon.pad_to(jnp.asarray(keys), 12))
    _eq(common.pad_to(_t(keys), 7), keys)


# ---------------------------------------------------------------------------
# run placement against the JAX placement kernel (interpret mode)

PLACE_CASES = [  # (dtype, G, C, B, cap, dist)
    (np.uint32, 3, 4096, 8, 896, "zipf"),
    (np.uint64, 2, 3072, 8, 640, "uniform"),
    (np.int32, 2, 2048, 8, 384, "uniform"),
]


@pytest.fixture(scope="module")
def jax_placements():
    """For every case: the sorted rows, the runs of their balanced bucket
    boundaries, and the JAX placement of the runs from their starts
    floored to 1024 into slots of width capw, as its pipeline calls it."""
    out = {}
    for i, (dtype, G, C, B, cap, dist) in enumerate(PLACE_CASES):
        rows = _sorted_rows(20 + i, G, C, np.uint32 if dtype == np.int32 else dtype, dist)
        spl = jss._splitters(jnp.asarray(rows), B, 4)
        starts, lens, overflow = jss._bucket_starts(jnp.asarray(rows), spl, cap)
        assert not bool(overflow)
        rows = rows.astype(dtype) if dtype == np.int32 else rows
        capw = jcommon.round_up(cap + jss.ALIGN, jss.ALIGN)
        row_ext = jcommon.round_up(C + capw, jss.ALIGN)
        fill = np.iinfo(dtype).max
        flat = np.full((G, row_ext), fill, dtype)
        flat[:, :C] = rows
        starts, lens = np.asarray(starts), np.asarray(lens)
        astarts = (starts // jss.ALIGN) * jss.ALIGN
        slots = jss._place_runs(jnp.asarray(flat.reshape(-1)), jnp.asarray(astarts), G, B, capw,
                                interpret=True)
        out[i] = rows, starts, lens, np.asarray(slots), starts - astarts
    return out


@pytest.mark.parametrize("i", range(len(PLACE_CASES)),
                         ids=[f"{c[0].__name__}-G{c[1]}-B{c[3]}" for c in PLACE_CASES])
def test_place_runs_match_jax_on_the_valid_windows(jax_placements, i):
    rows, starts, lens, jslots, pre = jax_placements[i]
    dtype, G, C, B, cap, _ = PLACE_CASES[i]
    fill = 0x5A5A if dtype == np.int32 else int(np.iinfo(dtype).max)
    before = launches("place_runs")
    (slots,) = samplesort.place_runs([_t(rows)], _t(starts.astype(np.int32)),
                                     _t(lens.astype(np.int32)), cap, [fill])
    assert launches("place_runs") == before  # CPU: the plain version
    assert tuple(slots.shape) == (B, G, cap) and slots.is_contiguous()
    got = common.bits_view(slots).numpy().view(dtype)
    for b in range(B):
        for g in range(G):
            ln, p = lens[g, b], pre[g, b]
            np.testing.assert_array_equal(got[b, g, :ln], jslots[b, g, p:p + ln])
            assert (got[b, g, ln:] == dtype(fill)).all()


def test_place_runs_moves_three_planes_with_their_fills():
    rng = np.random.default_rng(3)
    G, C, B, cap = 2, 512, 4, 200
    k = np.sort(rng.integers(0, 1 << 60, size=(G, C), dtype=np.uint64), axis=1)
    g = rng.integers(0, 1 << 30, size=(G, C)).astype(np.int32)
    v = rng.standard_normal((G, C)).astype(np.float32)
    bounds = np.array([[100, 250, 400], [128, 256, 384]], np.int32)
    starts = np.concatenate([np.zeros((G, 1), np.int32), bounds], 1)
    lens = np.concatenate([bounds, np.full((G, 1), C, np.int32)], 1) - starts
    outs = samplesort.place_runs([_t(k), _t(g), _t(v)], _t(starts), _t(lens), cap,
                                 [2**64 - 1, 2**31 - 1, 0])
    for plane, out, fill in zip((k, g, v), outs, (np.iinfo(np.uint64).max, 2**31 - 1, 0)):
        o = common.bits_view(out).numpy().view(plane.dtype)
        for b in range(B):
            for r in range(G):
                s, ln = starts[r, b], lens[r, b]
                np.testing.assert_array_equal(o[b, r, :ln], plane[r, s:s + ln])
                assert (o[b, r, ln:] == plane.dtype.type(fill)).all()


def test_place_runs_refuses_what_the_kernel_does_not_take():
    rows = torch.zeros((2, 256), dtype=torch.int32)
    st = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        samplesort.place_runs([rows, rows], st, st, 64, [0, 0])
    with pytest.raises(ValueError):
        samplesort.place_runs([rows], st.to(torch.int64), st, 64, [0])
    with pytest.raises(ValueError):
        samplesort.place_runs([rows], st, st, 512, [0])
    meta = torch.zeros((2, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        samplesort.place_runs([meta], st.to("meta"), st.to("meta"), 64, [0])


# ---------------------------------------------------------------------------
# the pipelines end to end

KEY_PIPELINE = [(np.uint32, "uniform"), (np.uint32, "zipf"), (np.uint32, "constant"),
                (np.uint64, "uniform"), (np.uint32, "sentinel")]
PAIR_PIPELINE = [(np.uint32, "uniform"), (np.uint32, "zipf"), (np.uint32, "constant"),
                 (np.uint64, "zipf"), (np.uint32, "sentinel")]
FORCED = dict(tile_target=1 << 14, bucket_target=1 << 12, oversample=1, slack=1.01)


@pytest.fixture(scope="module")
def jax_pipelines():
    out = {}
    for i, (dt, dist) in enumerate(KEY_PIPELINE):
        keys = _keys(40 + i, N, dt, dist)
        out[("keys", i)] = keys, np.asarray(jss.sort_samplesort(jnp.asarray(keys), interpret=True,
                                                                **SMALL))
    for i, (dt, dist) in enumerate(PAIR_PIPELINE):
        keys = _keys(50 + i, N, dt, dist)
        if dist != "sentinel":
            keys = keys % dt(997)  # heavy ties
        vals = np.arange(1, N + 1, dtype=np.uint32)
        jk, jv, jo = jss.sort_pairs_samplesort(jnp.asarray(keys), jnp.asarray(vals),
                                               interpret=True, _debug_overflow=True, **SMALL)
        out[("pairs", i)] = (keys, vals), (np.asarray(jk), np.asarray(jv), bool(jo))
    keys = _keys(60, 60_000, np.uint32, "zipf")
    out["forced_keys"] = keys, np.asarray(jss.sort_samplesort(jnp.asarray(keys), interpret=True,
                                                              **FORCED))
    vals = np.arange(keys.size, dtype=np.uint32)
    jk, jv, jo = jss.sort_pairs_samplesort(jnp.asarray(keys), jnp.asarray(vals), interpret=True,
                                           _debug_overflow=True, **FORCED)
    out["forced_pairs"] = (keys, vals), (np.asarray(jk), np.asarray(jv), bool(jo))
    return out


@pytest.mark.parametrize("i", range(len(KEY_PIPELINE)),
                         ids=[f"{c[0].__name__}-{c[1]}" for c in KEY_PIPELINE])
def test_sort_samplesort_matches_jax(jax_pipelines, i):
    keys, want = jax_pipelines[("keys", i)]
    before = launches("place_runs")
    _eq(samplesort.sort_samplesort(_t(keys), **SMALL), want)
    _eq(samplesort.sort_samplesort(_t(keys), **SMALL), np.sort(keys))
    assert launches("place_runs") == before


@pytest.mark.parametrize("i", range(len(PAIR_PIPELINE)),
                         ids=[f"{c[0].__name__}-{c[1]}" for c in PAIR_PIPELINE])
def test_sort_pairs_samplesort_matches_jax(jax_pipelines, i):
    (keys, vals), (jk, jv, jo) = jax_pipelines[("pairs", i)]
    ok, ov, overflow = samplesort.sort_pairs_samplesort(_t(keys), _t(vals), _debug_overflow=True,
                                                        **SMALL)
    assert overflow == jo is False  # the pipeline, not the flat fallback
    _eq(ok, jk)
    _eq(ov, jv)
    perm = np.argsort(keys, kind="stable")
    _eq(ov, vals[perm])


def test_forced_overflow_falls_back_as_jax(jax_pipelines):
    keys, want = jax_pipelines["forced_keys"]
    _eq(samplesort.sort_samplesort(_t(keys), **FORCED), want)
    (keys, vals), (jk, jv, jo) = jax_pipelines["forced_pairs"]
    ok, ov, overflow = samplesort.sort_pairs_samplesort(_t(keys), _t(vals), _debug_overflow=True,
                                                        **FORCED)
    assert overflow == jo is True
    _eq(ok, jk)
    _eq(ov, jv)


def test_keys_only_padding_spreads_over_the_rows(monkeypatch):
    # G = 65 rows of C = 1024 hold 65,537 keys and 1,023 sentinel pads. In
    # contiguous rows (the JAX layout) every pad sits in the last row's last
    # bucket, past its cap of 384, so the JAX pipeline falls back to a flat
    # sort; the port's interleaved rows place the runs.
    n, grain = 65_537, dict(tile_target=1 << 10, bucket_target=1 << 15)
    G, C, B, cap = jss._pick_geometry(n, 1 << 10, 1 << 15, 1.35)
    assert (G, C, B, cap) == (65, 1024, 8, 384)
    keys = _keys(90, n, np.uint32, "uniform")
    rows = jss._scan_sort_rows(jcommon.pad_to(jnp.asarray(keys), G * C).reshape(G, C))
    assert bool(jss._bucket_starts(rows, jss._splitters(rows, B, 32), cap)[2])

    def refuse(*a, **k):
        raise AssertionError("the flat fallback ran")

    monkeypatch.setattr(samplesort.segsort, "sort_flat", refuse)
    _eq(samplesort.sort_samplesort(_t(keys), **grain), np.sort(keys))


def test_samplesort_refusals():
    k = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(TypeError, match="4- or 8-byte"):
        samplesort.sort_pairs_samplesort(k, torch.zeros(8, dtype=torch.int16))
    # a stride-0 view stands in for 2^31 keys without allocating them
    big = torch.zeros(1, dtype=torch.int32).view(torch.uint32).expand(1 << 31)
    with pytest.raises(NotImplementedError, match="2\\^31"):
        samplesort.sort_samplesort(big)
    with pytest.raises(NotImplementedError, match="2\\^31"):
        samplesort.sort_pairs_samplesort(big, big)


# ---------------------------------------------------------------------------
# the public API through backend="samplesort"

TILE = 1 << 15


@pytest.fixture(scope="module")
def jax_api():
    jcfg = vk.SortConfig(interpret=True, tile=TILE)
    rng = np.random.default_rng(70)
    u32 = _keys(71, N, np.uint32, "zipf")
    f32 = (rng.standard_normal(N) * 20).round().astype(np.float32)
    f32[:5] = [-0.0, 0.0, np.inf, -np.inf, np.nan]
    i64 = _keys(72, N, np.int64, "uniform")
    v32 = np.arange(N, dtype=np.uint32)
    out = {}
    for desc in (False, True):
        out[("kv", desc)] = (u32, v32), vk.sort_pairs(
            jnp.asarray(u32), jnp.asarray(v32), config=jcfg, backend="samplesort",
            descending=desc)
    out["argsort"] = f32, vk.argsort(jnp.asarray(f32), config=jcfg, backend="samplesort")
    out["sort"] = i64, vk.sort(jnp.asarray(i64), config=jcfg, backend="samplesort",
                               descending=True)
    return out


@pytest.mark.parametrize("descending", [False, True])
def test_api_sort_pairs_matches_jax(jax_api, descending):
    (k, v), (jk, jv) = jax_api[("kv", descending)]
    ok, ov = vt.sort_pairs(_t(k), _t(v), config=vt.SortConfig(tile=TILE), backend="samplesort",
                           descending=descending)
    _eq(ok, jk)
    _eq(ov, jv)


def test_api_argsort_and_sort_match_jax(jax_api):
    cfg = vt.SortConfig(tile=TILE)
    f32, jperm = jax_api["argsort"]
    perm = vt.argsort(_t(f32), config=cfg, backend="samplesort")
    assert perm.dtype == torch.uint32
    _eq(perm, jperm)
    i64, jsorted = jax_api["sort"]
    _eq(vt.sort(_t(i64), config=cfg, backend="samplesort", descending=True), jsorted)


@pytest.mark.parametrize("tile", [3000, 1 << 21])
def test_api_any_grain_matches_jax(jax_api, tile):
    # samplesort takes any grain the JAX package takes (its geometry divides
    # n by the grain, as JAX's does); the stable answer does not depend on it
    (k, v), (jk, jv) = jax_api[("kv", False)]
    ok, ov = vt.sort_pairs(_t(k), _t(v), config=vt.SortConfig(tile=tile), backend="samplesort")
    _eq(ok, jk)
    _eq(ov, jv)


def test_api_default_grain_and_tiny_inputs():
    rng = np.random.default_rng(80)
    keys = rng.integers(0, 50, size=5000).astype(np.int32)
    vals = rng.standard_normal(5000).astype(np.float64)
    ok, ov = vt.sort_pairs(_t(keys), _t(vals), backend="samplesort")
    perm = np.argsort(keys, kind="stable")
    _eq(ok, keys[perm])
    _eq(ov, vals[perm])
    for n in (0, 1):
        k = np.arange(n, dtype=np.uint32)
        _eq(vt.sort(_t(k), backend="samplesort"), k)
        _eq(vt.argsort(_t(k), backend="samplesort"), k)


def test_two_payloads_refused_on_both_sides():
    k = np.zeros(8, np.uint32)
    with pytest.raises(NotImplementedError, match="single payload"):
        vt.sort_pairs(_t(k), (_t(k), _t(k)), backend="samplesort")
    with pytest.raises(NotImplementedError, match="single payload"):
        vk.sort_pairs(jnp.asarray(k), (jnp.asarray(k), jnp.asarray(k)), backend="samplesort",
                      config=vk.SortConfig(interpret=True))
