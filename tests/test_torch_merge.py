"""The PyTorch port's merge engine (ops/merge.py) on CPU tensors, where the
wrappers run the kernels' plain versions, held against the JAX engine.

Tolerance: exact (bitwise). A stable sort has one right answer and the
split points are integers. The two calls of the JAX engine in Pallas
interpret mode (about 12 s and 8 s on one core) run once each, in
module-scoped fixtures; every other case is held against the JAX library
path (``backend="tiled"``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
from vkradixsort_tpu.ops import merge as jmerge
import vkradixsort_tpu_torch as vt
from vkradixsort_tpu_torch.ops import merge
from vkradixsort_tpu_torch.parallel import distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


T = 4096  # the JAX engine's tile at tile_rows=2, and the port's tile here
I32_MAX = np.iinfo(np.int32).max


def _runs_sorted(rng, n, run, nck):
    """nck int32 planes with heavy ties and pad-valued keys, each run of
    ``run`` elements sorted lexicographically (ascending)."""
    planes = [rng.integers(-3, 3, size=n).astype(np.int32) for _ in range(nck)]
    for p in planes:
        p[rng.random(n) < 0.1] = I32_MAX
    for s in range(0, n, run):
        order = np.lexsort(tuple(p[s:s + run] for p in planes[::-1]))
        for p in planes:
            p[s:s + run] = p[s:s + run][order]
    return planes


def _jax_layout(planes, run, npad, buflen):
    """The JAX engine's storage at the level of ``run``: pad-sentinel tail to
    ``buflen``, every odd run of the first ``npad`` elements reversed
    (descending)."""
    out = []
    for p in planes:
        w = np.full(buflen, I32_MAX, np.int32)
        w[: p.size] = p
        for i, s in enumerate(range(0, npad, run)):
            if i % 2:
                e = min(s + run, npad)
                w[s:e] = w[s:e][::-1].copy()
        out.append(jnp.asarray(w))
    return out


@pytest.mark.parametrize("nck", [1, 2])
@pytest.mark.parametrize("run", [T, 4 * T])
def test_level_splits_match_jax(rng, nck, run):
    # 3 full run pairs at run=T plus a ragged tail; at 4T the one pair has
    # a partial B run
    n = 6 * T + 1234
    planes = _runs_sorted(rng, n, run, nck)
    npad = -(-n // T) * T
    buflen = npad + 2 * T
    meta = np.asarray(
        jmerge._level_splits(_jax_layout(planes, run, npad, buflen), nck, run, T, npad,
                             buflen // T)
    )
    ntiles = -(-n // T)
    starts = np.arange(ntiles) * T
    run_a = starts // (2 * run) * (2 * run)
    want = meta[:ntiles, 0] + meta[:ntiles, 1] - run_a
    got = merge.level_splits_plain([torch.from_numpy(p) for p in planes], nck, run, T)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nck", [1, 2])
@pytest.mark.parametrize("run", [T, 2 * T, 4 * T])
def test_coranks_match_jax(rng, nck, run):
    # the kernel's 32-probe search, mirrored, against the JAX engine's
    # binary search (_level_splits) and the plain split points
    n = 6 * T + 1234
    planes = _runs_sorted(rng, n, run, nck)
    npad = -(-n // T) * T
    buflen = npad + 2 * T
    meta = np.asarray(
        jmerge._level_splits(_jax_layout(planes, run, npad, buflen), nck, run, T, npad,
                             buflen // T)
    )
    ntiles = -(-n // T)
    run_a = np.arange(ntiles) * T // (2 * run) * (2 * run)
    want = meta[:ntiles, 0] + meta[:ntiles, 1] - run_a
    tplanes = [torch.from_numpy(p) for p in planes]
    got = merge.coranks_plain(tplanes, nck, run, T)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), merge.level_splits_plain(tplanes, nck, run, T))


def _tie_runs(rng, n, run, nck, kind):
    """nck int32 planes of one kind of tie-heavy keys, each run sorted:
    "equal" (all alike), "two" (two values), "sentinel" (INT32_MIN and
    INT32_MAX only)."""
    if kind == "equal":
        planes = [np.full(n, -5, np.int32) for _ in range(nck)]
    elif kind == "two":
        planes = [rng.integers(0, 2, size=n).astype(np.int32) for _ in range(nck)]
    else:
        planes = [np.where(rng.random(n) < 0.5, np.iinfo(np.int32).min, I32_MAX).astype(np.int32)
                  for _ in range(nck)]
    return merge.tilesort_plain([torch.from_numpy(p) for p in planes], nck, run)


@pytest.mark.parametrize("nck", [1, 2])
@pytest.mark.parametrize("kind", ["equal", "two", "sentinel"])
@pytest.mark.parametrize("run,tile", [(64, 64), (256, 64), (1024, 128), (4096, 4)])
def test_coranks_on_tie_heavy_keys(rng, nck, kind, run, tile):
    # runs from the output tile up; ragged, with a partial last pair
    n = 5 * run + 37
    planes = _tie_runs(rng, n, run, nck, kind)
    got = merge.coranks_plain(planes, nck, run, tile)
    assert torch.equal(got, merge.level_splits_plain(planes, nck, run, tile))


@pytest.fixture(scope="module")
def jax_engine_u64_kv():
    """u64 keys with heavy ties and keys equal to the pad sentinel (both
    planes INT32_MAX), two 4-byte payloads, a ragged last tile: two compare
    and two carry planes, through the JAX engine in interpret mode. Its seed
    as wide as the tile replaces the Pallas tile sort (whose interpret-mode
    compile alone takes about 30 s on one core), so the call runs the merge
    kernel on stable, tile-sorted runs."""
    rng = np.random.default_rng(0x5EED)
    n = 9000
    keys = rng.integers(0, 4, size=n).astype(np.uint64) * np.uint64(0x5555555555555555)
    keys[rng.random(n) < 0.2] = np.uint64(2**64 - 1)
    vals = (rng.integers(0, 2**32, size=n, dtype=np.uint32),
            rng.standard_normal(n).astype(np.float32))
    out_k, out_v = jmerge.sort_merge(
        jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals), tile_rows=2, interpret=True,
        segseed=T,
    )
    return (keys, vals), (np.asarray(out_k),) + tuple(np.asarray(v) for v in out_v)


def test_sort_merge_matches_jax_engine(jax_engine_u64_kv):
    (keys, vals), want = jax_engine_u64_kv
    out_k, out_v = merge.sort_merge(
        torch.from_numpy(keys), tuple(torch.from_numpy(v) for v in vals), tile=T
    )
    for got, w in zip((out_k,) + out_v, want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("tile", [3000, 1 << 21])
def test_any_grain_matches_jax_engine(jax_engine_u64_kv, tile):
    # a grain the JAX package takes (it floors any grain to a power of two),
    # through the public API: the port floors it too and caps it at the
    # largest tile one block sorts, 16384 on the H100 (on the CPU as well),
    # and gives the JAX engine's stable result
    (keys, vals), want = jax_engine_u64_kv
    ok, ov = vt.sort_pairs(torch.from_numpy(keys), tuple(torch.from_numpy(v) for v in vals),
                           config=vt.SortConfig(tile=tile), backend="merge")
    for got, w in zip((ok,) + ov, want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize(
    "n,key_dtype,payloads",
    [
        (0, np.uint32, (np.uint32,)),
        (1, np.uint32, (np.uint32,)),
        (T, np.uint32, (np.uint32,)),
        (5 * T + 17, np.uint32, (np.uint32,)),  # the main path's plane layout
        (5 * T + 17, np.uint32, ()),
        (3 * T + 1, np.uint32, (np.float32, np.int32)),
        (3 * T + 1, np.uint64, (np.uint32,)),
        (3 * T + 1, np.uint32, (np.float64,)),
        (3 * T + 1, np.uint64, (np.float64,)),  # two key and two carry planes
        # past the kernels' two carry planes: one local index, then gathers
        (3 * T + 1, np.uint32, (np.int32, np.int32, np.int32)),
        (3 * T + 1, np.uint32, (np.float64, np.float64)),
        (3 * T + 1, np.uint64, (np.uint64, np.int32)),
        (0, np.uint32, (np.int32, np.int32, np.int32)),
        (1, np.uint64, (np.float64, np.float64)),
    ],
)
def test_sort_merge_matches_jax_tiled(rng, n, key_dtype, payloads):
    hi = int(np.iinfo(key_dtype).max)
    keys = rng.integers(0, 8, size=n).astype(key_dtype)
    keys[rng.random(n) < 0.2] = hi  # the pad sentinel's value
    vals = [rng.integers(0, 1 << 30, size=n).astype(d) for d in payloads]
    out_k, out_v = merge.sort_merge(
        torch.from_numpy(keys), tuple(torch.from_numpy(v) for v in vals), tile=T
    )
    if vals:
        jk, jv = vk.sort_pairs(jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals),
                               backend="tiled")
    else:
        jk, jv = vk.sort(jnp.asarray(keys), backend="tiled"), ()
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(jk))
    for o, j in zip(out_v, jv):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))


@pytest.mark.parametrize("key_dtype,payloads", [(np.uint32, (np.float32, np.uint64)),
                                                (np.uint32, (np.int32, np.int32, np.int32)),
                                                (np.uint64, (np.float64, np.float64)),
                                                (np.uint64, (np.uint32,))])
def test_wide_payload_sets_descending_match_jax_tiled(rng, key_dtype, payloads):
    # the public entry on the merge engine, descending, ragged: the payload
    # sets past two carry planes (a local index and a gather each) and one
    # that rides through the kernels, as JAX's tiled sort orders them
    n = 3 * T + 5
    keys = rng.integers(0, 8, size=n).astype(key_dtype)
    keys[rng.random(n) < 0.2] = np.iinfo(key_dtype).max
    vals = [rng.integers(0, 1 << 30, size=n).astype(d) for d in payloads]
    ok, ov = vt.sort_pairs(torch.from_numpy(keys), tuple(torch.from_numpy(v) for v in vals),
                           backend="merge", descending=True, config=vt.SortConfig(tile=T))
    jk, jv = vk.sort_pairs(jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals),
                           backend="tiled", descending=True)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jk))
    assert len(ov) == len(vals)
    for o, j in zip(ov, jv):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def jax_engine_wide_payloads():
    """``tests/test_merge.py``'s case of a float32 and a u64 payload (three
    carry planes) through the JAX engine in interpret mode, Pallas tile sort
    included: keys below 2^16, n = 20000."""
    rng = np.random.default_rng(0xC0FFEE)
    n = 20_000
    keys = rng.integers(0, 1 << 16, size=n, dtype=np.uint32)
    vals = (rng.standard_normal(n).astype(np.float32),
            rng.integers(0, 1 << 63, size=n, dtype=np.uint64))
    out_k, out_v = jmerge.sort_merge(jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals),
                                     tile_rows=2, interpret=True)
    return (keys, vals), (np.asarray(out_k),) + tuple(np.asarray(v) for v in out_v)


def test_wide_payloads_match_jax_engine(jax_engine_wide_payloads):
    (keys, vals), want = jax_engine_wide_payloads
    ok, ov = vt.sort_pairs(torch.from_numpy(keys), tuple(torch.from_numpy(v) for v in vals),
                           backend="merge")
    for got, w in zip((ok,) + ov, want):
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("payloads,index_planes", [
    ((np.float32, np.uint64), 1), ((np.int32,) * 3, 1), ((np.float64, np.float64), 1),
    ((np.float64,), 0), ((np.float32, np.uint64), 2)])
def test_carry_planes_direct_or_by_index(rng, monkeypatch, payloads, index_planes):
    # up to two int32 planes ride through the kernels; past them one local
    # index does, int32 below INDEX32_LIMIT and (hi, lo) from it (the limit
    # is lowered here to reach the int64 form); unpack undoes either form
    n = 3000
    vals = [torch.from_numpy(rng.integers(0, 1 << 62, size=n).astype(d)) for d in payloads]
    if index_planes == 2:
        monkeypatch.setattr(merge, "INDEX32_LIMIT", n)
    planes, unpack = merge.carry_planes(vals, n, torch.device("cpu"))
    if index_planes:
        assert len(planes) == index_planes and all(p.dtype == torch.int32 for p in planes)
    else:
        assert len(planes) == sum(v.element_size() // 4 for v in vals)
    key = torch.from_numpy(rng.integers(0, 50, size=n).astype(np.int32))
    out = merge.sort_merge_planes([key] + planes, 1, tile=1024)
    perm = torch.sort(key, stable=True).indices
    got = unpack(out[1:])
    assert torch.equal(out[0], key[perm]) and len(got) == len(vals)
    for g, v in zip(got, vals):
        assert g.dtype == v.dtype and torch.equal(g, v[perm])


@pytest.mark.parametrize("kdt", [np.int32, np.int64])
@pytest.mark.parametrize("npay", [0, 1, 2, 3])
def test_idx_sort_merge_equals_idx_sort_through_carry_planes(rng, monkeypatch, kdt, npay):
    # the distributed sort's (key, gidx) sort on the merge engine lays its
    # payloads out through merge.carry_planes, and equals the library form
    calls = []
    real = merge.carry_planes
    monkeypatch.setattr(merge, "carry_planes", lambda *a: calls.append(len(a[0])) or real(*a))
    n = 5000
    keys = torch.from_numpy(rng.integers(-4, 4, size=n).astype(kdt))
    keys[::7] = torch.iinfo(keys.dtype).max
    gidx = torch.from_numpy(rng.permutation(n).astype(np.int32))
    vals = [torch.from_numpy(rng.integers(0, 1 << 30, size=n).astype(d))
            for d in (np.int32, np.float32, np.uint32)[:npay]]
    a = distributed._idx_sort(keys, gidx, vals)
    b = distributed._idx_sort_merge(keys, gidx, vals)
    assert calls == [npay]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and len(b[2]) == npay
    for x, y in zip(a[2], b[2]):
        assert x.dtype == y.dtype and torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("key_dtype,payloads", [(np.uint32, (np.uint32,)),
                                                (np.uint64, (np.float32, np.int32))])
def test_default_tile_matches_jax_tiled(rng, key_dtype, payloads):
    # the default tile (16384) through two merge levels gives the JAX
    # package's stable result
    n = 2 * 16384 + 5
    keys = rng.integers(0, 64, size=n).astype(key_dtype)
    keys[rng.random(n) < 0.1] = np.iinfo(key_dtype).max
    vals = [rng.integers(0, 1 << 30, size=n).astype(d) for d in payloads]
    assert merge.default_tile(keys.itemsize // 4, torch.device("cpu")) == 16384
    out_k, out_v = merge.sort_merge(torch.from_numpy(keys), tuple(torch.from_numpy(v) for v in vals))
    jk, jv = vk.sort_pairs(jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals), backend="tiled")
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(jk))
    for o, j in zip(out_v, jv):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))


def test_plain_kernels_compose_to_stable_sort(rng):
    # the plain tile sort and every plain merge level, driven by hand, give
    # numpy's stable order; tile 4096 over 5 tiles -> 3 merge levels
    n = 5 * T - 3
    keys = rng.integers(-5, 5, size=n).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)
    planes = merge.tilesort_plain([torch.from_numpy(keys), torch.from_numpy(pos)], 1, T)
    for s in range(0, n, T):
        tile = planes[0][s:s + T].numpy()
        assert (tile[1:] >= tile[:-1]).all()
    run, levels = T, 0
    while run < n:
        planes = merge.mergepath_level_plain(planes, 1, run)
        run, levels = run * 2, levels + 1
    assert levels == 3
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(planes[0].numpy(), keys[perm])
    np.testing.assert_array_equal(planes[1].numpy(), perm)


def test_default_tile_from_shared_memory():
    # the largest power of two whose slots (8 bytes an element for one key
    # plane, 10 for two, 14 for three) and digit counters (1 KB per warp of
    # 16 x 32 elements) fit one block's 232,448 B on the H100, within 1024
    # threads (512 at three key planes)
    cpu = torch.device("cpu")
    assert merge.default_tile(1, cpu) == 16384
    assert merge.default_tile(2, cpu) == 16384
    assert merge.default_tile(3, cpu) == 8192
    assert merge.tilesort_smem(1, 8192) == 80 * 1024
    assert merge.tilesort_smem(1, 16384) == 160 * 1024
    assert merge.tilesort_smem(2, 16384) == 192 * 1024
    assert merge.tilesort_smem(3, 8192) == 128 * 1024
    assert merge.tilesort_smem(3, 16384) > merge.H100_SMEM_PER_BLOCK_OPTIN
    assert merge.tilesort_smem(1, 64) == 512 + 8 * 1024  # 256 threads at least
    for nck in (1, 2, 3):
        tile = merge.default_tile(nck, cpu)
        assert merge.tilesort_smem(nck, tile) <= merge.H100_SMEM_PER_BLOCK_OPTIN
        assert 2 * tile > merge.tilesort_max_tile(nck) or (
            merge.tilesort_smem(nck, 2 * tile) > merge.H100_SMEM_PER_BLOCK_OPTIN)
    # the merge kernel's output tile for each plane count: two staged tiles
    # of every plane fit one block
    for nplanes in (1, 2, 3, 4, 5):
        tile = merge.MERGE_TILES[nplanes]
        assert merge.mergepath_smem(nplanes, tile) <= merge.H100_SMEM_PER_BLOCK_OPTIN


def test_wrappers_reject_what_the_kernels_do_not_take():
    good = [torch.zeros(8, dtype=torch.int32)]
    with pytest.raises(ValueError):
        merge.tilesort(good, 1, 6)  # not a power of two
    with pytest.raises(ValueError):
        merge.mergepath_level([torch.zeros(8, dtype=torch.int64)], 1, 4)
    with pytest.raises(ValueError):
        merge.tilesort(good, 3, 4)
    meta = [torch.zeros(8, dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="CUDA"):
        merge.tilesort(meta, 1, 4)  # neither the CPU's plain version nor a kernel
    with pytest.raises(TypeError):
        merge.sort_merge(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        merge.sort_merge(torch.zeros(4, dtype=torch.int32).view(torch.uint32),
                         (torch.zeros(4, dtype=torch.uint8),))
    with pytest.raises(TypeError):
        merge.sort_merge(torch.zeros(4, dtype=torch.int32).view(torch.uint32),
                         (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.float16)))
    # three carry planes: no longer refused, carried as a local index
    keys = torch.tensor([3, 1, 2, 1], dtype=torch.int32).view(torch.uint32)
    a, b = torch.arange(4, dtype=torch.int32), torch.arange(4, dtype=torch.int64) << 40
    ok, (oa, ob) = merge.sort_merge(keys, (a, b))
    assert ok.view(torch.int32).tolist() == [1, 1, 2, 3]
    assert oa.tolist() == [1, 3, 2, 0] and torch.equal(ob, b[oa.long()])


def test_planes_sentinel_valued_keys(rng):
    # keys equal to the INT32_MAX pad of a ragged tile must still sort
    # before the padding and exactly (the JAX engine's tests/test_merge.py
    # case, keys only, through the tile sort and two merge levels)
    n = 10_000
    keys = rng.integers(0, 3, size=n).astype(np.int32)
    keys[keys == 2] = I32_MAX
    (out,) = merge.sort_merge_planes([torch.from_numpy(keys)], 1, tile=T)
    np.testing.assert_array_equal(out.numpy(), np.sort(keys))
