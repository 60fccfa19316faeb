"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips without one. On a machine with a card (where JAX need not be
installed, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: exact (bitwise). The kernels and the plain versions compute the
same stable order.
"""

import numpy as np
import pytest
import torch

import vkradixsort_tpu_torch as vt
from vkradixsort_tpu_torch.ops import (
    bitonic,
    common,
    fused,
    gather,
    histogram,
    merge,
    radix_tiled,
    reference,
    samplesort,
    segsort,
)
from vkradixsort_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

COMBOS = [(1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2)]  # (nck, ncarry)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def launches(wrapper: str) -> int:
    """The launch counter of a kernel wrapper, ``launch.<wrapper>``."""
    return profiling.counters().get("launch." + wrapper, 0)


def _planes(rng, n, nck, ncarry, dev):
    keys = [rng.integers(-4, 4, size=n).astype(np.int32) for _ in range(nck)]
    keys[0][rng.random(n) < 0.1] = np.iinfo(np.int32).max  # equal to the pad
    carry = [rng.integers(-(2**31), 2**31, size=n).astype(np.int32) for _ in range(ncarry)]
    return [torch.from_numpy(x).to(dev) for x in keys + carry]


def _equal(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == w.device and torch.equal(g, w)


def _tie_planes(rng, n, nck, ncarry, kind, dev):
    """Compare planes of one kind of tie-heavy keys: "equal" (every key
    alike), "two" (two values) or "sentinel" (INT32_MIN and INT32_MAX, the
    ends of the signed order), and random carry planes."""
    i32 = np.iinfo(np.int32)
    if kind == "equal":
        keys = [np.full(n, 7, np.int32) for _ in range(nck)]
    elif kind == "two":
        keys = [rng.integers(0, 2, size=n).astype(np.int32) for _ in range(nck)]
    else:
        keys = [np.where(rng.random(n) < 0.5, i32.min, i32.max).astype(np.int32)
                for _ in range(nck)]
    carry = [rng.integers(-(2**31), 2**31, size=n).astype(np.int32) for _ in range(ncarry)]
    return [torch.from_numpy(x).to(dev) for x in keys + carry]


@pytest.mark.parametrize("nck,ncarry", COMBOS)
@pytest.mark.parametrize("n,tile", [(1, 2), (4096, 4096), (3 * 8192 + 5, 8192),
                                    (2 * 16384 + 1, 16384), (1000, 64), (8191, 8192),
                                    (16385, 16384)])
def test_tilesort_kernel_matches_plain(dev, nck, ncarry, n, tile):
    rng = np.random.default_rng(n + 10 * nck + ncarry)
    planes = _planes(rng, n, nck, ncarry, dev)
    before = launches("tilesort")
    if merge.tilesort_smem(nck, tile) > merge.smem_limits(dev)[0]:  # 16384 at three planes
        with pytest.raises(ValueError, match="shared memory"):
            merge.tilesort(planes, nck, tile)
        return
    got = merge.tilesort(planes, nck, tile)
    assert launches("tilesort") == before + 1
    _equal(got, merge.tilesort_plain(planes, nck, tile))


@pytest.mark.parametrize("nck,ncarry", COMBOS)
@pytest.mark.parametrize("n,run", [(5, 2), (3000, 256), (5 * 4096 + 3, 4096),
                                   (3 * 16384, 16384), (40000, 32768),
                                   (4 * 4096 + 100, 4096),  # a lone last run of 100
                                   (2 * 16384 - 1, 16384), (4097, 4096)])
def test_mergepath_kernel_matches_plain(dev, nck, ncarry, n, run):
    rng = np.random.default_rng(n + run + nck)
    runs = merge.tilesort_plain(_planes(rng, n, nck, ncarry, dev), nck, run)
    before = launches("mergepath_level")
    got = merge.mergepath_level(runs, nck, run)
    assert launches("mergepath_level") == before + 1
    _equal(got, merge.mergepath_level_plain(runs, nck, run))


@pytest.mark.parametrize("nck,ncarry", COMBOS)
@pytest.mark.parametrize("kind", ["equal", "two", "sentinel"])
def test_merge_kernels_on_tie_heavy_keys(dev, nck, ncarry, kind):
    # the tile sort, then every merge level, each bitwise against its plain
    # version on the same input; ragged, so the last run pair is partial
    rng = np.random.default_rng(nck * 10 + ncarry)
    n = 5 * 8192 + 77
    planes = _tie_planes(rng, n, nck, ncarry, kind, dev)
    cur = merge.tilesort(planes, nck, 8192)
    _equal(cur, merge.tilesort_plain(planes, nck, 8192))
    run = 8192
    while run < n:
        nxt = merge.mergepath_level(cur, nck, run)
        _equal(nxt, merge.mergepath_level_plain(cur, nck, run))
        cur, run = nxt, 2 * run


@pytest.mark.parametrize("nck,ncarry", [(1, 1), (2, 2)])
def test_merge_tiles_do_not_change_the_result(dev, nck, ncarry):
    # tile-sort tiles 8192 and 16384, merge output tiles 4096 and 8192: one
    # stable result, the plain one
    rng = np.random.default_rng(40 + nck)
    n = 9 * 16384 + 5
    planes = _planes(rng, n, nck, ncarry, dev)
    want = merge.sort_merge_planes([p.cpu() for p in planes], nck, tile=8192)
    for tile in (8192, 16384):
        _equal([p.cpu() for p in merge.sort_merge_planes(planes, nck, tile=tile)], want)
    runs = merge.tilesort(planes, nck, 16384)
    level = merge.mergepath_level_plain(runs, nck, 16384)
    optin = vt.GPUContext(dev).info.smem_per_block_optin
    for out_tile in (4, 4096, 8192):
        if merge.mergepath_smem(len(runs), out_tile) > optin:
            with pytest.raises(ValueError, match="shared memory"):
                merge.mergepath_level(runs, nck, 16384, out_tile=out_tile)
            continue
        _equal(merge.mergepath_level(runs, nck, 16384, out_tile=out_tile), level)


@pytest.mark.parametrize("nck,ncarry", [(1, 1), (2, 2)])
def test_mergepath_kernel_takes_unaligned_planes(dev, nck, ncarry):
    # planes that start 4 bytes past a 16-byte line: every window's head and
    # tail go by plain loads around the bulk copies
    rng = np.random.default_rng(50 + nck)
    n = 3 * 4096 + 11
    base = _planes(rng, n + 1, nck, ncarry, dev)
    for b, r in zip(base, merge.tilesort_plain([p[1:] for p in base], nck, 2048)):
        b[1:] = r
    shifted = [p[1:] for p in base]
    assert all(p.data_ptr() % 16 == 4 for p in shifted)
    _equal(merge.mergepath_level(shifted, nck, 2048), merge.mergepath_level_plain(
        [p.clone() for p in shifted], nck, 2048))


def test_kernel_path_never_takes_the_plain_versions(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("tilesort_plain", "mergepath_level_plain", "coranks_plain",
                 "level_splits_plain"):
        monkeypatch.setattr(merge, name, refuse)
    rng = np.random.default_rng(7)
    n = (1 << 20) + 3
    keys = rng.integers(0, 1000, size=n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    before = (launches("tilesort"), launches("mergepath_level"))
    ok, ov = vt.sort_pairs(torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev),
                           backend="merge")
    assert launches("tilesort") == before[0] + 1 and launches("mergepath_level") > before[1]
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ok.cpu().numpy(), keys[perm])
    np.testing.assert_array_equal(ov.cpu().numpy(), perm.astype(np.uint32))
    # two key planes and two carry planes through the engine itself
    k64 = rng.integers(0, 50, size=n, dtype=np.uint64) << np.uint64(40)
    v64 = rng.standard_normal(n)
    ok, (ov,) = merge.sort_merge(torch.from_numpy(k64).to(dev), (torch.from_numpy(v64).to(dev),))
    perm = np.argsort(k64, kind="stable")
    np.testing.assert_array_equal(ok.cpu().numpy(), k64[perm])
    np.testing.assert_array_equal(ov.cpu().numpy(), v64[perm])


@pytest.mark.parametrize("key_dtype,payloads", [
    (np.uint32, (np.uint32,)),
    (np.float32, (np.float32, np.int32)),
    (np.uint64, (np.uint32,)),
    (np.int64, (np.float64,)),
    (np.float16, (np.uint32, np.uint32)),
])
@pytest.mark.parametrize("backend", [None, "merge", "tiled"])
def test_sort_pairs_cuda_matches_cpu(dev, key_dtype, payloads, backend):
    rng = np.random.default_rng(11)
    n = 70_001
    keys = (rng.integers(0, 50, size=n) - 25).astype(key_dtype)
    vals = [rng.integers(0, 1 << 30, size=n).astype(d) for d in payloads]
    cpu_k = torch.from_numpy(keys)
    cpu_v = [torch.from_numpy(v) for v in vals]
    for descending in (False, True):
        gk, gv = vt.sort_pairs(cpu_k.to(dev), [v.to(dev) for v in cpu_v], backend=backend,
                               descending=descending)
        ck, cv = vt.sort_pairs(cpu_k, cpu_v, backend="tiled", descending=descending)
        torch.cuda.synchronize()
        assert torch.equal(common.bits_view(gk).cpu(), common.bits_view(ck))
        for g, c in zip(gv, cv):
            assert torch.equal(common.bits_view(g).cpu(), common.bits_view(c))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.uint32, torch.uint64,
                                   torch.int8, torch.int16, torch.int32, torch.int64,
                                   torch.float16, torch.bfloat16, torch.float32, torch.float64])
def test_encodings_cuda_match_cpu(dev, dtype):
    rng = np.random.default_rng(3)
    bits = torch.from_numpy(rng.integers(-(2**62), 2**62, size=4096))
    keys = bits.view(torch.int8)[: 4096 * dtype.itemsize].view(dtype)
    enc = common.encode_keys(keys.to(dev))
    assert torch.equal(common.bits_view(enc).cpu(), common.bits_view(common.encode_keys(keys)))
    dec = common.decode_keys(enc, dtype)
    assert torch.equal(common.bits_view(dec).cpu(), common.bits_view(keys))
    out = vt.sort(keys.to(dev))
    assert torch.equal(common.bits_view(out).cpu(), common.bits_view(vt.sort(keys)))


def test_oversized_tile_raises(dev):
    planes = [torch.zeros(10, dtype=torch.int32, device=dev)] * 2
    with pytest.raises(ValueError, match="shared memory"):
        merge.tilesort(planes, 2, 1 << 16)


@pytest.mark.parametrize("tile", [3000, 1 << 21])
@pytest.mark.parametrize("backend", [None, "merge"])
def test_any_grain_the_jax_package_takes_sorts(dev, tile, backend):
    # the merge ladder floors a grain to a power of two, as the JAX package
    # does, and caps it at the largest tile one block sorts; the low-level
    # tile sort still refuses such tiles (test_oversized_tile_raises). The
    # default route (radix_tiled at this size) sorts with such a grain too
    rng = np.random.default_rng(tile)
    n = (1 << 24) + 77
    keys = rng.integers(0, 5000, size=n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    before = launches("tilesort")
    ok, ov = vt.sort_pairs(torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev),
                           config=vt.SortConfig(tile=tile), backend=backend)
    assert launches("tilesort") == before + (backend == "merge")
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ok.cpu().numpy(), keys[perm])
    np.testing.assert_array_equal(ov.cpu().numpy(), perm.astype(np.uint32))


def test_gpu_context(dev):
    info = vt.GPUContext(dev).info
    assert info.sm_count > 0 and info.l2_bytes > 0
    assert info.smem_per_block_optin >= 48 * 1024
    assert info.smem_per_sm >= info.smem_per_block_optin
    for nck in (1, 2, 3):
        tile = merge.default_tile(nck, dev)
        assert merge.tilesort_smem(nck, tile) <= info.smem_per_block_optin
        assert tile == merge.tilesort_max_tile(nck) or (
            merge.tilesort_smem(nck, 2 * tile) > info.smem_per_block_optin)
        for nplanes in (1, 2, 3, 4, 5):
            tile = merge.MERGE_TILES[nplanes]
            assert merge.mergepath_smem(nplanes, tile) <= info.smem_per_block_optin



def test_context_helpers_on_the_card(dev):
    from vkradixsort_tpu_torch.engine.context import default_context
    from vkradixsort_tpu_torch.parallel.mesh import LocalMesh

    ctx = default_context()
    assert ctx is default_context() and ctx.device == torch.device("cuda", 0)
    assert ctx.devices == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = ctx.mesh_1d()
    assert isinstance(mesh, LocalMesh) and mesh.devices == ctx.devices
    assert ctx.mesh_1d(1).devices == [torch.device("cuda", 0)]
    with pytest.raises(ValueError):
        ctx.mesh_1d(len(ctx.devices) + 1)
    keys = torch.arange(8 * len(ctx.devices), 0, -1, dtype=torch.int32, device=dev)
    assert [s.device for s in mesh.shard(keys)] == ctx.devices


def test_native_oracle_against_the_default_route(dev):
    """2^20 reference fixture keys (28-bit range) through ``sort_pairs`` on
    the default route, bitwise against the host runtime's stable argsort."""
    from vkradixsort_tpu_torch import native

    assert native.available(), native._LIB_ERR
    n = 1 << 20
    keys = native.generate_uniform(0xBE7C, n)
    ok, ov = vt.sort_pairs(torch.from_numpy(keys).to(dev),
                           torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32))
    perm = native.oracle_argsort(keys)
    got_k = common.bits_view(ok).cpu().numpy().view(np.uint32)
    got_v = common.bits_view(ov).cpu().numpy().view(np.uint32)
    assert native.first_mismatch(got_k, keys[perm]) == -1
    assert native.first_mismatch(got_v, perm) == -1
    assert native.first_unsorted(got_k) == -1

def test_default_route_sends_wide_payload_sets_to_tiled(dev, monkeypatch):
    # three 4-byte payloads need more carry planes than the kernels take
    def refuse(*a, **k):
        raise AssertionError("the merge engine got more payloads than it carries")

    monkeypatch.setattr(merge, "sort_merge", refuse)
    n = 1 << 20
    keys = torch.randint(0, 100, (n,), dtype=torch.int32, device=dev)
    vals = [torch.arange(n, dtype=torch.int32, device=dev) + i for i in range(3)]
    ok, ov = vt.sort_pairs(keys, vals)
    perm = torch.sort(keys, stable=True).indices
    assert torch.equal(ok, keys[perm])
    for o, v in zip(ov, vals):
        assert torch.equal(o, v[perm])


@pytest.mark.parametrize("op,n,engine", [
    ("kv", 1 << 20, "tiled"), ("kv", (1 << 24) + 5, "radix_tiled"),
    ("keys", (1 << 20) + 3, "tiled"), ("keys", (1 << 23) - 3, "tiled"),
    ("keys", (1 << 24) + 5, "radix_tiled"), ("kv2", (1 << 22) + 5, "tiled"),
    ("kv2", (1 << 24) + 5, "radix_tiled"), ("kvw", (1 << 24) + 5, "tiled"),
    ("kvw", (1 << 26) + 5, "radix_tiled"), ("kvw64", (1 << 22) + 5, "tiled"),
    ("kvw64", (1 << 24) + 5, "radix_tiled"),
    ("keys64", (1 << 25) - 3, "tiled"), ("keys64", (1 << 25) + 5, "radix_tiled"),
    ("kv64", (1 << 23) - 3, "tiled"), ("kv64", (1 << 24) + 5, "radix_tiled"),
    ("kv_unstable", (1 << 23) - 3, "tiled"), ("kv_unstable", (1 << 24) + 5, "radix_tiled"),
    ("kv_unstable64", (1 << 23) - 3, "tiled"), ("kv_unstable64", (1 << 24) + 5, "radix_tiled"),
    ("argsort", (1 << 25) - 3, "tiled"), ("argsort", (1 << 25) + 5, "radix_tiled"),
    ("argsort64", (1 << 25) + 5, "tiled"),
])
def test_default_route_follows_the_table(dev, op, n, engine):
    # each row of ROUTE_TABLE leads to its engine's kernels; a wide payload
    # set (three payloads, one of 8 bytes, on u32 keys; two 4-byte ones on
    # u64 keys) reads kvw and gathers its payloads on radix_tiled;
    # "kv_unstable" is kv with stable=False, which reads the kv rows
    from vkradixsort_tpu_torch.engine.config import route_for

    wide, base = op.endswith("64"), op.removesuffix("64")
    assert route_for(base.removesuffix("_unstable"), n, wide) == engine
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 20, size=n, dtype=np.uint64 if wide else np.uint32)
    vals = [np.arange(n, dtype=np.uint32), rng.standard_normal(n).astype(np.float32),
            rng.integers(-(2**62), 2**62, size=n)]
    vals = vals[:{"keys": 0, "argsort": 0, "kv": 1, "kv_unstable": 1, "kv2": 2,
                  "kvw": 2 if wide else 3}[base]]
    before = (launches("tilesort"), launches("onesweep_pass"))
    routes = profiling.counters()
    tk = torch.from_numpy(keys).to(dev)
    perm = np.argsort(keys, kind="stable")
    if base == "argsort":
        got = vt.argsort(tk)
        np.testing.assert_array_equal(got.cpu().numpy(), perm.astype(np.uint32))
        ok, ov = common.take(tk, torch.from_numpy(perm).to(dev)), []
    elif vals:
        ok, ov = vt.sort_pairs(tk, [torch.from_numpy(v).to(dev) for v in vals],
                               stable=base != "kv_unstable")
    else:
        ok, ov = vt.sort(tk), []
    ran = (launches("tilesort") > before[0], launches("onesweep_pass") > before[1])
    assert ran == (engine == "merge", engine == "radix_tiled")
    assert {k: v for k, v in profiling.since(routes).items()
            if k.startswith("route.")} == {"route." + engine: 1}
    np.testing.assert_array_equal(ok.cpu().numpy(), keys[perm])
    for o, v in zip(ov, vals):
        np.testing.assert_array_equal(common.bits_view(o).cpu().numpy(),
                                      v.view(f"i{v.itemsize}")[perm])


def _route_keys(rng, n, dtype):
    """Keys with ties and the dtype's extremes, of any key dtype."""
    keys = (rng.integers(0, 50, size=n) - 25).astype(dtype)
    if np.dtype(dtype).kind in "ui":
        keys[rng.random(n) < 0.02] = np.iinfo(dtype).max
    return keys


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64, np.float32, np.int64])
@pytest.mark.parametrize("backend", [None, "tiled", "merge", "radix_tiled"])
def test_argsort_cuda_matches_cpu(dev, key_dtype, backend):
    # the stable argsort has one answer: every engine on the card gives the
    # permutation of the CPU's library path (tiled.argsort_tiled)
    rng = np.random.default_rng(12)
    for n in (70_001, (1 << 24) + 5):
        keys = torch.from_numpy(_route_keys(rng, n, key_dtype))
        for descending in (False, True):
            got = vt.argsort(keys.to(dev), backend=backend, descending=descending)
            want = vt.argsort(keys, backend="tiled", descending=descending)
            torch.cuda.synchronize()
            assert got.dtype == torch.uint32 and torch.equal(common.bits_view(got).cpu(),
                                                             common.bits_view(want))
        keys2d = torch.from_numpy(_route_keys(rng, 3 * 4099, key_dtype)).view(3, -1)
        assert torch.equal(vt.argsort(keys2d.to(dev)).view(torch.int32).cpu(),
                           vt.argsort(keys2d).view(torch.int32))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.int32, np.float32, np.uint64])
@pytest.mark.parametrize("backend", [None, "tiled", "merge", "radix_tiled"])
def test_unstable_kv_cuda_matches_cpu(dev, key_dtype, backend):
    # stable=False runs every engine's stable pipeline: on the card it
    # equals the CPU's library path, stable=False or not
    rng = np.random.default_rng(13)
    for n in (70_001, (1 << 24) + 5):
        keys = torch.from_numpy(_route_keys(rng, n, key_dtype))
        vals = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
                                .astype(np.uint32))
        for descending in (False, True):
            gk, gv = vt.sort_pairs(keys.to(dev), vals.to(dev), backend=backend,
                                   descending=descending, stable=False)
            ck, cv = vt.sort_pairs(keys, vals, backend="tiled", descending=descending)
            torch.cuda.synchronize()
            assert torch.equal(common.bits_view(gk).cpu(), common.bits_view(ck))
            assert torch.equal(common.bits_view(gv).cpu(), common.bits_view(cv))


@pytest.mark.parametrize("distribution", ["zipf", "uniform"])
@pytest.mark.parametrize("backend", [None, "tiled", "merge", "radix_tiled"])
def test_u64_kv_cuda_matches_cpu(dev, distribution, backend):
    # stable u64 kv (BASELINE.json config 4's keys) on every engine of its
    # routes equals the library path on CPU tensors
    from vkradixsort_tpu_torch.utils.fixtures import make_keys

    rng = np.random.default_rng(14)
    for n in (70_001, (1 << 24) + 5):
        keys = torch.from_numpy(make_keys(rng, n, np.uint64, distribution))
        vals = torch.arange(n, dtype=torch.int32).view(torch.uint32)
        for descending in (False, True):
            gk, gv = vt.sort_pairs(keys.to(dev), vals.to(dev), backend=backend,
                                   descending=descending)
            ck, cv = vt.sort_pairs(keys, vals, backend="tiled", descending=descending)
            torch.cuda.synchronize()
            assert torch.equal(common.bits_view(gk).cpu(), common.bits_view(ck))
            assert torch.equal(common.bits_view(gv).cpu(), common.bits_view(cv))


def _radix_keys(rng, n, dtype, kind):
    """Keys for the radix kernels: "ties" (13 values, every byte alike),
    "max" (a fifth equal to the dtype's maximum), "uniform" or "constant"."""
    hi = np.iinfo(dtype).max
    if kind == "uniform":
        return rng.integers(0, int(hi), size=n, dtype=dtype, endpoint=True)
    if kind == "constant":
        return np.full(n, 0x5A, dtype=dtype)
    keys = rng.integers(0, 13, size=n).astype(dtype)
    keys *= dtype(0x01010101 if dtype == np.uint32 else 0x0101010101010101)
    if kind == "max":
        keys[rng.random(n) < 0.2] = hi
    return keys


RADIX_SHAPES = [  # (n, tile): ragged, one element, tiles smaller than a strip, tiles
    # the scatter kernel takes in two rounds (it holds 8192 elements at once)
    (1, 2048), (2048, 2048), (5 * 2048 + 17, 2048), (70_001, 2048), (1000, 100), (3001, 32),
    (4097, 4096), (40_000, 16384), (25_000, 10_000),
]
RADIX_PAYLOADS = [None, np.uint8, np.int16, np.float32, np.uint64]  # 0, 1, 2, 4, 8 bytes


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("kind", ["ties", "max", "uniform", "constant"])
@pytest.mark.parametrize("n,tile", RADIX_SHAPES)
def test_histogram_and_destination_kernels_match_plain(dev, dtype, kind, n, tile):
    rng = np.random.default_rng(n + tile)
    keys = torch.from_numpy(_radix_keys(rng, n, dtype, kind)).to(dev)
    for shift in range(0, 8 * keys.element_size(), 8):
        before = (launches("tile_histograms"), launches("tile_destinations"))
        hist = histogram.tile_histograms(keys, shift, tile)
        dest = radix_tiled.pass_destinations(keys, shift, tile)
        assert (launches("tile_histograms"),
                launches("tile_destinations")) == (before[0] + 2, before[1] + 1)
        _equal([hist, dest], [histogram.tile_histograms_plain(keys, shift, tile),
                              radix_tiled.pass_destinations_plain(keys, shift, tile)])
        base = reference.exclusive_bin_offsets(hist)
        _equal([radix_tiled.tile_destinations(keys, shift, tile, base)],
               [radix_tiled.tile_destinations_plain(keys, shift, tile, base)])


def _payload(rng, n, dtype):
    return torch.from_numpy(rng.integers(0, 2**64, size=n, dtype=np.uint64).view(np.uint8)
                            [: n * np.dtype(dtype).itemsize].view(dtype).copy())


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("kind", ["ties", "max", "uniform", "constant"])
@pytest.mark.parametrize("n,tile", RADIX_SHAPES)
@pytest.mark.parametrize("payload", RADIX_PAYLOADS,
                         ids=lambda d: "keys" if d is None else np.dtype(d).name)
def test_scatter_kernel_matches_plain(dev, dtype, kind, n, tile, payload):
    # the rank-and-scatter kernel moves keys and payload where the plain
    # destinations send them, at every pass, and leaves its inputs as they were
    rng = np.random.default_rng(n + tile + 1)
    keys = torch.from_numpy(_radix_keys(rng, n, dtype, kind)).to(dev)
    vals = None if payload is None else _payload(rng, n, payload).to(dev)
    keys_in, vals_in = keys.clone(), None if vals is None else vals.clone()
    for shift in range(0, 8 * keys.element_size(), 8):
        base = reference.exclusive_bin_offsets(histogram.tile_histograms(keys, shift, tile))
        before = (launches("tile_scatter"), launches("tile_destinations"))
        ok, ov = radix_tiled.tile_scatter(keys, vals, shift, tile, base)
        assert (launches("tile_scatter"),
                launches("tile_destinations")) == (before[0] + 1, before[1])
        pk, pv = radix_tiled.tile_scatter_plain(keys, vals, shift, tile, base)
        _equal([common.bits_view(ok)], [common.bits_view(pk)])
        if vals is None:
            assert ov is None and pv is None
        else:
            _equal([common.bits_view(ov)], [common.bits_view(pv)])
    _equal([common.bits_view(keys)], [common.bits_view(keys_in)])
    if vals is not None:
        _equal([common.bits_view(vals)], [common.bits_view(vals_in)])


@pytest.mark.parametrize("n", [3 * c + 1234 for c in (2048, 4096, 8192, 16384, 3000)])
@pytest.mark.parametrize("key_dtype,payload", [(np.uint32, np.uint32), (np.uint64, np.int16),
                                               (np.float32, None)])
def test_radix_tiled_chunks_match_cpu(dev, n, key_dtype, payload):
    # the card's radix_tiled sort against the CPU's, the same onesweep steps
    # through their plain versions, on ragged sizes
    rng = np.random.default_rng(n)
    keys = torch.from_numpy((rng.integers(0, 1 << 20, size=n) - (1 << 19)).astype(key_dtype))
    if payload is None:
        got = vt.sort(keys.to(dev), backend="radix_tiled")
        want = vt.sort(keys, backend="radix_tiled")
        _equal([common.bits_view(got).cpu()], [common.bits_view(want)])
        return
    vals = _payload(rng, n, payload)
    gk, gv = vt.sort_pairs(keys.to(dev), vals.to(dev), backend="radix_tiled")
    ck, cv = vt.sort_pairs(keys, vals, backend="tiled")
    _equal([common.bits_view(gk).cpu(), common.bits_view(gv).cpu()],
           [common.bits_view(ck), common.bits_view(cv)])


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("val_dtype", [None, np.float32, np.uint64])
@pytest.mark.parametrize("kind", ["ties", "max", "uniform", "constant"])
@pytest.mark.parametrize("n", [2, 31, 33, 1000, 32767, 32768])
def test_fused_kernel_matches_plain(dev, key_dtype, val_dtype, kind, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(_radix_keys(rng, n, key_dtype, kind)).to(dev)
    vals = None
    if val_dtype is not None:
        vals = torch.from_numpy(rng.standard_normal(n).astype(np.float64).view(np.uint64)
                                .astype(val_dtype)).to(dev)
    keys_in, vals_in = keys.clone(), None if vals is None else vals.clone()
    before = launches("sort_fused")
    ok, ov = fused.sort_fused(keys, vals)
    assert launches("sort_fused") == before + 1
    pk, pv = fused.sort_fused_plain(keys, vals)
    _equal([common.bits_view(ok)], [common.bits_view(pk)])
    if vals is None:
        assert ov is None
    else:
        _equal([common.bits_view(ov), common.bits_view(vals)],
               [common.bits_view(pv), common.bits_view(vals_in)])
    _equal([common.bits_view(keys)], [common.bits_view(keys_in)])  # input untouched


def test_radix_kernel_paths_never_take_the_plain_versions(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(histogram, "tile_histograms_plain", refuse)
    monkeypatch.setattr(histogram, "digit_histograms_plain", refuse)
    monkeypatch.setattr(radix_tiled, "tile_destinations_plain", refuse)
    monkeypatch.setattr(radix_tiled, "pass_destinations_plain", refuse)
    monkeypatch.setattr(radix_tiled, "tile_scatter_plain", refuse)
    monkeypatch.setattr(radix_tiled, "onesweep_pass_plain", refuse)
    monkeypatch.setattr(radix_tiled, "lookback_bases_plain", refuse)
    monkeypatch.setattr(reference, "scatter", refuse)  # torch's scatter, the replaced move
    monkeypatch.setattr(fused, "sort_fused_plain", refuse)
    monkeypatch.setattr(gather, "gather_columns_plain", refuse)
    rng = np.random.default_rng(8)
    for backend, n in [("radix_tiled", (1 << 20) + 3), ("fused", 30_000)]:
        keys = rng.integers(0, 1000, size=n, dtype=np.uint32)
        vals = np.arange(n, dtype=np.uint32)
        names = ("digit_histograms", "onesweep_pass", "tile_histograms", "tile_scatter",
                 "tile_destinations")
        before = [launches(w) for w in names]
        ok, ov = vt.sort_pairs(torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev),
                               backend=backend)
        if backend == "radix_tiled":  # one histogram of every digit, then 4 onesweep passes
            assert [launches(w) - b for w, b in zip(names, before)] == [1, 4, 0, 0, 0]
        perm = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(ok.cpu().numpy(), keys[perm])
        np.testing.assert_array_equal(ov.cpu().numpy(), perm.astype(np.uint32))


# ---------------------------------------------------------------------------
# the onesweep sort, radix_tiled's route on the card: one digit_histograms a
# sort, one onesweep_pass a pass, each bitwise its plain version, the sort
# bitwise a stable torch.sort and its gathers

ONESWEEP_SIZES = ["1", "tile-1", "tile", "tile+1", "2^20+3", "1e7"]


def _onesweep_n(size: str, tile: int) -> int:
    return {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "2^20+3": (1 << 20) + 3, "1e7": 10_000_000}[size]


def _onesweep_keys(rng, n, dtype, kind):
    """"uniform"; "equal" (every key alike: one digit holds each pass, the
    look-back chains are the longest); "zipf" (Zipf(1.3)); "descending";
    "top" (keys that differ only in the top byte)."""
    if kind in ("uniform", "zipf", "descending"):
        from vkradixsort_tpu_torch.utils.fixtures import make_keys

        return make_keys(rng, n, dtype, kind)
    if kind == "equal":
        return np.full(n, 0x5A, dtype=dtype)
    bits = 8 * np.dtype(dtype).itemsize
    return rng.integers(0, 256, size=n).astype(dtype) << dtype(bits - 8)


def _check_onesweep(dev, keys_np, payload, rng):
    """Each pass of the onesweep sort of ``keys_np`` with a random payload
    of dtype ``payload`` (or none) bitwise its plain version on the same
    input, the digit offsets bitwise theirs, the passes' result bitwise the
    radix_tiled route's and a stable torch.sort's with its gather, the
    inputs untouched and the launches one histogram and one pass a digit."""
    keys = torch.from_numpy(keys_np).to(dev)
    vals = None if payload is None else _payload(rng, keys_np.size, payload).to(dev)
    keys_in, vals_in = keys.clone(), None if vals is None else vals.clone()
    passes = keys.element_size()
    c0 = profiling.counters()
    offsets = histogram.digit_histograms(keys)
    _equal([offsets], [histogram.digit_histograms_plain(keys)])
    state = radix_tiled.lookback_state(keys, vals)
    cur_k, cur_v = keys, vals
    for p in range(passes):
        ok, ov = radix_tiled.onesweep_pass(cur_k, cur_v, 8 * p, offsets[p], state)
        pk, pv = radix_tiled.onesweep_pass_plain(cur_k, cur_v, 8 * p, offsets[p])
        _equal([common.bits_view(ok)], [common.bits_view(pk)])
        if vals is None:
            assert ov is None and pv is None
        else:
            _equal([common.bits_view(ov)], [common.bits_view(pv)])
        cur_k, cur_v = ok, ov
    moved = profiling.since(c0)
    assert (moved.get("launch.digit_histograms"), moved.get("launch.onesweep_pass")) == (1, passes)
    if vals is None:
        got, want = [vt.sort(keys, backend="radix_tiled")], [vt.sort(keys, backend="tiled")]
    else:
        got = list(vt.sort_pairs(keys, vals, backend="radix_tiled"))
        want = list(vt.sort_pairs(keys, vals, backend="tiled"))
    torch.cuda.synchronize()
    _equal([common.bits_view(x) for x in got], [common.bits_view(x) for x in want])
    _equal([common.bits_view(x) for x in (cur_k, cur_v) if x is not None],
           [common.bits_view(x) for x in want])
    _equal([common.bits_view(keys)], [common.bits_view(keys_in)])
    if vals is not None:
        _equal([common.bits_view(vals)], [common.bits_view(vals_in)])


@pytest.mark.parametrize("size", ONESWEEP_SIZES)
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("payload", RADIX_PAYLOADS,
                         ids=lambda d: "keys" if d is None else np.dtype(d).name)
def test_onesweep_sort_matches_plain(dev, size, dtype, payload):
    width = 0 if payload is None else np.dtype(payload).itemsize
    tile = radix_tiled.onesweep_shape(dev.index, np.dtype(dtype).itemsize, width)["tile"]
    n = _onesweep_n(size, tile)
    rng = np.random.default_rng(n + width)
    _check_onesweep(dev, _onesweep_keys(rng, n, dtype, "uniform"), payload, rng)


@pytest.mark.parametrize("kind,dtype", [("equal", np.uint32), ("equal", np.uint64),
                                        ("zipf", np.uint64), ("descending", np.uint32),
                                        ("descending", np.uint64), ("top", np.uint32),
                                        ("top", np.uint64)])
@pytest.mark.parametrize("size", ["tile+1", "2^20+3"])
@pytest.mark.parametrize("payload", [None, np.uint32, np.uint64],
                         ids=lambda d: "keys" if d is None else np.dtype(d).name)
def test_onesweep_sort_on_skewed_keys(dev, kind, dtype, size, payload):
    width = 0 if payload is None else np.dtype(payload).itemsize
    tile = radix_tiled.onesweep_shape(dev.index, np.dtype(dtype).itemsize, width)["tile"]
    n = _onesweep_n(size, tile)
    rng = np.random.default_rng(n + width + 7)
    _check_onesweep(dev, _onesweep_keys(rng, n, dtype, kind), payload, rng)


@pytest.mark.parametrize("dtype,passes", [(np.uint32, 4), (np.uint64, 8)])
def test_onesweep_launches_per_call(dev, dtype, passes):
    # the mechanism engages on every radix_tiled call: one histogram of
    # every digit, one pass a digit, none of the per-pass API's kernels
    rng = np.random.default_rng(passes)
    keys = torch.from_numpy(_onesweep_keys(rng, 3_000_001, dtype, "uniform")).to(dev)
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    names = ("digit_histograms", "onesweep_pass", "tile_histograms", "tile_scatter",
             "tile_destinations")
    for call in (lambda: vt.sort_pairs(keys, vals, backend="radix_tiled"),
                 lambda: vt.sort(keys, backend="radix_tiled"),
                 lambda: vt.argsort(keys, backend="radix_tiled")):
        before = [launches(w) for w in names]
        call()
        assert [launches(w) - b for w, b in zip(names, before)] == [1, passes, 0, 0, 0]


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_onesweep_back_to_back_sorts(dev, dtype):
    # 20 sorts in a row on one stream, checked only after the last: a
    # look-back state or tile counter left over from an earlier pass or call
    # would show as a wrong slot
    rng = np.random.default_rng(20)
    kinds = ["uniform", "equal", "top", "descending"]
    cases = []
    for i in range(20):
        n = int(rng.integers(1, 400_000)) if i % 3 else 1_000_003
        keys = torch.from_numpy(_onesweep_keys(rng, n, dtype, kinds[i % 4])).to(dev)
        vals = torch.from_numpy(rng.integers(0, 2**31, size=n).astype(np.int32)).to(dev)
        cases.append((keys, vals, vt.sort_pairs(keys, vals, backend="radix_tiled")))
    torch.cuda.synchronize()
    for keys, vals, got in cases:
        want = vt.sort_pairs(keys, vals, backend="tiled")
        _equal([common.bits_view(x) for x in got], [common.bits_view(x) for x in want])


@pytest.mark.parametrize("key_dtype,payload", [
    (np.uint32, np.uint32), (np.float32, np.float64), (np.int64, np.int32), (np.uint64, None),
])
@pytest.mark.parametrize("backend", ["radix_tiled", "fused", "reference", "bitonic", "samplesort"])
def test_radix_engines_cuda_match_cpu(dev, key_dtype, payload, backend):
    rng = np.random.default_rng(12)
    n = 20_001
    keys = (rng.integers(0, 50, size=n) - 25).astype(key_dtype)
    keys[rng.random(n) < 0.1] = np.iinfo(key_dtype).max if key_dtype != np.float32 else np.inf
    cpu_k = torch.from_numpy(keys)
    for descending in (False, True):
        if payload is None:
            got = vt.sort(cpu_k.to(dev), backend=backend, descending=descending)
            want = vt.sort(cpu_k, backend="tiled", descending=descending)
            torch.cuda.synchronize()
            assert torch.equal(common.bits_view(got).cpu(), common.bits_view(want))
            continue
        cpu_v = torch.from_numpy(rng.integers(0, 1 << 30, size=n).astype(payload))
        gk, gv = vt.sort_pairs(cpu_k.to(dev), cpu_v.to(dev), backend=backend,
                               descending=descending)
        ck, cv = vt.sort_pairs(cpu_k, cpu_v, backend="tiled", descending=descending)
        torch.cuda.synchronize()
        assert torch.equal(common.bits_view(gk).cpu(), common.bits_view(ck))
        assert torch.equal(common.bits_view(gv).cpu(), common.bits_view(cv))


BITONIC_CASES = [  # (n, key dtype, kind, payload dtypes): below one tile, one tile, global stages
    (1, np.uint32, "uniform", ()), (100, np.uint32, "max", (np.uint32,)),
    (1000, np.uint64, "ties", ()), (8192, np.uint32, "ties", (np.uint32,)),
    (5 * 8192 + 3, np.uint64, "max", (np.uint64,)),
    (70_001, np.uint32, "uniform", (np.float32, np.uint64)),
    ((1 << 20) + 1, np.uint32, "ties", (np.uint32,)), (300_000, np.uint64, "max", ()),
    # levels whose global distances d end on each remainder of d mod r = 4
    # (tile 8192: the top level has d = 5, 7 and 9)
    ((1 << 17) + 1, np.uint32, "ties", (np.uint32,)),
    ((1 << 17) + 1, np.uint64, "max", (np.uint64,)),
    ((1 << 19) + 1, np.uint32, "max", (np.float32,)), ((1 << 19) + 1, np.uint64, "uniform", ()),
    (1 << 22, np.uint32, "uniform", ()), (1 << 22, np.uint64, "ties", (np.uint32,)),
]


@pytest.mark.parametrize("n,key_dtype,kind,payloads", BITONIC_CASES,
                         ids=[f"{c[0]}-{c[1].__name__}-{c[2]}-{len(c[3])}v" for c in BITONIC_CASES])
def test_bitonic_kernel_matches_plain(dev, n, key_dtype, kind, payloads):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(_radix_keys(rng, n, key_dtype, kind)).to(dev)
    vals = tuple(torch.from_numpy(rng.integers(0, 1 << 62, size=n, dtype=np.uint64).astype(d))
                 .to(dev) for d in payloads)
    signed = segsort.to_signed_order(keys)
    before = bitonic.launch_counts()
    ok, ov = bitonic.bitonic_sort_block(signed, vals)
    after = bitonic.launch_counts()
    nk = 1 if key_dtype == np.uint32 else 2
    launches = bitonic.plan(bitonic._padded_size(n), bitonic.block_tile(nk, dev), nk)
    assert {k: after[k] - before[k] for k in after} == bitonic.plan_counts(launches, len(vals))
    pk, pv = bitonic.bitonic_sort_block_plain(signed, vals)
    _equal([common.bits_view(ok), *map(common.bits_view, ov)],
           [common.bits_view(pk), *map(common.bits_view, pv)])
    perm = np.argsort(signed.cpu().numpy(), kind="stable")
    np.testing.assert_array_equal(ok.cpu().numpy(), signed.cpu().numpy()[perm])
    for o, v in zip(ov, vals):
        np.testing.assert_array_equal(common.bits_view(o).cpu().numpy(),
                                      common.bits_view(v).cpu().numpy()[perm])


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("val_dtype", [None, np.uint32, np.float64])
@pytest.mark.parametrize("G,C,B,cap", [(1, 1024, 8, 256), (3, 4096, 8, 896), (5, 2048, 16, 384)])
def test_placement_kernel_matches_plain(dev, key_dtype, val_dtype, G, C, B, cap):
    rng = np.random.default_rng(G * C + B)
    rows = torch.from_numpy(np.sort(_radix_keys(rng, G * C, key_dtype, "max").reshape(G, C),
                                    axis=1)).to(dev)
    spl = samplesort._splitters(rows, B, 4)
    starts, lens, overflow = samplesort._bucket_starts(rows, spl, cap)
    assert not bool(overflow)
    planes, fills = [rows], [common.pad_sentinel(rows.dtype)]
    if val_dtype is not None:
        gidx = rng.permutation(G * C).astype(np.int32).reshape(G, C)
        planes.append(torch.from_numpy(gidx).to(dev))
        planes.append(torch.from_numpy(rng.standard_normal((G, C)).astype(val_dtype)).to(dev))
        fills += [(1 << 31) - 1, 0]
    before = launches("place_runs")
    got = samplesort.place_runs(planes, starts, lens, cap, fills)
    assert launches("place_runs") == before + 1
    want = samplesort.place_runs_plain(planes, starts, lens, cap, fills)
    _equal(list(map(common.bits_view, got)), list(map(common.bits_view, want)))


def test_samplesort_overflow_fallback_on_the_card(dev):
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.zipf(1.3, size=60_000).astype(np.uint32)).to(dev)
    vals = torch.arange(60_000, dtype=torch.int32, device=dev)
    forced = dict(tile_target=1 << 14, bucket_target=1 << 12, oversample=1, slack=1.01)
    before = launches("place_runs")
    ok, ov, overflow = samplesort.sort_pairs_samplesort(keys, vals, _debug_overflow=True, **forced)
    assert overflow and launches("place_runs") == before
    ck, cv = samplesort.sort_pairs_samplesort(keys.cpu(), vals.cpu(), **forced)
    assert torch.equal(common.bits_view(ok).cpu(), common.bits_view(ck))
    assert torch.equal(ov.cpu(), cv)


def test_bitonic_and_samplesort_paths_never_take_the_plain_versions(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(bitonic, "bitonic_sort_block_plain", refuse)
    monkeypatch.setattr(samplesort, "place_runs_plain", refuse)
    rng = np.random.default_rng(9)
    for backend, n in [("bitonic", 1_000_003), ("samplesort", 3_000_001)]:
        keys = rng.integers(0, 1000, size=n, dtype=np.uint32)
        vals = np.arange(n, dtype=np.uint32)
        before = (sum(bitonic.launch_counts().values()), launches("place_runs"))
        ok, ov = vt.sort_pairs(torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev),
                               backend=backend)
        after = (sum(bitonic.launch_counts().values()), launches("place_runs"))
        assert after[0 if backend == "bitonic" else 1] > before[0 if backend == "bitonic" else 1]
        perm = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(ok.cpu().numpy(), keys[perm])
        np.testing.assert_array_equal(ov.cpu().numpy(), perm.astype(np.uint32))
    before = launches("place_runs")
    keys = rng.integers(0, 2**32, size=3_000_001, dtype=np.uint32)
    out = vt.sort(torch.from_numpy(keys).to(dev), backend="samplesort")
    assert launches("place_runs") == before + 1  # the pipeline, not the fallback
    np.testing.assert_array_equal(out.cpu().numpy(), np.sort(keys))


@pytest.mark.parametrize("n,key_dtype", [((1 << 19) + 1, np.uint32), (300_000, np.uint64)])
def test_bitonic_tile_does_not_change_the_result(dev, n, key_dtype):
    rng = np.random.default_rng(n + 1)
    keys = torch.from_numpy(_radix_keys(rng, n, key_dtype, "max")).to(dev)
    signed = segsort.to_signed_order(keys)
    planes = [p.contiguous() for p in bitonic._split_planes(signed)]
    vals = [torch.arange(n, dtype=torch.int32, device=dev)]
    want, (want_v,) = bitonic.network(planes, vals)
    for tile in (1024, 16384):
        got, (got_v,) = bitonic.network(planes, vals, tile=tile)
        _equal([got, got_v], [want, want_v])


def test_fused_kernel_refuses_more_than_it_holds(dev):
    keys = torch.zeros(fused.MAX_N + 1, dtype=torch.uint32, device=dev)
    with pytest.raises(ValueError, match="fused kernel takes"):
        fused.sort_fused(keys, config=vt.SortConfig(fused_max_n=fused.MAX_N + 1))


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("engine", ["xla", "merge"])
@pytest.mark.parametrize("kdt", [np.uint32, np.uint64])
def test_local_mesh_on_the_card_equals_the_cpu(dev, chunks, engine, kdt):
    # the distributed sort over 4 logical shards of the card against the
    # same over 4 of the CPU (plain versions there): every padded shard,
    # count and flag bitwise alike; ties, sentinel-valued keys, two payloads
    from vkradixsort_tpu_torch.parallel.distributed import LocalMesh, sort_sharded

    rng = np.random.default_rng(chunks * 10 + (kdt == np.uint64))
    n = 4 * 50_001
    keys = (rng.zipf(1.3, size=n) % 1000).astype(kdt)
    keys[::9] = np.iinfo(kdt).max
    vals = (np.arange(n, dtype=np.int32), rng.standard_normal(n).astype(np.float32))
    out = []
    for d in ("cpu", dev):
        res = sort_sharded(torch.from_numpy(keys).to(d), LocalMesh([d] * 4),
                           values=tuple(torch.from_numpy(v).to(d) for v in vals),
                           overlap_chunks=chunks, local_engine=engine)
        out.append(list(res[0]) + [res[1], res[2]] + [s for p in res[3] for s in p])
    torch.cuda.synchronize()
    assert not bool(out[1][5].any())
    for a, b in zip(*out):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu())


def test_mesh_2d_on_the_card(dev):
    from vkradixsort_tpu_torch.engine.context import default_context
    from vkradixsort_tpu_torch.parallel.mesh import LocalMesh2D

    ctx = default_context()
    mesh = ctx.mesh_2d((1, 1))
    assert isinstance(mesh, LocalMesh2D) and mesh.devices == [[torch.device("cuda", 0)]]
    assert mesh.shape == {"host": 1, "chip": 1}
    with pytest.raises(ValueError, match="needs"):
        ctx.mesh_2d((1, len(ctx.devices) + 1))


@pytest.mark.parametrize("n", [1 << 20, 1 << 23])
@pytest.mark.parametrize("axis", ["chip", "host"])
def test_local_mesh_2d_on_the_card_equals_1d(dev, n, axis):
    # a 2 x 4 grid of logical shards of the card, along either axis on the
    # merge engine: every replica bitwise equal to the 1-D sort at that P
    from vkradixsort_tpu_torch.parallel.distributed import (
        LocalMesh,
        LocalMesh2D,
        gather_sorted,
        sort_sharded,
    )

    mesh = LocalMesh2D([[dev] * 4] * 2)
    P = mesh.shape[axis]
    gen = torch.Generator(device=dev).manual_seed(n + P)
    keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    two = sort_sharded(keys, mesh, values=vals, local_engine="merge", axis_name=axis)
    one = sort_sharded(keys, LocalMesh([dev] * P), values=vals, local_engine="merge")
    torch.cuda.synchronize()
    assert len(two[0]) == 8 and not bool(two[2].any())
    bits = common.bits_view
    for i in range(8):
        assert torch.equal(bits(two[0][i]), bits(one[0][i % P]))
        assert torch.equal(two[3][i], one[3][i % P])
    # counts and flags: one replica's, JAX's global shape (P,)
    assert torch.equal(two[1], one[1]) and torch.equal(two[2], one[2])
    got_k, got_v = gather_sorted(two[0], two[1], two[3], mesh=mesh, axis_name=axis)
    k = bits(keys).cpu().numpy().view(np.uint32)
    perm = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(bits(got_k).cpu().numpy().view(np.uint32), k[perm])
    np.testing.assert_array_equal(got_v.cpu().numpy(), perm.astype(np.int32))


@pytest.mark.parametrize("axis", ["chip", "host"])
def test_local_mesh_2d_gather_without_mesh_on_the_card(dev, axis):
    # gather_sorted without mesh= strips one replica, as the mesh= form does
    from vkradixsort_tpu_torch.parallel.distributed import (
        LocalMesh2D,
        gather_sorted,
        sort_sharded,
    )

    n = (1 << 20) + 8
    mesh = LocalMesh2D([[dev] * 4] * 2)
    gen = torch.Generator(device=dev).manual_seed(n)
    keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    vals = (torch.arange(n, dtype=torch.int32, device=dev),
            torch.randn(n, dtype=torch.float64, device=dev))
    pk, counts, overflow, pv = sort_sharded(keys, mesh, values=vals, axis_name=axis)
    assert counts.shape == overflow.shape == (mesh.shape[axis],)
    got_k, got_v = gather_sorted(pk, counts, pv)
    want_k, want_v = gather_sorted(pk, counts, pv, mesh=mesh, axis_name=axis)
    bits = common.bits_view
    assert got_k.shape == (n,) and torch.equal(bits(got_k), bits(want_k))
    for g, w in zip(got_v, want_v):
        assert torch.equal(bits(g), bits(w))
    ck, (cv, _) = vt.sort_pairs(keys.cpu(), [v.cpu() for v in vals], backend="tiled")
    assert torch.equal(bits(got_k).cpu(), bits(ck)) and torch.equal(got_v[0].cpu(), cv)


WIDE_PAYLOADS = [(np.uint32, (np.float32, np.uint64)), (np.uint32, (np.int32,) * 3),
                 (np.uint32, (np.float64, np.float64)), (np.uint64, (np.uint64, np.int32))]


@pytest.mark.parametrize("key_dtype,payloads", WIDE_PAYLOADS)
@pytest.mark.parametrize("n", [4 * 16384, 3 * 16384 + 4097])
def test_wide_payload_merge_on_the_card_equals_plain(dev, key_dtype, payloads, n):
    # more than two carry planes: one local index rides through the kernels
    # and each payload is gathered; bitwise the plain path's result, both
    # directions, and both kernels ran
    rng = np.random.default_rng(n + len(payloads))
    keys = rng.integers(0, 64, size=n).astype(key_dtype)
    keys[rng.random(n) < 0.1] = np.iinfo(key_dtype).max
    vals = [torch.from_numpy(rng.integers(0, 1 << 62, size=n).astype(d)) for d in payloads]
    ck = torch.from_numpy(keys)
    for descending in (False, True):
        before = (launches("tilesort"), launches("mergepath_level"))
        gk, gv = vt.sort_pairs(ck.to(dev), [v.to(dev) for v in vals], backend="merge",
                               descending=descending)
        torch.cuda.synchronize()
        assert launches("tilesort") == before[0] + 1
        assert launches("mergepath_level") == before[1] + 2
        pk, pvs = vt.sort_pairs(ck, vals, backend="merge", descending=descending)
        assert torch.equal(common.bits_view(gk).cpu(), common.bits_view(pk))
        for g, p in zip(gv, pvs):
            assert g.dtype == p.dtype and torch.equal(common.bits_view(g).cpu(),
                                                      common.bits_view(p))


def test_bench_gates_and_pair_timing_on_the_card(dev):
    # the benchmark twin's gates on a default-route sort of 2^20 pairs, and
    # the kv timer with a tuple of two payloads
    from vkradixsort_tpu_torch import bench
    from vkradixsort_tpu_torch.utils.timing import measure_pairs_seconds_per_call

    n = 1 << 20
    keys_np = np.random.default_rng(n).integers(0, 1 << 32, size=n, dtype=np.uint32)
    keys = torch.from_numpy(keys_np).to(dev)
    values = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    out_k, out_v = vt.sort_pairs(keys, values)
    ok, detail = bench.window_oracle_checks(out_k, out_v, keys_np, np.random.default_rng(1))
    assert ok, detail
    assert bench.device_side_checks(keys, values, out_k, out_v)
    assert bench.pairing_sum(out_k, out_v) == bench.pairing_sum(out_k.cpu(), out_v.cpu())
    bits = common.bits_view(out_v).clone()
    bits[[0, n - 1]] = bits[[n - 1, 0]]  # a re-pairing inside both end windows
    bad_v = bits.view(torch.uint32)
    assert not bench.device_side_checks(keys, values, out_k, bad_v)
    ok, detail = bench.window_oracle_checks(out_k, bad_v, keys_np, np.random.default_rng(1))
    assert not ok and detail.startswith("value window mismatch at [0, 1024)")
    payloads = (values, torch.randn(n, device=dev))
    seconds = measure_pairs_seconds_per_call(vt.sort_pairs, keys, payloads)
    assert 0 < seconds < 1


# ---------------------------------------------------------------------------
# wide payload sets: gather_columns, and radix_tiled's payload-set path (the
# keys with their u32 positions, then one gather) against the tiled route

N_WIDE = 100_000_000
LINEITEM = (torch.int64,) * 4 + (torch.int32,)


def _columns(dev, n, dtypes, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.empty(n, dtype=d, device=dev).random_(torch.iinfo(d).min, None,
                                                             generator=gen) for d in dtypes)


def _wide_keys(dev, n, dtype, seed):
    """Keys of random bits, an eighth of them from 1000 values (ties)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = {torch.uint32: torch.int32, torch.uint64: torch.int64}[dtype]
    k = torch.empty(n, dtype=bits, device=dev).random_(torch.iinfo(bits).min, None, generator=gen)
    k[::8] = k[::8] % 1000
    return k.view(dtype)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097, (1 << 20) + 3, N_WIDE])
@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("ncols", [1, 8])
def test_gather_columns_matches_plain(dev, n, width, ncols):
    dtype = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[width]
    gen = torch.Generator(device=dev).manual_seed(n + ncols)
    perm = torch.randperm(n, device=dev, generator=gen).to(torch.int32).view(torch.uint32)
    cols = _columns(dev, n, (dtype,) * ncols, n + width)
    before = launches("gather_columns")
    got = gather.gather_columns(perm, cols)
    assert launches("gather_columns") == before + 1
    _equal([common.bits_view(g) for g in got],
           [common.bits_view(w) for w in gather.gather_columns_plain(perm, cols)])


@pytest.mark.parametrize("ncols", [8, 9, 17])
def test_gather_columns_unaligned_and_past_one_launch(dev, ncols):
    # a permutation 4 bytes off a 16-byte boundary takes the scalar loads;
    # more than 8 columns take one launch per 8
    n = (1 << 16) + 5
    buf = torch.empty(n + 1, dtype=torch.int32, device=dev)
    buf[1:] = torch.randperm(n, device=dev).to(torch.int32)
    perm = buf[1:].view(torch.uint32)
    cols = _columns(dev, n, (torch.int8, torch.int16, torch.int32, torch.int64) * 5, 3)[:ncols]
    before = launches("gather_columns")
    got = gather.gather_columns(perm, cols)
    assert launches("gather_columns") == before + -(-ncols // 8)
    _equal([common.bits_view(g) for g in got],
           [common.bits_view(w) for w in gather.gather_columns_plain(perm, cols)])


@pytest.mark.parametrize("n", [1 << 20, 1 << 24, N_WIDE])
@pytest.mark.parametrize("key_dtype", [torch.uint32, torch.uint64])
@pytest.mark.parametrize("descending", [False, True])
def test_wide_radix_tiled_matches_the_tiled_route(dev, n, key_dtype, descending):
    keys = _wide_keys(dev, n, key_dtype, n)
    cols = _columns(dev, n, LINEITEM + (torch.int8, torch.int16), n + 1)
    before = (launches("gather_columns"), launches("onesweep_pass"))
    rk, rv = vt.sort_pairs(keys, cols, backend="radix_tiled", descending=descending)
    torch.cuda.synchronize()
    assert launches("gather_columns") == before[0] + 1
    assert launches("onesweep_pass") == before[1] + 8 * key_dtype.itemsize // 8
    tk, tv = vt.sort_pairs(keys, cols, backend="tiled", descending=descending)
    _equal([common.bits_view(rk)] + [common.bits_view(v) for v in rv],
           [common.bits_view(tk)] + [common.bits_view(v) for v in tv])


@pytest.mark.parametrize("key_dtype", [torch.uint32, torch.uint64])
@pytest.mark.parametrize("payload", [torch.int8, torch.int16, torch.int32, torch.int64])
def test_one_payload_on_radix_tiled_matches_the_tiled_route(dev, key_dtype, payload):
    # carried through the passes or gathered after them (radix_tiled.carries)
    n = (1 << 22) + 7
    keys = _wide_keys(dev, n, key_dtype, 5)
    (col,) = _columns(dev, n, (payload,), 6)
    carried = radix_tiled.carries(keys, col)
    before = launches("gather_columns")
    rk, rv = vt.sort_pairs(keys, col, backend="radix_tiled")
    assert launches("gather_columns") == before + (0 if carried else 1)
    tk, tv = vt.sort_pairs(keys, col, backend="tiled")
    _equal([common.bits_view(rk), common.bits_view(rv)],
           [common.bits_view(tk), common.bits_view(tv)])


@pytest.mark.parametrize("key_dtype", [torch.uint32, torch.uint64])
@pytest.mark.parametrize("payload", [torch.int8, torch.int16, torch.int64])
def test_one_payload_of_any_width_reads_the_kv_row(dev, key_dtype, payload):
    from vkradixsort_tpu_torch.engine.config import route_for

    wide = key_dtype == torch.uint64
    for n in ((1 << 20) + 3, (1 << 24) + 5):
        keys = _wide_keys(dev, n, key_dtype, n)
        (col,) = _columns(dev, n, (payload,), 7)
        before = profiling.counters()
        ok, ov = vt.sort_pairs(keys, col)
        torch.cuda.synchronize()
        assert profiling.since(before).get("route." + route_for("kv", n, wide)) == 1
        tk, tv = vt.sort_pairs(keys, col, backend="tiled")
        _equal([common.bits_view(ok), common.bits_view(ov)],
               [common.bits_view(tk), common.bits_view(tv)])


def test_lineitem_sort_counts_one_route_and_one_gather(dev):
    from vkradixsort_tpu_torch.engine.config import route_for

    assert route_for("kvw", N_WIDE, True) == "radix_tiled"
    keys = _wide_keys(dev, N_WIDE, torch.uint64, 9)
    cols = _columns(dev, N_WIDE, LINEITEM, 10)
    for _ in range(2):
        torch.cuda.synchronize()
        before = profiling.counters()
        ok, ov = vt.sort_pairs(keys, cols)
        torch.cuda.synchronize()
        moved = profiling.since(before)
        assert moved.get("route.radix_tiled") == 1 and moved.get("launch.gather_columns") == 1
        assert moved.get("launch.digit_histograms") == 1 and moved.get("launch.onesweep_pass") == 8
    from sortbench import reference as plain

    ref_k, ref_v = plain.sort_pairs(keys, cols)
    assert plain.mismatched_rows(ok, ov, ref_k, ref_v) == 0
