"""The PyTorch port's distributed sort (parallel/distributed.py) on the CPU:
P logical shards of one CPU in one process (``LocalMesh``).

Tolerance: exact (bitwise). A stable sort has one right answer, and the
splitters, bucket bounds and counts are integers computed the same way.

Three cases are held against the JAX package's ``sort_sharded`` on the
8-device CPU mesh of ``tests/conftest.py``: counts, overflow flags and each
shard's valid prefix (JAX's padding content is arbitrary). The JAX calls
run under the one ``jax.jit`` of ``tests/jax_dist.py``, as the JAX package's
dry run runs them (a few seconds each; unjitted, about 30 s), once, in a
module-scoped fixture;
every other case is held against numpy's stable argsort. The merge engine's plain versions run where ``local_engine`` is
"merge" (CPU tensors).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkradixsort_tpu_torch.ops import merge
from vkradixsort_tpu_torch.parallel import distributed as dist
from vkradixsort_tpu_torch.parallel.distributed import (
    LocalMesh,
    gather_sorted,
    sort_distributed,
    sort_sharded,
)
from vkradixsort_tpu_torch.utils.fixtures import make_keys
import jax_dist
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = 8
JAX_CASES = {
    # name: (keys, payloads, sort_sharded keywords)
    "u32_kv": ("u32", 1, dict(overlap_chunks=1)),
    "f32_two_payloads_C2": ("f32", 2, dict(overlap_chunks=2)),
    "u64_zipf_kv_descending_gidx64": ("u64", 1, dict(descending=True)),
}


def _mesh(p=P):
    return LocalMesh(["cpu"] * p)


def _inputs(name):
    rng = np.random.default_rng(7)
    kind, npay, _ = JAX_CASES[name]
    if kind == "u32":
        n = 8 * 5000
        keys = make_keys(rng, n, np.uint32, "uniform")
    elif kind == "f32":
        n = 8 * 1003
        keys = rng.standard_normal(n).astype(np.float32)
    else:
        n = 8 * 1024
        keys = make_keys(rng, n, np.uint64, "zipf")
    vals = [np.arange(n, dtype=np.int32), rng.standard_normal(n).astype(np.float32)][:npay]
    return keys, vals


def _bits(x):
    x = np.asarray(x)
    return x.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[x.dtype.itemsize])


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's sort_sharded on the three cases (three calls)."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:P]), ("x",))
    out = {}
    for name, (kind, _, kw) in JAX_CASES.items():
        keys, vals = _inputs(name)
        extra = dict(gidx_dtype=jnp.int64) if kind == "u64" else {}
        jv = tuple(jnp.asarray(v) for v in vals)
        res = jax_dist.sort_sharded(jnp.asarray(keys), mesh, values=jv if len(jv) > 1 else jv[0],
                                    **kw, **extra)
        pv = res[3] if len(jv) > 1 else (res[3],)
        out[name] = (np.asarray(res[0]), np.asarray(res[1]), np.asarray(res[2]),
                     [np.asarray(v) for v in pv])
    return out


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sort_sharded_matches_jax(jax_results, name):
    if len(jax.devices()) < P:
        pytest.skip("needs the 8-device CPU mesh")
    kind, _, kw = JAX_CASES[name]
    keys, vals = _inputs(name)
    extra = dict(gidx_dtype=torch.int64) if kind == "u64" else {}
    tv = tuple(torch.from_numpy(v) for v in vals)
    pk, counts, overflow, pv = sort_sharded(torch.from_numpy(keys), _mesh(),
                                            values=tv if len(tv) > 1 else tv[0], **kw, **extra)
    pv = pv if len(tv) > 1 else (pv,)
    jk, jcounts, joverflow, jvals = jax_results[name]
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    np.testing.assert_array_equal(overflow.numpy(), joverflow)
    assert not joverflow.any()
    per = jk.shape[0] // P
    assert all(s.shape == (per,) for s in pk)
    for d in range(P):
        c = int(jcounts[d])
        np.testing.assert_array_equal(_bits(pk[d][:c].numpy()), _bits(jk[d * per:d * per + c]))
        for got, want in zip(pv, jvals):
            np.testing.assert_array_equal(_bits(got[d][:c].numpy()),
                                          _bits(want[d * per:d * per + c]))


# ---------------------------------------------------------------------------
# every other case against numpy's stable argsort


def _stable(keys, descending=False):
    if descending:
        if keys.dtype.kind == "f":
            raise ValueError("descending float keys: compare in encoded order")
        return np.argsort(~keys, kind="stable")
    return np.argsort(keys, kind="stable")


def _check(keys, vals, got_k, got_v, descending=False):
    perm = _stable(keys, descending)
    np.testing.assert_array_equal(_bits(got_k.numpy()), _bits(keys[perm]))
    for g, v in zip(got_v, vals):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(v[perm]))


def _keys(rng, n, dtype, dist_name):
    if dist_name == "mod97":
        return (make_keys(rng, n, dtype, "uniform") % 97).astype(dtype)
    if dist_name == "sentinel":
        keys = make_keys(rng, n, dtype, "uniform")
        keys[::7] = np.iinfo(dtype).max  # the encoded keys' pad sentinel
        return keys
    if dist_name == "normal":
        return rng.standard_normal(n).astype(dtype)
    if dist_name == "periodic":  # even positions high keys, odd low
        pos = np.arange(n, dtype=np.uint32)
        return np.where(pos % 2 == 0, np.uint32(0x80000000) + pos, pos).astype(np.uint32)
    return make_keys(rng, n, dtype, dist_name)


# (n, key dtype, distribution, payloads, sort_sharded keywords); each the
# counterpart of a case of tests/test_distributed.py
CASES = {
    **{f"u32_{d}_{n}": (n, np.uint32, d, 0, {})
       for d in ("uniform", "uniform28", "descending", "constant") for n in (8 * 1024, 8 * 5000)},
    "zipf_skew": (8 * 4096, np.uint32, "zipf", 0, dict(slack=4.0, oversample=64)),
    "kv_stability": (8 * 2048, np.uint32, "mod97", 1, {}),
    "u64": (8 * 1024, np.uint64, "uniform", 0, {}),
    "u64_zipf_kv": (8 * 2048, np.uint64, "zipf", 1, dict(slack=4.0, oversample=64)),
    "float32": (8 * 1024, np.float32, "uniform", 0, {}),
    "multi_payload": (8 * 2048, np.uint32, "mod97", 2, {}),
    "descending_kv": (8 * 2048, np.uint32, "mod97", 1, dict(descending=True)),
    **{f"overlapped_{d}": (8 * 4096, np.uint32, d, 0, dict(overlap_chunks=4, slack=3.0))
       for d in ("uniform", "descending", "constant", "zipf")},
    "overlapped_kv": (8 * 2048, np.uint32, "mod97", 1, dict(overlap_chunks=4, slack=3.0)),
    "periodic_adversary": (8 * 4096, np.uint32, "periodic", 0,
                           dict(overlap_chunks=2, slack=3.0)),
    "non_p2_multiple": (8 * 997, np.uint32, "uniform", 1, {}),
    "ragged_chunks": (8 * 997, np.uint32, "uniform", 0, dict(overlap_chunks=3, slack=3.0)),
    "sentinel_keys_non_p2": (8 * 500, np.uint32, "sentinel", 1, dict(slack=3.0)),
    "gidx_int64": (8 * 1024, np.uint32, "mod97", 1, dict(gidx_dtype=torch.int64)),
    "merge_u32_kv": (8 * 2048, np.uint32, "mod97", 1, dict(local_engine="merge")),
    "merge_u64_overlapped": (8 * 1024, np.uint64, "uniform", 0,
                             dict(local_engine="merge", overlap_chunks=2)),
    "int16_keys": (8 * 1000, np.int16, "uniform", 1, {}),
    "int64_keys_descending": (8 * 1000, np.int64, "uniform", 2, dict(descending=True)),
    "float64_keys": (8 * 1000, np.float64, "uniform", 1, {}),
    "float16_keys_C2": (8 * 1000, np.float16, "normal", 1, dict(overlap_chunks=2)),
    "u64_sentinel_merge_three_payloads": (8 * 777, np.uint64, "sentinel", 3,
                                          dict(local_engine="merge", slack=3.0)),
}


def _payloads(rng, n, npay):
    return [np.arange(n, dtype=np.int32), rng.standard_normal(n).astype(np.float32),
            rng.integers(0, 2**32, size=n, dtype=np.uint32)][:npay]


@pytest.mark.parametrize("name", list(CASES))
def test_sort_sharded_exact(name):
    n, dtype, dist_name, npay, kw = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    keys = _keys(rng, n, dtype, dist_name)
    vals = _payloads(rng, n, npay)
    tv = tuple(torch.from_numpy(v) for v in vals)
    res = sort_sharded(torch.from_numpy(keys), _mesh(), values=tv if npay else None, **kw)
    assert not bool(res[2].any()), "bucket overflow"
    assert res[1].dtype == torch.int32 and int(res[1].sum()) == n
    if npay:
        got_k, got_v = gather_sorted(res[0], res[1], res[3])
    else:
        got_k, got_v = gather_sorted(res[0], res[1]), ()
    _check(keys, vals, got_k, got_v, kw.get("descending", False))


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("chunks", [1, 2])
def test_other_mesh_sizes(p, chunks):
    rng = np.random.default_rng(p * 10 + chunks)
    n = p * 1501
    keys = make_keys(rng, n, np.uint32, "zipf")
    vals = np.arange(n, dtype=np.int32)
    got_k, got_v = sort_distributed(torch.from_numpy(keys), _mesh(p),
                                    values=torch.from_numpy(vals), overlap_chunks=chunks)
    _check(keys, [vals], got_k, [got_v])


def test_shards_on_distinct_devices_match_one_device():
    # "cpu" and "cpu:0" are distinct devices to the mesh: the per-block copy
    # path of its collectives must give the one-device transpose's shards
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(make_keys(rng, 4 * 3000, np.uint32, "uniform"))
    vals = torch.arange(4 * 3000, dtype=torch.int32)
    a = sort_sharded(keys, LocalMesh(["cpu"] * 4), values=vals, overlap_chunks=2)
    b = sort_sharded(keys, LocalMesh(["cpu", "cpu:0", "cpu", "cpu:0"]), values=vals,
                     overlap_chunks=2)
    for x, y in zip(a[0] + a[3] + [a[1], a[2]], b[0] + b[3] + [b[1], b[2]]):
        assert torch.equal(x, y)


def test_shards_given_as_a_list():
    rng = np.random.default_rng(6)
    keys = torch.from_numpy(make_keys(rng, 4 * 1000, np.uint32, "uniform"))
    v1 = torch.arange(4 * 1000, dtype=torch.int32)
    v2 = v1.to(torch.float32)
    mesh = _mesh(4)
    a = sort_sharded(keys, mesh, values=(v1, v2))
    b = sort_sharded(list(keys.chunk(4)), mesh, values=(list(v1.chunk(4)), list(v2.chunk(4))))
    c = sort_sharded(list(keys.chunk(4)), mesh, values=list(v1.chunk(4)))  # one payload
    for x, y in zip(a[0] + a[3][0] + a[3][1], b[0] + b[3][0] + b[3][1]):
        assert torch.equal(x, y)
    for x, y in zip(a[3][0], c[3]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("chunks", [1, 2])
def test_sort_distributed_overflow_retry(chunks):
    # slack 0.2 makes a bucket's capacity about n_local / (5P): the first
    # attempt overflows, and the retries with doubled slack must still give
    # the exact stable result
    rng = np.random.default_rng(11 + chunks)
    n = 8 * (2048 if chunks == 1 else 4096)
    keys = make_keys(rng, n, np.uint32, "uniform" if chunks == 1 else "zipf")
    first = sort_sharded(torch.from_numpy(keys), _mesh(), slack=0.2, overlap_chunks=chunks)
    assert bool(first[2].any()), "slack 0.2 was meant to overflow"
    got = sort_distributed(torch.from_numpy(keys), _mesh(), slack=0.2, overlap_chunks=chunks)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))
    vals = np.arange(n, dtype=np.int32)
    got_k, got_v = sort_distributed(torch.from_numpy(keys), _mesh(), slack=0.2,
                                    values=torch.from_numpy(vals), overlap_chunks=chunks)
    _check(keys, [vals], got_k, [got_v])


def test_sort_sharded_empty():
    mesh = _mesh()
    keys = torch.zeros(0, dtype=torch.uint32)
    pk, counts, overflow = sort_sharded(keys, mesh)
    assert len(pk) == P and all(s.shape == (0,) for s in pk)
    assert int(counts.sum()) == 0 and not bool(overflow.any())
    pk, counts, overflow, pv = sort_sharded(keys, mesh, values=torch.zeros(0, dtype=torch.int32))
    assert all(s.shape == (0,) for s in pv)
    assert gather_sorted(pk, counts).shape == (0,)


@pytest.mark.parametrize("payloads", [0, 1, 3])
@pytest.mark.parametrize("kdt", [np.uint32, np.uint64])
@pytest.mark.parametrize("chunks", [1, 2])
def test_merge_local_engine_bitwise_equal_to_library(payloads, kdt, chunks):
    # the same (key, gidx) order on both engines: every padded shard, count
    # and flag alike; u64 keys take three compare planes (hi, lo, gidx) and
    # three payloads ride as one local index
    rng = np.random.default_rng(payloads * 7 + chunks)
    n = 8 * 1200 + 8
    keys = _keys(rng, n, kdt, "sentinel")
    keys[1::5] = keys[0]  # ties across shards
    vals = tuple(torch.from_numpy(v) for v in _payloads(rng, n, payloads))
    kw = dict(values=vals if vals else None, overlap_chunks=chunks, slack=3.0)
    a = sort_sharded(torch.from_numpy(keys), _mesh(), local_engine="xla", **kw)
    b = sort_sharded(torch.from_numpy(keys), _mesh(), local_engine="merge", **kw)
    flat = [list(a[0]) + [a[1], a[2]] + [s for v in a[3:] for p in v for s in p],
            list(b[0]) + [b[1], b[2]] + [s for v in b[3:] for p in v for s in p]]
    for x, y in zip(*flat):
        assert torch.equal(x, y)
    got = gather_sorted(b[0], b[1], b[3] if vals else None)
    got_k, got_v = (got if vals else (got, ()))
    _check(keys, [v.numpy() for v in vals], got_k, got_v)


def test_merge_envelope_errors():
    mesh = _mesh()
    k = torch.zeros(8 * 16, dtype=torch.uint32)
    with pytest.raises(ValueError, match="local_engine='merge'"):
        sort_sharded(k, mesh, values=torch.zeros(8 * 16, dtype=torch.float64),
                     local_engine="merge")
    with pytest.raises(ValueError, match="local_engine='merge'"):
        sort_sharded(k, mesh, values=torch.zeros(8 * 16, dtype=torch.int32),
                     gidx_dtype=torch.int64, local_engine="merge")
    with pytest.raises(ValueError, match="local_engine must be"):
        sort_sharded(k, mesh, local_engine="bitonic")


def test_bad_calls_raise():
    mesh = _mesh()
    with pytest.raises(ValueError, match="multiple of P"):
        sort_sharded(torch.zeros(8 * 16 + 1, dtype=torch.uint32), mesh)
    with pytest.raises(ValueError, match="overlap_chunks"):
        sort_sharded(torch.zeros(8 * 16, dtype=torch.uint32), mesh, overlap_chunks=0)
    with pytest.raises(ValueError, match="shards"):
        sort_sharded([torch.zeros(16, dtype=torch.uint32)] * 7, mesh)
    with pytest.raises(ValueError, match="gidx_dtype"):
        sort_sharded(torch.zeros(8 * 16, dtype=torch.uint32), mesh, gidx_dtype=torch.int16)


def test_pick_local_engine():
    i32, i64 = torch.int32, torch.int64
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    v4, v8 = [torch.zeros(1, dtype=torch.int32)], [torch.zeros(1, dtype=torch.int64)]
    assert dist._pick_local_engine("merge", i32, v4, 1 << 20, 1, cpu) == "merge"
    assert dist._pick_local_engine("xla", i64, v8, 1 << 20, 2, cpu) == "xla"
    # None: the library sort on the CPU, outside the merge envelope, and
    # wherever ROUTE_TABLE has no dist_local row
    assert dist._pick_local_engine(None, i32, v4, 1 << 24, 1, cpu) == "xla"
    assert dist._pick_local_engine(None, i64, v4, 1 << 24, 1, cuda) == "xla"
    assert dist._pick_local_engine(None, i32, v8, 1 << 24, 1, cuda) == "xla"
    for n, nck in [(1 << 10, 1), (1 << 24, 1), (1 << 20, 2)]:
        want = "merge" if dist.route_for("dist_local", n, wide=nck == 2) == "merge" else "xla"
        assert dist._pick_local_engine(None, i32, v4, n, nck, cuda) == want


def test_pick_local_engine_follows_the_route_table(monkeypatch):
    from vkradixsort_tpu_torch.engine import config

    monkeypatch.setitem(config.ROUTE_TABLE, "dist_local",
                        [(1 << 20, "tiled"), (float("inf"), "merge")])
    cuda = torch.device("cuda", 0)
    v4 = [torch.zeros(1, dtype=torch.int32)]
    assert dist._pick_local_engine(None, torch.int32, v4, 1 << 20, 1, cuda) == "xla"
    assert dist._pick_local_engine(None, torch.int32, v4, 1 << 22, 1, cuda) == "merge"
    assert dist._pick_local_engine(None, torch.int32, v4, 1 << 22, 2, cuda) == "xla"  # dist_local64


@pytest.mark.parametrize("chunks", [1, 2])
def test_steps_are_profiler_ranges(chunks):
    # each step of the body runs in a span, so a profiler trace gives the
    # time by step
    from torch.profiler import ProfilerActivity, profile

    keys = torch.from_numpy(make_keys(np.random.default_rng(3), P * 256, np.uint32, "uniform"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sort_sharded(keys, _mesh(), overlap_chunks=chunks)
    names = [e.name for e in prof.events()]
    for step in dist.STEPS:
        assert names.count("vkrs/sort_sharded/" + step) >= (chunks if step == "local sort" else 1)


def test_interleave_is_one_transposed_copy():
    # the one-device all-to-all: block p of shard q lands in block q of
    # shard p
    mesh = _mesh(4)
    xs = [torch.arange(12, dtype=torch.int32).view(4, 3) + 100 * q for q in range(4)]
    out = mesh.all_to_all(xs)
    for p in range(4):
        for q in range(4):
            assert torch.equal(out[p][q], xs[q][p])
    gathered = mesh.all_gather([x[0] for x in xs])
    assert all(torch.equal(g, torch.stack([x[0] for x in xs])) for g in gathered)


# ---------------------------------------------------------------------------
# the merge kernels' third compare plane, in their plain versions


def _lex_planes(rng, n, nck, ncarry):
    planes = [rng.integers(-3, 3, size=n).astype(np.int32) for _ in range(nck)]
    planes[0][rng.random(n) < 0.1] = np.iinfo(np.int32).max
    planes += [rng.integers(-(2**31), 2**31, size=n).astype(np.int32) for _ in range(ncarry)]
    return planes


@pytest.mark.parametrize("ncarry", [0, 1, 2])
def test_nck3_tilesort_and_levels_plain(ncarry):
    rng = np.random.default_rng(ncarry)
    n, tile = 5 * 1024 + 77, 1024
    planes = _lex_planes(rng, n, 3, ncarry)
    order = np.lexsort(tuple(planes[:3][::-1]))
    cur = merge.tilesort([torch.from_numpy(p) for p in planes], 3, tile)
    for s in range(0, n, tile):  # every tile sorted stably, carries moved
        o = np.lexsort(tuple(p[s:s + tile] for p in planes[:3][::-1]))
        for got, p in zip(cur, planes):
            np.testing.assert_array_equal(got[s:s + tile].numpy(), p[s:s + tile][o])
    run = tile
    while run < n:
        want = merge.level_splits_plain(cur, 3, run, 256)
        assert torch.equal(merge.coranks_plain(cur, 3, run, 256), want)
        cur = merge.mergepath_level(cur, 3, run)
        run *= 2
    for got, p in zip(cur, planes):
        np.testing.assert_array_equal(got.numpy(), p[order])
    out = merge.sort_merge_planes([torch.from_numpy(p) for p in planes], 3)
    for got, p in zip(out, planes):
        np.testing.assert_array_equal(got.numpy(), p[order])


# ---------------------------------------------------------------------------
# the entry points


def test_dryrun_multichip_on_cpu(capsys):
    from vkradixsort_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "chunks=1" in out and "chunks=2" in out and "exact" in out


def test_entry_sorts_pairs_on_cpu():
    from vkradixsort_tpu_torch.entry import entry

    fn, (keys, values) = entry(device="cpu")
    assert keys.shape == (1 << 20,) and keys.dtype == torch.uint32
    out_k, out_v = fn(keys, values)
    k = keys.numpy()
    perm = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(out_k.numpy(), k[perm])
    np.testing.assert_array_equal(out_v.numpy(), perm.astype(np.uint32))


def test_new_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys, vkradixsort_tpu_torch, vkradixsort_tpu_torch.parallel.distributed, "
            "vkradixsort_tpu_torch.parallel.multihost, vkradixsort_tpu_torch.utils.profiling, "
            "vkradixsort_tpu_torch.utils.fixtures, vkradixsort_tpu_torch.entry; "
            "assert 'jax' not in sys.modules and 'vkradixsort_tpu' not in sys.modules")
    root = __file__.rsplit("/tests/", 1)[0]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)


def test_fixtures_match_the_jax_package():
    from vkradixsort_tpu.utils import fixtures as jfix

    for dtype in (np.uint32, np.uint64, np.int32, np.float32):
        for d in ("uniform28", "uniform", "descending", "constant", "zipf"):
            a = make_keys(np.random.default_rng(3), 1000, dtype, d)
            b = jfix.make_keys(np.random.default_rng(3), 1000, dtype, d)
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
