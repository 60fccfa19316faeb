"""The PyTorch port's sort along one axis of a 2-D mesh (``LocalMesh2D``,
``GPUContext.mesh_2d``) on the CPU: R x C logical shards of one CPU in one
process.

Tolerance: exact (bitwise). A stable sort has one right answer, and the
splitters, bucket bounds and counts are integers computed the same way.

Three cases are held against the JAX package's ``sort_sharded`` on
``TPUContext().mesh_2d(shape)`` of the 8-device CPU mesh of
``tests/conftest.py``, along one axis: counts, overflow flags and each
shard's valid prefix, on every device of the mesh (JAX's padding content is
arbitrary), and ``gather_sorted`` without a mesh against JAX's
``gather_sorted`` on the same results. The JAX calls run under the one ``jax.jit`` of
``tests/jax_dist.py`` (a few seconds each; unjitted, 20-40 s), once, in a module-scoped fixture.
Every other case is held against numpy's stable argsort. The process-group 2-D mesh is tested
on gloo in ``tests/test_torch_mesh2d_group.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkradixsort_tpu.engine.context import TPUContext
from vkradixsort_tpu.parallel import distributed as jdist
from vkradixsort_tpu_torch.parallel.distributed import (
    LocalMesh,
    LocalMesh2D,
    gather_sorted,
    sort_distributed,
    sort_sharded,
)
from vkradixsort_tpu_torch.utils.fixtures import make_keys
import jax_dist
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

JAX_CASES = {
    # name: (mesh shape, axis, keys, payloads, sort_sharded keywords)
    "2x4_chip_u32_kv": ((2, 4), "chip", "u32", 1, dict(overlap_chunks=1)),
    "2x4_host_f32_two_payloads_C2": ((2, 4), "host", "f32", 2, dict(overlap_chunks=2)),
    "4x2_chip_u64_zipf_descending_gidx64": ((4, 2), "chip", "u64", 1, dict(descending=True)),
}


def _inputs(name):
    rng = np.random.default_rng(11)
    _, _, kind, npay, _ = JAX_CASES[name]
    if kind == "u32":
        n = 4 * 5000
        keys = make_keys(rng, n, np.uint32, "uniform")
    elif kind == "f32":
        n = 2 * 4013
        keys = rng.standard_normal(n).astype(np.float32)
    else:
        n = 2 * 2048
        keys = make_keys(rng, n, np.uint64, "zipf")
    vals = [np.arange(n, dtype=np.int32), rng.standard_normal(n).astype(np.float32)][:npay]
    return keys, vals


def _bits(x):
    x = np.asarray(x)
    return x.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[x.dtype.itemsize])


def _positions(shape, axis):
    """Grid positions (r, c) of the port's output shards, replica-major: the
    rows in turn along "chip", the columns along "host"."""
    rows, cols = shape
    if axis == "chip":
        return [(r, c) for r in range(rows) for c in range(cols)]
    return [(r, c) for c in range(cols) for r in range(rows)]


def _per_device(arr):
    return {s.device: np.asarray(s.data) for s in arr.addressable_shards}


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's sort_sharded on the three cases (three jitted
    calls): every device's shard of the keys, counts, flags and payloads,
    and JAX's gather_sorted of the global arrays."""
    out = {}
    for name, (shape, axis, kind, _, kw) in JAX_CASES.items():
        if len(jax.devices()) < shape[0] * shape[1]:
            continue
        mesh = TPUContext().mesh_2d(shape)
        keys, vals = _inputs(name)
        extra = dict(gidx_dtype=jnp.int64) if kind == "u64" else {}
        jv = tuple(jnp.asarray(v) for v in vals)
        res = jax_dist.sort_sharded(jnp.asarray(keys), mesh, values=jv if len(jv) > 1 else jv[0],
                                    axis_name=axis, **kw, **extra)
        pv = res[3] if len(jv) > 1 else (res[3],)
        gathered = jdist.gather_sorted(res[0], res[1], res[3])
        out[name] = (mesh, [_per_device(x) for x in (res[0], res[1], res[2]) + tuple(pv)],
                     (gathered[0],) + (tuple(gathered[1]) if len(jv) > 1 else (gathered[1],)))
    return out


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sort_along_an_axis_matches_jax(jax_results, name):
    shape, axis, kind, _, kw = JAX_CASES[name]
    if name not in jax_results:
        pytest.skip("needs the 8-device CPU mesh")
    keys, vals = _inputs(name)
    extra = dict(gidx_dtype=torch.int64) if kind == "u64" else {}
    tv = tuple(torch.from_numpy(v) for v in vals)
    mesh2 = LocalMesh2D([["cpu"] * shape[1]] * shape[0])
    pk, counts, overflow, pv = sort_sharded(torch.from_numpy(keys), mesh2,
                                            values=tv if len(tv) > 1 else tv[0], **kw, **extra,
                                            axis_name=axis)
    pv = pv if len(tv) > 1 else (pv,)
    jmesh, (jk, jcounts, jflags, *jvals), _ = jax_results[name]
    P = shape[1] if axis == "chip" else shape[0]
    # every device keeps its shard; counts and flags take JAX's global shape
    assert len(pk) == shape[0] * shape[1] and counts.shape == overflow.shape == (P,)
    for i, (r, c) in enumerate(_positions(shape, axis)):
        dv = jmesh.devices[r, c]
        assert int(counts[i % P]) == int(jcounts[dv][0])
        assert bool(overflow[i % P]) == bool(jflags[dv][0])
        assert not jflags[dv].any()
        cnt = int(counts[i % P])
        assert pk[i].shape == jk[dv].shape
        np.testing.assert_array_equal(_bits(pk[i][:cnt].numpy()), _bits(jk[dv][:cnt]))
        for got, want in zip(pv, jvals):
            np.testing.assert_array_equal(_bits(got[i][:cnt].numpy()), _bits(want[dv][:cnt]))
    # the replicas are bitwise equal, padding (NaN for float keys) included
    for i in range(P, len(pk)):
        assert np.array_equal(_bits(pk[i].numpy()), _bits(pk[i % P].numpy()))
        assert all(np.array_equal(_bits(p[i].numpy()), _bits(p[i % P].numpy())) for p in pv)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_gather_sorted_without_mesh_matches_jax(jax_results, name):
    # no mesh=: the counts' shape says how many shards to strip, one
    # replica's, as JAX's global arrays show one replica
    shape, axis, kind, _, kw = JAX_CASES[name]
    if name not in jax_results:
        pytest.skip("needs the 8-device CPU mesh")
    keys, vals = _inputs(name)
    extra = dict(gidx_dtype=torch.int64) if kind == "u64" else {}
    tv = tuple(torch.from_numpy(v) for v in vals)
    mesh2 = LocalMesh2D([["cpu"] * shape[1]] * shape[0])
    pk, counts, _, pv = sort_sharded(torch.from_numpy(keys), mesh2,
                                     values=tv if len(tv) > 1 else tv[0], **kw, **extra,
                                     axis_name=axis)
    got_k, got_v = gather_sorted(pk, counts, pv)
    with_mesh = gather_sorted(pk, counts, pv, mesh=mesh2, axis_name=axis)
    got_v = got_v if len(tv) > 1 else (got_v,)
    want = jax_results[name][2]
    assert got_k.shape == (keys.size,) == want[0].shape
    np.testing.assert_array_equal(_bits(got_k.numpy()), _bits(want[0]))
    np.testing.assert_array_equal(_bits(with_mesh[0].numpy()), _bits(want[0]))
    for g, w in zip(got_v, want[1:]):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


# ---------------------------------------------------------------------------
# against numpy's stable argsort


def _zipf_kv(n, seed=5):
    rng = np.random.default_rng(seed)
    keys = make_keys(rng, n, np.uint32, "zipf")
    keys[::13] = np.uint32(0xFFFFFFFF)  # the pad sentinel
    return keys, np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("axis", ["chip", "host"])
def test_sort_distributed_retries_along_each_axis(axis):
    keys, vals = _zipf_kv(8 * 1001)
    mesh = LocalMesh2D([["cpu"] * 4] * 2)
    k, v = torch.from_numpy(keys), torch.from_numpy(vals)
    # slack 0.2 overflows, so sort_distributed has to retry
    assert bool(sort_sharded(k, mesh, values=v, slack=0.2, axis_name=axis)[2].any())
    got_k, got_v = sort_distributed(k, mesh, values=v, slack=0.2, axis_name=axis)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k.numpy(), keys[perm])
    np.testing.assert_array_equal(got_v.numpy(), vals[perm])


@pytest.mark.parametrize("axis", ["chip", "host"])
def test_shards_in_output_order_equal_the_whole_tensor(axis):
    keys, vals = _zipf_kv(4 * 777)
    shape = (3, 2)
    mesh = LocalMesh2D([["cpu"] * shape[1]] * shape[0])
    P = mesh.shape[axis]
    parts = [np.split(x, P) for x in (keys, vals)]
    n_rep = len(mesh.along(axis))
    shards = [torch.from_numpy(parts[0][d]) for _ in range(n_rep) for d in range(P)]
    pvals = [torch.from_numpy(parts[1][d]) for _ in range(n_rep) for d in range(P)]
    a = sort_sharded(torch.from_numpy(keys), mesh, values=torch.from_numpy(vals), axis_name=axis)
    b = sort_sharded(shards, mesh, values=pvals, axis_name=axis)
    for x, y in zip(list(a[0]) + [a[1], a[2]] + list(a[3]), list(b[0]) + [b[1], b[2]] + list(b[3])):
        assert torch.equal(x, y)
    perm = np.argsort(keys, kind="stable")
    for got_k, got_v in (gather_sorted(a[0], a[1], a[3], mesh=mesh, axis_name=axis),
                         gather_sorted(a[0], a[1], a[3])):
        np.testing.assert_array_equal(got_k.numpy(), keys[perm])
        np.testing.assert_array_equal(got_v.numpy(), vals[perm])


def test_one_dimensional_mesh_unchanged():
    # axis_name=None on a 1-D mesh is the 1-D sort; a 1 x P grid along its
    # second axis gives the same shards
    keys, vals = _zipf_kv(4 * 999)
    k, v = torch.from_numpy(keys), torch.from_numpy(vals)
    one = sort_sharded(k, LocalMesh(["cpu"] * 4), values=v, axis_name=None)
    two = sort_sharded(k, LocalMesh2D([["cpu"] * 4]), values=v, axis_name="chip")
    for x, y in zip(list(one[0]) + [one[1], one[2]] + list(one[3]),
                    list(two[0]) + [two[1], two[2]] + list(two[3])):
        assert torch.equal(x, y)
    got = gather_sorted(one[0], one[1], one[3])
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got[0].numpy(), keys[perm])
    np.testing.assert_array_equal(got[1].numpy(), vals[perm])


@pytest.mark.parametrize("axis", ["chip", "host"])
def test_empty_input_along_each_axis(axis):
    mesh = LocalMesh2D([["cpu"] * 4] * 2)
    keys = torch.zeros(0, dtype=torch.uint32)
    pk, counts, overflow, pv = sort_sharded(keys, mesh, values=(keys, keys), axis_name=axis)
    P = mesh.shape[axis]
    assert len(pk) == 8 and counts.tolist() == [0] * P and overflow.shape == (P,)
    assert not bool(overflow.any())
    assert isinstance(pv, tuple) and all(len(p) == 8 for p in pv)
    assert gather_sorted(pk, counts, mesh=mesh, axis_name=axis).numel() == 0
    assert gather_sorted(pk, counts).numel() == 0
    assert sort_distributed(keys, mesh, axis_name=axis).numel() == 0


def test_axis_names_are_checked():
    mesh = LocalMesh2D([["cpu"] * 2] * 2, axis_names=("x", "y"))
    assert mesh.shape == {"x": 2, "y": 2} and mesh.axis_names == ("x", "y")
    keys = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\('x', 'y'\)"):
        sort_sharded(keys, mesh, axis_name="chip")
    with pytest.raises(ValueError, match="needs axis_name"):
        sort_sharded(keys, mesh)
    with pytest.raises(ValueError, match="1-D mesh has no axis names"):
        sort_sharded(keys, LocalMesh(["cpu"] * 2), axis_name="x")
    with pytest.raises(ValueError, match="needs the mesh"):
        gather_sorted([keys], torch.tensor([8]), axis_name="x")
    with pytest.raises(ValueError, match="holds 4 shards"):
        sort_sharded([keys] * 3, mesh, axis_name="x")
    with pytest.raises(ValueError, match="two distinct axis names"):
        LocalMesh2D([["cpu"]], axis_names=("x", "x"))
    with pytest.raises(ValueError, match="rectangular"):
        LocalMesh2D([["cpu"] * 2, ["cpu"]])
    rows, cols = mesh.along("y"), mesh.along("x")
    assert len(rows) == 2 and len(cols) == 2 and all(m.size == 2 for m in rows + cols)


def test_mesh_2d_refuses_the_cpu_and_counts_the_cards(monkeypatch):
    """``GPUContext.mesh_2d`` builds the grid row-major over the visible
    cards, raises ValueError past them and RuntimeError without a card; it
    never falls back to the CPU."""
    from vkradixsort_tpu_torch.engine import context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        context.GPUContext()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="CUDA device"):
        context.GPUContext("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    ctx = context.GPUContext("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        ctx.mesh_2d((1, 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
    with pytest.raises(ValueError, match=r"mesh \(2, 4\) needs 8 devices, have 6"):
        ctx.mesh_2d((2, 4))
    mesh = ctx.mesh_2d((2, 3))
    cards = [torch.device("cuda", i) for i in range(6)]
    assert isinstance(mesh, LocalMesh2D) and mesh.shape == {"host": 2, "chip": 3}
    assert mesh.devices == [cards[:3], cards[3:]]
    assert [m.devices for m in mesh.along("chip")] == [cards[:3], cards[3:]]
    assert [m.devices for m in mesh.along("host")] == [[cards[c], cards[3 + c]]
                                                        for c in range(3)]
