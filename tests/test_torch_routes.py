"""The dispatcher's own paths in the PyTorch port, on CPU tensors, held
against the JAX package's public API on the same numpy inputs: argsort
(``tiled.argsort_tiled`` and every engine's keys-plus-positions sort),
``sort_pairs(stable=False)`` (every engine's stable pipeline, on the
route of the stable call), stable kv
with 64-bit keys (one int64 ``torch.sort``), and the shape of
``engine/config.ROUTE_TABLE``.

Tolerance: exact. Stable results bitwise (one right answer; floats compare
as bit patterns); unstable results against JAX's unstable ones: keys
bitwise with an equal (key, value) multiset.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
import vkradixsort_tpu_torch as vt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from vkradixsort_tpu_torch.engine.config import ROUTE_TABLE
from vkradixsort_tpu_torch.utils import profiling
from vkradixsort_tpu_torch.utils.fixtures import make_keys

N = 3 * 4096 + 555
CFG = vt.SortConfig(tile=4096)  # several merge levels
ARGSORT_DTYPES = [np.uint32, np.uint64, np.int32, np.float32, np.float16]
BACKENDS = [None, "tiled", "merge", "radix_tiled", "reference"]


def _keys(dtype, n=N) -> np.ndarray:
    """Keys with heavy ties; floats also carry +-0, +-inf and NaNs of both
    signs, integers their dtype's extremes."""
    rng = np.random.default_rng(np.dtype(dtype).num)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        keys = (rng.integers(-40, 40, size=n) / 4).astype(dtype)
        ibits = {2: np.uint16, 4: np.uint32}[dtype.itemsize]
        sign = ibits(1 << (8 * dtype.itemsize - 1))
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], dtype=dtype)
        nan_neg = (special[4:].view(ibits) | sign).view(dtype)
        special = np.concatenate([special, nan_neg])
        at = rng.choice(n, size=60, replace=False)
        keys[at] = special[np.arange(60) % special.size]
        return keys
    info = np.iinfo(dtype)
    keys = rng.integers(0, 50, size=n).astype(dtype)
    keys[rng.random(n) < 0.03] = info.max
    keys[rng.random(n) < 0.03] = info.min
    return keys


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype.itemsize == want.dtype.itemsize
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.fixture(scope="module")
def jax_argsort():
    """JAX's argsort on "tiled" (its packed path for 32-bit keys under x64),
    once per (dtype, 2-D, descending)."""
    cache = {}

    def get(dtype, two_d, descending):
        key = (np.dtype(dtype).name, two_d, descending)
        if key not in cache:
            keys = _keys(dtype)
            if two_d:
                keys = keys.reshape(3, -1)
            cache[key] = keys, np.asarray(vk.argsort(
                jnp.asarray(keys), backend=None if two_d else "tiled", descending=descending))
        return cache[key]

    return get


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ARGSORT_DTYPES)
def test_argsort_matches_jax(jax_argsort, dtype, backend, descending):
    keys, want = jax_argsort(dtype, False, descending)
    perm = vt.argsort(torch.from_numpy(keys), config=CFG, backend=backend,
                      descending=descending)
    assert perm.dtype == torch.uint32
    _eq(perm, want)


# the card's onesweep tile of u32 and u64 keys with a u32 payload
# (Shape<K, 4> in csrc/onesweep.cu): tile + 1 rows leave one row in a last tile
# of the pass that makes the positions
ONESWEEP_TILE = {np.uint32: 512 * 15, np.uint64: 512 * 13}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("size", ["0", "1", "2", "tile+1"])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_radix_tiled_argsort_at_edge_sizes_matches_jax(dtype, size, descending):
    # radix_tiled's own argsort: the keys sorted with the u32 positions that
    # the first onesweep pass makes (one radix.positions_in_pass a sort of
    # two rows or more)
    n = ONESWEEP_TILE[dtype] + 1 if size == "tile+1" else int(size)
    keys = _keys(dtype, n)
    want = vk.argsort(jnp.asarray(keys), backend="tiled", descending=descending)
    before = profiling.counters()
    perm = vt.argsort(torch.from_numpy(keys), backend="radix_tiled", descending=descending)
    assert profiling.since(before).get("radix.positions_in_pass", 0) == (n > 1)
    assert perm.dtype == torch.uint32
    _eq(perm, want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ARGSORT_DTYPES)
def test_argsort_2d_matches_jax(jax_argsort, dtype, descending):
    keys, want = jax_argsort(dtype, True, descending)
    perm = vt.argsort(torch.from_numpy(keys), descending=descending)
    assert perm.dtype == torch.uint32
    _eq(perm, want)


def _multiset(keys, vals) -> list:
    rows = zip(_bits(keys).tolist(), *[_bits(v).tolist() for v in vals])
    return sorted(rows)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("backend", [None, "tiled"])
def test_unstable_u32_kv_on_tiled_keeps_keys_and_pairs(backend, descending):
    # "tiled" runs the stable carry where JAX runs its packed u64 sort
    # (which orders equal keys by payload bits): the keys and the (key,
    # value) multiset agree, and the result is JAX's stable one
    rng = np.random.default_rng(5)
    keys = _keys(np.uint32)
    vals = rng.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    ok, ov = vt.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals), backend=backend,
                           descending=descending, stable=False)
    jk, jv = vk.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), backend="tiled",
                           descending=descending, stable=False)
    _eq(ok, jk)
    assert _multiset(ok.numpy(), [ov.numpy()]) == _multiset(np.asarray(jk), [np.asarray(jv)])
    sk, sv = vk.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), backend="tiled",
                           descending=descending)
    _eq(ov, sv)


@pytest.mark.parametrize("backend,npayloads", [("merge", 2), ("tiled", 2), ("radix_tiled", 1)])
def test_unstable_u64_kv_keeps_keys_and_pairs(backend, npayloads):
    # 64-bit keys have no packed path: every engine runs its stable
    # pipeline, a valid unstable answer; JAX's unstable merge drops its tie
    # plane, so only the keys and the (key, values) multiset are fixed
    rng = np.random.default_rng(6)
    keys = _keys(np.uint64)
    vals = [rng.standard_normal(N).astype(np.float32),
            rng.integers(-(1 << 31), 1 << 31, size=N).astype(np.int32)][:npayloads]
    ok, ov = vt.sort_pairs(torch.from_numpy(keys), [torch.from_numpy(v) for v in vals],
                           config=CFG, backend=backend, stable=False)
    jk, jv = vk.sort_pairs(jnp.asarray(keys), [jnp.asarray(v) for v in vals], backend="tiled",
                           stable=False)
    _eq(ok, jk)
    assert _multiset(ok.numpy(), [o.numpy() for o in ov]) == _multiset(
        np.asarray(jk), [np.asarray(j) for j in jv])
    assert _multiset(ok.numpy(), [o.numpy() for o in ov]) == _multiset(keys, vals)


@pytest.mark.parametrize("backend", [None, "radix_tiled"])
@pytest.mark.parametrize("payloads", [(np.int8,), (np.float32,), (np.uint64,),
                                      (np.int32, np.int16)],
                         ids=["i8", "f32", "u64", "i32-i16"])
def test_unstable_kv_is_the_stable_call(backend, payloads):
    # stable=False reads the stable call's ROUTE_TABLE row and runs its
    # pipeline: the same route counted, and bitwise the stable answer
    rng = np.random.default_rng(8)
    keys = torch.from_numpy(_keys(np.uint32))
    vals = [torch.from_numpy(rng.integers(0, 256, size=N * np.dtype(d).itemsize,
                                          dtype=np.uint8).view(d)) for d in payloads]
    out, routes = {}, {}
    for stable in (True, False):
        before = profiling.counters()
        out[stable] = vt.sort_pairs(keys, vals, backend=backend, stable=stable)
        routes[stable] = {k: v for k, v in profiling.since(before).items()
                          if k.startswith("route.")}
    assert routes[False] == routes[True] == {"route." + (backend or "tiled"): 1}
    (sk, sv), (uk, uv) = out[True], out[False]
    _eq(uk, sk.numpy())
    for u, s in zip(uv, sv, strict=True):
        _eq(u, s.numpy())


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("distribution", ["zipf", "uniform"])
def test_u64_kv_on_tiled_matches_jax(distribution, descending):
    # one stable int64 torch.sort and one gather a payload, where the JAX
    # package chains two 32-bit passes; "uniform" reaches the dtype's maximum
    rng = np.random.default_rng(7)
    keys = make_keys(rng, N, np.uint64, distribution)
    keys[:: 97] = np.iinfo(np.uint64).max
    vals = np.arange(N, dtype=np.uint32)
    ok, ov = vt.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals), backend="tiled",
                           descending=descending)
    jk, jv = vk.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), backend="tiled",
                           descending=descending)
    _eq(ok, jk)
    _eq(ov, jv)


# engines that accept each ROUTE_TABLE operation: radix_tiled moves any set
# of 1-, 2-, 4- and 8-byte payloads, merge none of 1 or 2 bytes (so no kvw
# row leads there), and radix_tiled is no local engine of the distributed
# sort, whose "tiled" is its library sort
ACCEPTS = {
    "keys": {"tiled", "merge", "radix_tiled"},
    "kv": {"tiled", "merge", "radix_tiled"},
    "kv2": {"tiled", "merge", "radix_tiled"},
    "kvw": {"tiled", "radix_tiled"},
    "argsort": {"tiled", "merge", "radix_tiled"},
    "dist_local": {"tiled", "merge"},
    "rows": {"tiled", "radix_tiled"},
}


@pytest.mark.parametrize("op", sorted(ROUTE_TABLE))
def test_route_table_rows(op):
    rows = ROUTE_TABLE[op]
    bounds = [b for b, _ in rows]
    assert rows and bounds == sorted(bounds) and len(set(bounds)) == len(bounds)
    assert bounds[-1] == float("inf")
    assert {e for _, e in rows} <= ACCEPTS[op.removesuffix("64")]
    # a row that repeats its predecessor's engine would be one row
    assert all(a[1] != b[1] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("wide", [False, True])
def test_2d_calls_follow_the_row_table_by_width(wide):
    # a CUDA 2-D call reads rows / rows64 at its row width, on each side of
    # each bound; a payload that does not ride its key (two payloads, or an
    # 8-byte one on 64-bit keys) and tensors on other devices keep "tiled"
    from vkradixsort_tpu_torch.ops import dispatch

    rows = ROUTE_TABLE["rows64" if wide else "rows"]
    dtype = torch.float64 if wide else torch.float32
    one = (torch.zeros(1, dtype=torch.int32),)
    for (bound, engine), (_, above) in zip(rows, rows[1:]):
        for width, want in ((int(bound), engine), (int(bound) + 1, above)):
            keys = torch.empty((3, width), dtype=dtype, device="meta")
            assert dispatch._route_rows(_on_cuda(keys), one) == want
            assert dispatch._route_rows(_on_cuda(keys), one * 2) == "tiled"
            assert dispatch._route_rows(keys, one) == "tiled"  # not on a CUDA device
    eight = (torch.zeros(1, dtype=torch.int64),)
    keys = _on_cuda(torch.empty((3, 1 << 20), dtype=dtype, device="meta"))
    assert dispatch._route_rows(keys, eight) == ("tiled" if wide else "radix_tiled")


def _on_cuda(t):
    """A stand-in of ``t`` whose device reads as a CUDA device: the router
    reads only the shape, the dtype and the device's type."""
    class OnCuda:
        shape, dtype = t.shape, t.dtype
        device = torch.device("cuda", 0)

        def numel(self):
            return t.numel()

    return OnCuda()


@pytest.mark.parametrize("nck,wide", [(1, False), (2, True)])
def test_distributed_local_engine_follows_the_table(nck, wide):
    # the distributed sort's local engine on a CUDA device reads
    # dist_local / dist_local64 at the chunk size: on each side of a row
    from vkradixsort_tpu_torch.parallel.distributed import _pick_local_engine

    rows = ROUTE_TABLE["dist_local64" if wide else "dist_local"]
    vals = [torch.zeros(1, dtype=torch.int32)]
    for (bound, engine), (_, above) in zip(rows, rows[1:]):
        for n, want in ((int(bound), engine), (int(bound) + 1, above)):
            got = _pick_local_engine(None, torch.int32, vals, n, nck, torch.device("cuda"))
            assert got == ("merge" if want == "merge" else "xla")
    assert _pick_local_engine(None, torch.int32, vals, 1 << 24, nck, torch.device("cpu")) == "xla"
