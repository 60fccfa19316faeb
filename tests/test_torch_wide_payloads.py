"""Wide payload sets through ``sort_pairs`` on CPU tensors: 1 to 6 columns
of 1, 2, 4 and 8 bytes on u32 and u64 keys, on the default route, on
radix_tiled (the keys sorted with their u32 positions, then
``gather.gather_columns``) and on tiled, held against the benchmark's plain
reference (``sortbench/reference.py``); the lineitem set also against the
JAX package's tiled sort, and the benchmark's two cells of that set run
whole at a small size, where the check passes the program and rejects each
fault of an answer. Their keys, uniform over 64 bits, have no ties, so the
control (equal keys in reverse input order) is an exact answer there: the
faults stand in for it.

Tolerance: exact (bitwise). A stable sort has one right answer.
"""

import dataclasses
import json
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
import vkradixsort_tpu_torch as vt
from sortbench import harness, reference
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from vkradixsort_tpu_torch.ops import gather, radix_tiled
from vkradixsort_tpu_torch.ops.common import complement
from vkradixsort_tpu_torch.utils import profiling

N = 4096
LINEITEM = (torch.int64,) * 4 + (torch.int32,)  # l_quantity .. l_tax, l_shipdate
PAYLOAD_SETS = {  # the payload dtypes of each case, 1 to 6 columns
    "i8": (torch.int8,),
    "u64": (torch.uint64,),
    "i16-f32": (torch.int16, torch.float32),
    "f32-i32-u32": (torch.float32, torch.int32, torch.uint32),
    "lineitem": LINEITEM,
    "bool-i16-f32-f64-u8-i64": (torch.bool, torch.int16, torch.float32, torch.float64,
                                torch.uint8, torch.int64),
}
BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
NEW_CELLS = ("u64-uniform-pairs-1e8", "u64-lineitem-1e8")


def _keys(dtype, kind, n=N, seed=7):
    """Keys uniform over the dtype's width, or with heavy ties (13 values
    and the dtype's maximum)."""
    gen = torch.Generator().manual_seed(seed)
    bits = BITS[dtype.itemsize]
    if kind == "uniform":
        k = torch.randint(torch.iinfo(bits).min, torch.iinfo(bits).max, (n,), dtype=bits,
                          generator=gen)
    else:
        k = torch.randint(0, 13, (n,), dtype=bits, generator=gen)
        k[torch.rand(n, generator=gen) < 0.1] = -1  # the unsigned maximum
    return k.view(dtype)


def _column(dtype, i, n=N):
    """Random bits of ``dtype``, NaNs and all for floats."""
    gen = torch.Generator().manual_seed(100 + i)
    if dtype == torch.bool:
        return torch.rand(n, generator=gen) < 0.5
    bits = BITS[dtype.itemsize]
    info = torch.iinfo(bits)
    return torch.randint(info.min, info.max, (n,), dtype=bits, generator=gen).view(dtype)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(reference.bits(got.view(BITS[got.element_size()])),
                       reference.bits(want.view(BITS[want.element_size()])))


@pytest.mark.parametrize("backend", [None, "radix_tiled", "tiled"])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "ties"])
@pytest.mark.parametrize("key_dtype", [torch.uint32, torch.uint64])
@pytest.mark.parametrize("payloads", sorted(PAYLOAD_SETS))
def test_wide_sort_pairs_is_the_reference(payloads, key_dtype, kind, descending, backend):
    keys = _keys(key_dtype, kind)
    cols = tuple(_column(d, i) for i, d in enumerate(PAYLOAD_SETS[payloads]))
    before = profiling.counters()
    ok, ov = vt.sort_pairs(keys, cols, backend=backend, descending=descending)
    moved = profiling.since(before)
    assert moved.get("route." + (backend or "tiled")) == 1
    # descending is the ascending stable sort of the complemented keys
    ref_in = complement(keys) if descending else keys
    ref_k, ref_v = reference.sort_pairs(ref_in, cols)
    assert isinstance(ov, tuple) and len(ov) == len(cols)
    _same(ok, complement(ref_k) if descending else ref_k)
    for o, r in zip(ov, ref_v):
        _same(o, r)
    # the gather's plain twin is the library route's torch indexing
    perm = reference.permutation(ref_in)
    got = gather.gather_columns(perm.to(torch.int32).view(torch.uint32), cols)
    for g, c in zip(got, cols):
        _same(g, reference.take(c, perm))


# the card's onesweep tile of u32 and u64 keys with a u32 payload
# (Shape<K, 4> in csrc/onesweep.cu): tile + 1 rows leave one row in a last tile
# of the pass that makes the positions
ONESWEEP_TILE = {np.uint32: 512 * 15, np.uint64: 512 * 13}


@pytest.mark.parametrize("key_dtype,n", [
    pytest.param(np.uint32, N, id="uint32"),
    pytest.param(np.uint64, N, id="uint64"),
    *(pytest.param(d, n, id=f"{np.dtype(d).name}-n{n}")
      for d in (np.uint32, np.uint64) for n in (0, 1, 2, ONESWEEP_TILE[d] + 1)),
])
def test_lineitem_set_is_the_jax_tiled_sort(key_dtype, n):
    # on radix_tiled the keys ride with the u32 positions that the first
    # onesweep pass makes (one radix.positions_in_pass), then the gather
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 64, size=n).astype(key_dtype)  # ties: stability shows
    cols = [rng.integers(-(2**62), 2**62, size=n, dtype=np.int64) for _ in range(4)]
    cols.append(rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32))
    jk, jv = vk.sort_pairs(jnp.asarray(keys), tuple(jnp.asarray(c) for c in cols),
                           backend="tiled")
    for backend in (None, "radix_tiled"):
        before = profiling.counters()
        ok, ov = vt.sort_pairs(torch.from_numpy(keys), tuple(torch.from_numpy(c) for c in cols),
                               backend=backend)
        made = profiling.since(before).get("radix.positions_in_pass", 0)
        assert made == (backend == "radix_tiled" and n > 1)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jk))
        for o, j in zip(ov, jv):
            np.testing.assert_array_equal(o.numpy(), np.asarray(j))


@pytest.mark.parametrize("payload", [torch.int8, torch.int16, torch.float32, torch.uint64])
def test_radix_tiled_keeps_the_container(payload):
    keys = _keys(torch.uint32, "ties")
    col = _column(payload, 0)
    ok, ov = radix_tiled.sort_radix_tiled(keys, col)
    ref_k, (ref_v,) = reference.sort_pairs(keys, (col,))
    _same(ok, ref_k)
    _same(ov, ref_v)
    ok, ov = radix_tiled.sort_radix_tiled(keys, (col, col))
    assert isinstance(ov, tuple) and len(ov) == 2
    _same(ov[0], ref_v)
    _same(ov[1], ref_v)
    assert radix_tiled.sort_radix_tiled(keys, None)[1] is None
    assert radix_tiled.sort_radix_tiled(keys, ())[1] == ()


def test_gather_columns_refuses_what_the_kernel_does_not_take():
    perm = torch.arange(8, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(TypeError, match="uint32"):
        gather.gather_columns(perm.view(torch.int32), (perm,))
    with pytest.raises(ValueError, match="shape"):
        gather.gather_columns(perm, (torch.zeros(7),))
    with pytest.raises(TypeError, match="bytes"):
        gather.gather_columns(perm, (torch.zeros(8, dtype=torch.complex128),))
    with pytest.raises(TypeError):
        vt.sort_pairs(perm, (perm, torch.zeros(8, dtype=torch.complex128)), backend="radix_tiled")


def test_new_cells_run_whole_on_the_cpu(tmp_path):
    """The two cells of the lineitem configuration, from copies of their
    files with the table cut to 4096 rows: each run is correct."""
    root = harness.ROOT
    (tmp_path / "sortbench" / "configs").mkdir(parents=True)
    shutil.copytree(root / "sortbench" / "traffic", tmp_path / "sortbench" / "traffic")
    shutil.copytree(root / "sortbench" / "metrics", tmp_path / "sortbench" / "metrics")
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    config = json.loads((root / "sortbench" / "configs" / "u64-uniform.json").read_text())
    (tmp_path / "sortbench" / "configs" / "u64-uniform.json").write_text(
        json.dumps({**config, "rows": N}))
    for name in NEW_CELLS:
        cell = harness.find_cell(name, root=tmp_path)
        assert cell.config["rows"] == N
        r = harness.run_cell(cell, 2**31 + 17, 0.2, False, "cpu", time.perf_counter())
        assert r["correct"], r["checks"]
        assert {"rows_per_s", "call_ms_p95", "peak_mem_gb", "setup_s"} <= set(r["metrics"])


def _unchanged(keys, payloads):
    return keys.clone(), tuple(p.clone() for p in payloads)


def _half_left_out(keys, payloads):
    """Sorts the first half of the rows and passes the rest through."""
    h = keys.shape[0] // 2
    k, ps = harness.program_sort()(keys[:h], tuple(p[:h] for p in payloads))
    return (torch.cat([reference.bits(k), reference.bits(keys[h:])]).view(keys.dtype),
            tuple(torch.cat([reference.bits(a), reference.bits(p[h:])]).view(p.dtype)
                  for a, p in zip(ps, payloads)))


def _answer_altered(keys, payloads):
    """The program's answer with one payload value changed."""
    k, ps = harness.program_sort()(keys, payloads)
    last = ps[-1].clone()
    reference.bits(last)[keys.shape[0] // 3] ^= 1
    return k, (*ps[:-1], last)


def _column_unmoved(keys, payloads):
    """The program's answer with its first payload left in input order."""
    k, ps = harness.program_sort()(keys, payloads)
    return k, (payloads[0].clone(), *ps[1:])


def _columns_swapped(keys, payloads):
    """The program's answer with its first two payloads (l_quantity and
    l_extendedprice, both int64) swapped."""
    k, ps = harness.program_sort()(keys, payloads)
    return k, (ps[1], ps[0], *ps[2:])


FAULTS = [(name, fault) for name in NEW_CELLS
          for fault in (_unchanged, _half_left_out, _answer_altered, _column_unmoved)] + [
    ("u64-lineitem-1e8", _columns_swapped)]


@pytest.mark.parametrize("name, fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_new_cells_reject_a_wrong_answer(name, fault):
    cell = harness.find_cell(name)
    cell = dataclasses.replace(cell, config={**cell.config, "rows": N})
    r = harness.run_cell(cell, 2**31 + 4243, 0.05, False, "cpu", time.perf_counter(),
                         sort_fn=fault)
    assert not r["correct"]
    assert r["checks"]["mismatched_rows"]["value"] > 0
    assert r["failed"] >= 1
