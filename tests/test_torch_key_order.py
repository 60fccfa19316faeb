"""The key-order transform (``ops/keyorder.py``) on the CPU, and the
descending float64 sort of db-benchmark's groupby q8 that runs through it.

The wrapper's plain version (one mask from each key's top bit, one XOR) is
held bitwise to the composed torch transform it replaces
(``common.encode_keys``, ``complement``, ``decode_keys``) for every 4- and
8-byte key dtype, both ways, on edge values. The q8 sort of v3-law keys
(``sortbench/keys/runif_round.py``) with an int32 id6 payload is held bitwise
to the benchmark call's plain reference (``sortbench/calls/sort_pairs_desc``)
and to the JAX package's ``sort_pairs(..., descending=True)``.

Tolerance: exact (bit patterns; NaNs with payload bits included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vkradixsort_tpu as vk
import vkradixsort_tpu_torch as vt
from sortbench import harness, inputs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from vkradixsort_tpu_torch.ops import common, keyorder
from vkradixsort_tpu_torch.utils import profiling

WIDE_DTYPES = [torch.int32, torch.int64, torch.float32, torch.float64, torch.uint32, torch.uint64]
NARROW_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.uint16, torch.float16, torch.bfloat16]
V3_LAW = {"dtype": "float64", "distribution": "runif_round", "max": 100, "digits": 6}
SEED = 2**31 + 2022


def _edge_bits(dtype) -> list:
    """Bit patterns of ``dtype``'s edge values, as unsigned ints."""
    nbits = 8 * dtype.itemsize
    sign, ones = 1 << (nbits - 1), (1 << nbits) - 1
    if not dtype.is_floating_point:  # 0, 1, -1 (all ones), the int max and min
        return [0, 1, ones, sign - 1, sign, sign + 1, ones - 1]
    exp = ((1 << (nbits - 1)) - 1) ^ ((1 << {4: 23, 8: 52}[dtype.itemsize]) - 1)
    quiet = 1 << ({4: 22, 8: 51}[dtype.itemsize])
    patterns = [0, 1, 2, quiet - 1,  # +0.0, the least denormals, the greatest
                exp - 1, exp,  # the float max, +inf
                exp | quiet, exp | quiet | 5, exp | 1]  # NaNs: quiet, with payload, signalling
    return patterns + [p | sign for p in patterns]  # -0.0, -denormals, -max, -inf, -NaNs


def _keys(dtype, n=3000, seed=7) -> torch.Tensor:
    """Random bit patterns of ``dtype`` with its edge values spread over them."""
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(-(2**62), 2**62, (n,), generator=g, dtype=torch.int64)
    keys = bits.view(torch.int8)[: n * dtype.itemsize].view(dtype).clone()
    if dtype.itemsize in keyorder.KEY_BYTES:
        edges = torch.tensor([common.signed_bits(b, dtype.itemsize) for b in _edge_bits(dtype)],
                             dtype=common._SIGNED[dtype.itemsize])
        common.bits_view(keys)[: edges.numel() * 7 : 7] = edges
    return keys


def _composed(keys, descending):
    enc = common.encode_keys(keys)
    return common.complement(enc) if descending else enc


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(common.bits_view(a), common.bits_view(b))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", WIDE_DTYPES + NARROW_DTYPES, ids=str)
def test_transform_matches_composed_torch_transform(dtype, descending):
    keys = _keys(dtype)
    enc = keyorder.encode(keys, descending)
    _same_bits(enc, _composed(keys, descending))
    dec = keyorder.decode(enc.clone(), dtype, descending)
    _same_bits(dec, common.decode_keys(_composed(enc, descending), dtype))
    _same_bits(dec, keys)  # the round trip
    in_place = enc.clone()
    dec = keyorder.decode(in_place, dtype, descending, in_place=True)
    _same_bits(dec, keys)
    if dtype.itemsize in keyorder.KEY_BYTES:  # the answer is written over the sorted keys
        assert dec.data_ptr() == in_place.data_ptr()


@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64], ids=str)
def test_unsigned_ascending_is_the_identity(dtype):
    keys = _keys(dtype, n=64)
    assert keyorder.identity(dtype, False) and not keyorder.identity(dtype, True)
    assert keyorder.encode(keys, False) is keys
    assert keyorder.decode(keys, dtype, False).data_ptr() == keys.data_ptr()


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=str)
def test_masks_order_the_edge_values(dtype):
    """Edge values taken in their own order (floats in IEEE-754 total order:
    -NaN, -inf, -max, ..., -0.0, +0.0, ..., +inf, +NaN) encode to strictly
    ascending unsigned ints; complemented, to strictly descending ones."""
    size = dtype.itemsize
    sign, ones = 1 << (8 * size - 1), (1 << (8 * size)) - 1

    def rank(b):
        if dtype.is_floating_point:
            return (0, -(b ^ sign)) if b & sign else (1, b)
        return common.signed_bits(b, size) if dtype.is_signed else b

    bits = sorted(set(_edge_bits(dtype)), key=rank)
    keys = torch.tensor([common.signed_bits(b, size) for b in bits],
                        dtype=common._SIGNED[size]).view(dtype)
    for descending in (False, True):
        enc = keyorder.key_order_plain(keys, *keyorder.masks(dtype, descending, inverse=False))
        got = [v & ones for v in enc.tolist()]
        assert len(set(got)) == len(got) and got == sorted(got, reverse=descending)


@pytest.mark.parametrize("dtype", NARROW_DTYPES, ids=str)
def test_narrow_keys_have_no_kernel_masks(dtype):
    with pytest.raises(TypeError):
        keyorder.masks(dtype, False, inverse=False)


def _v3_frame(n, digits, seed=SEED):
    """v3-law float64 keys (``digits`` after the point) and an int32 id6."""
    gen = torch.Generator().manual_seed(seed)
    keys = inputs.make_keys(n, {**V3_LAW, "digits": digits}, "cpu", gen)
    id6 = inputs.make_column("id6", "int32", n, "cpu", gen)
    return keys, id6


V3_CASES = [(5000, 6), (70_000, 6), (70_000, 1)]  # digits 1: 1001 values, nearly every row tied


@pytest.mark.parametrize("backend", [None, "radix_tiled"])
@pytest.mark.parametrize("n,digits", V3_CASES)
def test_v3_desc_sort_matches_the_call_reference(n, digits, backend):
    keys, id6 = _v3_frame(n, digits)
    call = harness.load_call("sort_pairs_desc")
    ok, ov = vt.sort_pairs(keys, id6, descending=True, backend=backend)
    rk, (rv,) = call.reference(keys, (id6,))
    _same_bits(ok, rk)
    _same_bits(ov, rv)
    out = call.program()(keys, (id6,))
    _same_bits(out[0], rk)
    _same_bits(out[1][0], rv)


@pytest.fixture(scope="module")
def jax_v3_answers():
    out = {}
    for n, digits in V3_CASES:
        keys, id6 = _v3_frame(n, digits)
        jk, jv = vk.sort_pairs(jnp.asarray(keys.numpy()), jnp.asarray(id6.numpy()),
                               descending=True)
        out[(n, digits)] = (np.asarray(jk), np.asarray(jv))
    return out


@pytest.mark.parametrize("n,digits", V3_CASES)
def test_v3_desc_sort_matches_jax(jax_v3_answers, n, digits):
    keys, id6 = _v3_frame(n, digits)
    jk, jv = jax_v3_answers[(n, digits)]
    assert jk.dtype == np.float64 and jv.dtype == np.int32
    for backend in (None, "radix_tiled"):
        ok, ov = vt.sort_pairs(keys, id6, descending=True, backend=backend)
        np.testing.assert_array_equal(ok.numpy().view(np.uint64), jk.view(np.uint64))
        np.testing.assert_array_equal(ov.numpy(), jv)


@pytest.fixture(scope="module")
def profiler_started():
    """The profiler's first start in a process takes about 2 s: paid here
    once, not in the first case that profiles."""
    with profile(activities=[ProfilerActivity.CPU]):
        pass


def _span_names(call):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.name.startswith("vkrs/keys/")]


@pytest.mark.parametrize("dtype,descending,spans", [
    (torch.float64, True, ["vkrs/keys/encode", "vkrs/keys/decode"]),
    (torch.int32, False, ["vkrs/keys/encode", "vkrs/keys/decode"]),
    (torch.uint64, True, ["vkrs/keys/encode", "vkrs/keys/decode"]),
    (torch.uint32, False, []),
    (torch.uint64, False, []),
])
@pytest.mark.parametrize("entry", ["sort_pairs", "sort", "argsort", "sort_segments"])
def test_transform_spans_where_not_the_identity(profiler_started, entry, dtype, descending,
                                                spans):
    """sort_pairs, sort and sort_segments encode and decode; argsort
    encodes only, since it returns no keys."""
    keys = _keys(dtype, n=512)
    calls = {
        "sort_pairs": lambda: vt.sort_pairs(keys, torch.arange(512), descending=descending,
                                            backend="radix_tiled"),
        "sort": lambda: vt.sort(keys, descending=descending),
        "argsort": lambda: vt.argsort(keys, descending=descending, backend="radix_tiled"),
        "sort_segments": lambda: vt.sort_segments(keys.view(8, 64), descending=descending),
    }
    want = spans[:1] if entry == "argsort" else spans
    assert _span_names(calls[entry]) == want


@pytest.mark.parametrize("backend", [None, "radix_tiled", "merge"])
@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=str)
def test_argsort_without_decode_is_the_stable_permutation(dtype, backend):
    keys = _keys(dtype, n=4096)
    for descending in (False, True):
        got = vt.argsort(keys, descending=descending, backend=backend)
        enc = _composed(keys, descending)
        want = torch.sort(common._order_view(enc), stable=True).indices
        assert torch.equal(common.bits_view(got).long(), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.uint64], ids=str)
def test_segments_desc_match_each_row_sorted(dtype):
    keys = _keys(dtype, n=4096).view(16, 256)
    vals = torch.arange(4096, dtype=torch.int32).view(16, 256)
    ok, ov = vt.sort_segments(keys, vals, descending=True)
    for r in range(16):
        rk, rv = vt.sort_pairs(keys[r].clone(), vals[r].clone(), descending=True)
        _same_bits(ok[r].contiguous(), rk)
        assert torch.equal(ov[r], rv)


def test_cpu_tensors_launch_nothing():
    before = profiling.counters()
    keys, id6 = _v3_frame(5000, 6)
    vt.sort_pairs(keys, id6, descending=True, backend="radix_tiled")
    assert "launch.key_order" not in profiling.since(before)
