"""The PyTorch port's radix engines on CPU tensors, where the kernel wrappers
run their plain versions, held against the JAX package on the same numpy
inputs: the histogram kernel and both modes of the rank-and-scatter kernel
of ``radix_tiled`` (destinations; keys and payload moved), whole passes and
sorts, the ``fused`` one-launch sort, the ``reference`` radix oracle, and
the public API through ``backend="radix_tiled"``, ``"fused"`` and
``"reference"``.

Tolerance: exact (bitwise). Digit counts are integers and a stable sort has
one right answer. The JAX Pallas kernels run in interpret mode, each shape
once, in module-scoped fixtures.
"""

import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
import vkradixsort_tpu_torch as vt
from vkradixsort_tpu.engine.config import SortConfig as JaxSortConfig
from vkradixsort_tpu.ops import common as jcommon
from vkradixsort_tpu.ops import fused as jfused
from vkradixsort_tpu.ops import histogram as jhistogram
from vkradixsort_tpu.ops import radix_tiled as jradix_tiled
from vkradixsort_tpu.ops import reference as jreference
from vkradixsort_tpu_torch.ops import common, fused, histogram, radix_tiled, reference
from vkradixsort_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


JCFG = vk.SortConfig(interpret=True)
TILE = 2048
N_SLICE = 3001  # one ragged size for every JAX radix_tiled call: one compile per key width
ROOT = pathlib.Path(__file__).resolve().parents[1]


def launches(wrapper: str) -> int:
    """The launch counter of a kernel wrapper, ``launch.<wrapper>``."""
    return profiling.counters().get("launch." + wrapper, 0)


def _keys(seed: int, n: int, dtype, kind: str) -> np.ndarray:
    """Seeded keys: "ties" (13 values), "max" (a fifth equal to the dtype's
    maximum, the JAX padding sentinel, the rest 7 values), "uniform", or
    "constant"."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    if kind == "uniform":
        return rng.integers(0, int(hi), size=n, dtype=dtype, endpoint=True)
    if kind == "constant":
        return np.full(n, 0x5A, dtype=dtype)
    keys = rng.integers(0, 13 if kind == "ties" else 7, size=n).astype(dtype)
    keys *= dtype(0x01010101 if dtype == np.uint32 else 0x0101010101010101)
    if kind == "max":
        keys[rng.random(n) < 0.2] = hi
    return keys


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want) -> None:
    """Bitwise equality of a tensor and an array of the same width."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(common.bits_view(got).numpy().view(want.dtype), want)


def _eq_counts(got, want) -> None:
    """Equal integers; JAX's cumsum widens int32 to int64 under x64."""
    want = np.asarray(want)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# digit helpers and the reference oracle (plain jnp on the JAX side)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_digit_helpers_match_jax(dtype):
    keys = _keys(1, 1000, dtype, "uniform")
    tdtype = torch.uint32 if dtype == np.uint32 else torch.uint64
    assert common.num_passes(tdtype) == jcommon.num_passes(dtype)
    assert (common.BITS_PER_PASS, common.NUM_BINS) == (jcommon.BITS_PER_PASS, jcommon.NUM_BINS)
    for shift in range(0, 8 * np.dtype(dtype).itemsize, 8):
        got = common.extract_digit(_t(keys), shift)
        assert got.dtype == torch.int32
        _eq(got, jcommon.extract_digit(jnp.asarray(keys), shift))


@pytest.mark.parametrize("dtype,kind", [(np.uint32, "ties"), (np.uint64, "max"),
                                        (np.uint32, "uniform")])
@pytest.mark.parametrize("num_chunks", [1, 4])
def test_reference_phases_match_jax(dtype, kind, num_chunks):
    n = 4096
    keys = _keys(2, n, dtype, kind)
    vals = np.arange(n, dtype=np.uint32)
    for shift in (0, 8 * np.dtype(dtype).itemsize - 8):
        hist = reference.chunk_histograms(_t(keys), shift, num_chunks)
        jhist = jreference.chunk_histograms(jnp.asarray(keys), shift, num_chunks)
        _eq_counts(hist, jhist)
        _eq_counts(reference.exclusive_bin_offsets(hist), jreference.exclusive_bin_offsets(jhist))
        digits = common.extract_digit(_t(keys), shift).view(num_chunks, -1)
        jdigits = jcommon.extract_digit(jnp.asarray(keys), shift).reshape(num_chunks, -1)
        _eq_counts(reference.rank_in_chunk(digits), jreference.rank_in_chunk(jdigits))
        ok, ov = reference.radix_pass(_t(keys), _t(vals), shift, num_chunks)
        jk, jv = jreference.radix_pass(jnp.asarray(keys), jnp.asarray(vals), shift, num_chunks)
        _eq(ok, jk)
        _eq(ov, jv)
        ok, none = reference.radix_pass(_t(keys), None, shift, num_chunks)
        assert none is None
        _eq(ok, jk)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.float64])
def test_reference_sorts_match_jax(dtype):
    rng = np.random.default_rng(3)
    keys = (rng.standard_normal(2500) * 50).round().astype(dtype)
    vals = rng.standard_normal(2500).astype(np.float32)
    _eq(reference.radix_sort_reference(_t(keys)),
        jreference.radix_sort_reference(jnp.asarray(keys)))
    ok, ov = reference.radix_sort_reference(_t(keys), _t(vals), num_chunks=5)
    jk, jv = jreference.radix_sort_reference(jnp.asarray(keys), jnp.asarray(vals), num_chunks=5)
    _eq(ok, jk)
    _eq(ov, jv)
    perm = reference.argsort_reference(_t(keys))
    assert perm.dtype == torch.uint32
    _eq(perm, jreference.argsort_reference(jnp.asarray(keys)))


def test_chunk_histograms_need_whole_chunks():
    with pytest.raises(ValueError, match="divide"):
        reference.chunk_histograms(_t(np.zeros(10, np.uint32)), 0, 3)


# ---------------------------------------------------------------------------
# the histogram kernel's wrapper against the JAX kernel (interpret mode)

HIST_CASES = [
    (np.uint32, 5000, 0, "ties"),
    (np.uint32, 5000, 24, "max"),
    (np.uint64, 4097, 8, "max"),
    (np.uint64, 4097, 40, "uniform"),
    (np.uint64, 4097, 56, "ties"),
    (np.uint32, TILE, 16, "constant"),
]


@pytest.fixture(scope="module")
def jax_histograms():
    """JAX ``tile_histograms`` in interpret mode for every case, trimmed to
    the real tiles with the sentinel padding taken off bin 255 of the last
    real tile (the JAX kernel pads to 8 tiles with dtype-max keys)."""
    out = {}
    for dtype, n, shift, kind in HIST_CASES:
        keys = _keys(n + shift, n, dtype, kind)
        hist = np.asarray(jhistogram.tile_histograms(jnp.asarray(keys), shift, tile=TILE,
                                                     interpret=True))
        nt = -(-n // TILE)
        hist = hist[:nt].copy()
        hist[nt - 1, 255] -= nt * TILE - n
        out[(dtype, n, shift, kind)] = (keys, hist)
    return out


@pytest.mark.parametrize("case", HIST_CASES, ids=lambda c: f"{c[0].__name__}-{c[1]}-{c[2]}-{c[3]}")
def test_tile_histograms_match_jax(jax_histograms, case):
    keys, want = jax_histograms[case]
    before = launches("tile_histograms")
    got = histogram.tile_histograms(_t(keys), case[2], TILE)
    assert got.dtype == torch.int32
    _eq(got, want)
    assert launches("tile_histograms") == before  # CPU: the plain version


def test_tile_histograms_plain_at_other_tiles():
    keys = _keys(4, 3000, np.uint32, "ties")
    for tile in (1, 7, 128, 4096):
        got = histogram.tile_histograms(_t(keys), 8, tile).numpy()
        nt = -(-keys.size // tile)
        digits = (keys >> 8) & 255
        want = np.zeros((nt, 256), np.int32)
        np.add.at(want, (np.arange(keys.size) // tile, digits), 1)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the destination kernel's wrapper against the JAX kernel (interpret mode)

DEST_CASES = [
    (np.uint32, 5000, 8, "ties"),
    (np.uint32, TILE, 0, "constant"),
    (np.uint64, 4097, 48, "max"),
]


@pytest.fixture(scope="module")
def jax_destinations():
    out = {}
    for dtype, n, shift, kind in DEST_CASES:
        keys = _keys(7 * n + shift, n, dtype, kind)
        dest = jradix_tiled.pass_destinations(jnp.asarray(keys), shift, tile=TILE,
                                              interpret=True)
        out[(dtype, n, shift, kind)] = (keys, np.asarray(dest))
    return out


@pytest.mark.parametrize("case", DEST_CASES, ids=lambda c: f"{c[0].__name__}-{c[1]}-{c[2]}-{c[3]}")
def test_pass_destinations_match_jax(jax_destinations, case):
    keys, want = jax_destinations[case]
    before = launches("tile_destinations")
    got = radix_tiled.pass_destinations(_t(keys), case[2], TILE)
    assert got.dtype == torch.int32
    _eq(got, want)
    _eq(radix_tiled.pass_destinations_plain(_t(keys), case[2], TILE), want)
    assert launches("tile_destinations") == before


@pytest.mark.parametrize("tile", [1, 32, 100, 4096])
def test_destinations_are_the_stable_permutation(tile):
    # at any tile, one pass's destinations are the inverse of the stable
    # argsort of its digit
    keys = _keys(5, 2500, np.uint64, "max")
    shift = 56
    dest = radix_tiled.pass_destinations(_t(keys), shift, tile).numpy()
    order = np.argsort((keys >> np.uint64(shift)) & np.uint64(255), kind="stable")
    np.testing.assert_array_equal(dest[order], np.arange(keys.size))


# ---------------------------------------------------------------------------
# whole passes (histogram, scan, rank and move; on a CPU tensor the plain
# versions of the histogram and scatter kernels) against JAX's
# radix_pass_tiled and sort_radix_tiled: Pallas destinations in interpret
# mode, then XLA's scatter

PASS_CASES = [  # (key dtype, n, shift, tile, kind, payload dtype or None): ragged last tiles
    (np.uint32, N_SLICE, 8, TILE, "ties", np.uint16),
    (np.uint32, N_SLICE, 24, TILE, "max", None),
    (np.uint64, 4097, 48, TILE, "max", np.uint64),
    (np.uint64, 4097, 0, 1024, "ties", np.float32),
    (np.uint32, 5000, 16, 1024, "uniform", np.int8),
]


def _payload(seed: int, n: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max), size=n, dtype=dtype, endpoint=True)


@pytest.fixture(scope="module")
def jax_passes():
    out = {}
    for i, (dtype, n, shift, tile, kind, vdt) in enumerate(PASS_CASES):
        keys = _keys(40 + i, n, dtype, kind)
        vals = None if vdt is None else _payload(50 + i, n, vdt)
        jk, jv = jradix_tiled.radix_pass_tiled(
            jnp.asarray(keys), None if vals is None else jnp.asarray(vals), shift, tile,
            interpret=True)
        out[i] = keys, vals, np.asarray(jk), None if jv is None else np.asarray(jv)
    return out


@pytest.mark.parametrize("i", range(len(PASS_CASES)),
                         ids=[f"{c[0].__name__}-{c[1]}-{c[2]}-{c[3]}-{c[4]}-"
                              f"{getattr(c[5], '__name__', None)}" for c in PASS_CASES])
def test_radix_pass_tiled_matches_jax(jax_passes, i):
    keys, vals, jk, jv = jax_passes[i]
    shift, tile = PASS_CASES[i][2:4]
    before = (launches("tile_scatter"), launches("tile_destinations"),
              launches("tile_histograms"))
    tk, tv = _t(keys), None if vals is None else _t(vals)
    ok, ov = radix_tiled.radix_pass_tiled(tk, tv, shift, tile)
    _eq(ok, jk)
    if vals is None:
        assert ov is None
    else:
        _eq(ov, jv)
        _eq(tv, vals)  # the input is not written
    _eq(tk, keys)
    assert (launches("tile_scatter"), launches("tile_destinations"),
            launches("tile_histograms")) == before  # CPU: the plain versions


@pytest.fixture(scope="module")
def jax_sort_u32():
    """JAX's whole sort_radix_tiled of u32 keys with ties and a 2-byte
    payload: its four passes at this size and tile are the slice fixture's
    compiles."""
    keys = _keys(60, N_SLICE, np.uint32, "ties")
    vals = _payload(61, N_SLICE, np.int16)
    jk, jv = jradix_tiled.sort_radix_tiled(jnp.asarray(keys), jnp.asarray(vals), TILE,
                                           interpret=True)
    return keys, vals, np.asarray(jk), np.asarray(jv)


def test_sort_radix_tiled_matches_jax(jax_sort_u32):
    keys, vals, jk, jv = jax_sort_u32
    ok, ov = radix_tiled.sort_radix_tiled(_t(keys), _t(vals))
    _eq(ok, jk)
    _eq(ov, jv)


@pytest.mark.parametrize("tile", [1, 100, 4096])
def test_tile_scatter_moves_to_the_destinations(tile):
    # the scatter mode's plain version is the destination mode's, applied
    keys = _keys(6, 2500, np.uint64, "max")
    vals = _payload(7, 2500, np.int16)
    base = reference.exclusive_bin_offsets(histogram.tile_histograms(_t(keys), 56, tile))
    dest = radix_tiled.tile_destinations(_t(keys), 56, tile, base).numpy()
    ok, ov = radix_tiled.tile_scatter(_t(keys), _t(vals), 56, tile, base)
    want_k, want_v = np.empty_like(keys), np.empty_like(vals)
    want_k[dest], want_v[dest] = keys, vals
    _eq(ok, want_k)
    _eq(ov, want_v)
    ok, none = radix_tiled.tile_scatter(_t(keys), None, 56, tile, base)
    assert none is None
    _eq(ok, want_k)


# ---------------------------------------------------------------------------
# the onesweep sort, the card's radix_tiled route, through its plain
# versions: one digit_histograms a sort, then one onesweep_pass a pass whose
# tiles' bases are the look-back sums

ONESWEEP_CASES = [  # (key dtype, n, kind)
    (np.uint32, 5000, "ties"), (np.uint32, 3001, "uniform"), (np.uint32, 1, "uniform"),
    (np.uint64, 4097, "max"), (np.uint64, 2500, "uniform"), (np.uint64, 777, "constant"),
]


@pytest.mark.parametrize("dtype,n,kind", ONESWEEP_CASES,
                         ids=[f"{c[0].__name__}-{c[1]}-{c[2]}" for c in ONESWEEP_CASES])
def test_digit_histograms_are_row_0_of_each_pass_table(dtype, n, kind):
    keys = _t(_keys(n + 3, n, dtype, kind))
    before = launches("digit_histograms")
    offsets = histogram.digit_histograms(keys)
    assert tuple(offsets.shape) == (np.dtype(dtype).itemsize, 256)
    for p in range(offsets.shape[0]):
        table = reference.exclusive_bin_offsets(histogram.tile_histograms(keys, 8 * p, TILE))
        _eq_counts(offsets[p], table[0].numpy())
    assert launches("digit_histograms") == before  # CPU: the plain version


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("tile", [1, 7, 100, 2048, 4096])
def test_lookback_bases_are_the_whole_table(dtype, tile):
    # offset[p] plus the digit's count in earlier tiles is the bin-major
    # scan of the tiles' counts, at any tile
    keys = _t(_keys(tile, 3000, dtype, "max"))
    offsets = histogram.digit_histograms(keys)
    for p in range(offsets.shape[0]):
        table = reference.exclusive_bin_offsets(histogram.tile_histograms(keys, 8 * p, tile))
        got = radix_tiled.lookback_bases_plain(keys, 8 * p, tile, offsets[p])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), table.numpy())


@pytest.mark.parametrize("payload", [None, np.uint8, np.int16, np.float32, np.uint64],
                         ids=lambda d: "keys" if d is None else np.dtype(d).name)
@pytest.mark.parametrize("tile", [100, 4096])
def test_onesweep_pass_is_the_tiled_pass(payload, tile):
    # every pass of a u64 sort, at two tiles and through the wrapper: the
    # tiled pass's keys and payload
    keys = _t(_keys(8, 2500, np.uint64, "max"))
    vals = None if payload is None else _t(_payload(9, 2500, payload))
    offsets = histogram.digit_histograms(keys)  # a pass's digits are any pass input's
    before = launches("onesweep_pass")
    for p in range(8):
        want = radix_tiled.radix_pass_tiled(keys, vals, 8 * p, TILE)
        for got in (radix_tiled.onesweep_pass_plain(keys, vals, 8 * p, offsets[p], tile),
                    radix_tiled.onesweep_pass(keys, vals, 8 * p, offsets[p])):
            _eq(got[0], common.bits_view(want[0]).numpy().view(np.uint64))
            if vals is None:
                assert got[1] is None
            else:
                _eq(got[1], common.bits_view(want[1]).numpy().view(np.dtype(payload)))
        keys, vals = want
    assert launches("onesweep_pass") == before


@pytest.mark.parametrize("case", ["u32-ties-int16", "u32-kv"])
def test_sort_onesweep_matches_jax(jax_sort_u32, jax_radix_tiled_slice, case):
    if case == "u32-ties-int16":
        keys, vals, jk, jv = jax_sort_u32
    else:  # ascending u32 keys: the encoding is the identity
        (keys, vals), (jk, jv) = jax_radix_tiled_slice[("kv32", False)]
    ok, ov = radix_tiled.sort_onesweep(_t(keys), _t(vals))
    _eq(ok, jk)
    _eq(ov, jv)


@pytest.mark.parametrize("kind", ["max", "uniform", "constant"])
def test_sort_onesweep_u64_is_the_stable_sort(kind):
    keys = _keys(30, 4097, np.uint64, kind)
    perm = np.argsort(keys, kind="stable")
    ok, ov = radix_tiled.sort_onesweep(_t(keys), _t(np.arange(keys.size, dtype=np.uint32)))
    _eq(ok, keys[perm])
    _eq(ov, perm.astype(np.uint32))
    alone, none = radix_tiled.sort_onesweep(_t(keys))
    assert none is None
    _eq(alone, keys[perm])


# ---------------------------------------------------------------------------
# the fused kernel's wrapper against the JAX kernel (interpret mode)

FUSED_CASES = [
    (np.uint32, 3000, np.uint32, "ties"),
    (np.uint64, 2000, np.uint64, "max"),
    (np.uint32, 1500, np.float32, "uniform"),
    (np.uint64, 1000, None, "ties"),
]


@pytest.fixture(scope="module")
def jax_fused():
    out = {}
    for i, (kdt, n, vdt, kind) in enumerate(FUSED_CASES):
        keys = _keys(100 + i, n, kdt, kind)
        rng = np.random.default_rng(i)
        vals = {None: None, np.uint32: np.arange(n, dtype=np.uint32),
                np.uint64: rng.integers(0, 2**64, size=n, dtype=np.uint64),
                np.float32: rng.standard_normal(n).astype(np.float32)}[vdt]
        jk, jv = jfused.sort_fused(jnp.asarray(keys), None if vals is None else jnp.asarray(vals),
                                   JaxSortConfig(interpret=True))
        out[i] = (keys, vals, np.asarray(jk), None if jv is None else np.asarray(jv))
    return out


@pytest.mark.parametrize("i", range(len(FUSED_CASES)),
                         ids=[f"{c[0].__name__}-{c[1]}-{getattr(c[2], '__name__', None)}-{c[3]}"
                              for c in FUSED_CASES])
def test_sort_fused_matches_jax(jax_fused, i):
    keys, vals, jk, jv = jax_fused[i]
    before = launches("sort_fused")
    tk = _t(keys)
    tv = None if vals is None else _t(vals)
    ok, ov = fused.sort_fused(tk, tv, vt.SortConfig())
    _eq(ok, jk)
    if vals is None:
        assert ov is None
    else:
        _eq(ov, jv)
        _eq(tv, vals)  # the input is not written
    _eq(tk, keys)
    assert launches("sort_fused") == before


# ---------------------------------------------------------------------------
# the slice: the public API through the three engines


def _slice_keys(dtype, kind="ties"):
    return _keys(11, N_SLICE, dtype, kind)


@pytest.fixture(scope="module")
def jax_radix_tiled_slice():
    """The JAX radix_tiled engine in interpret mode, at one size and key
    width (one compile of each kernel per pass): u32 kv in both directions,
    f32 argsort, i32 keys-only. 64-bit keys meet the JAX engine in the
    destination cases above and JAX's reference below."""
    k32 = _slice_keys(np.uint32)
    v32 = np.arange(N_SLICE, dtype=np.uint32)
    f32 = (np.random.default_rng(12).standard_normal(N_SLICE) * 10).round().astype(np.float32)
    i32 = _slice_keys(np.uint32, "max").view(np.int32)
    out = {}
    for desc in (False, True):
        jk, jv = vk.sort_pairs(jnp.asarray(k32), jnp.asarray(v32), config=JCFG,
                               backend="radix_tiled", descending=desc)
        out[("kv32", desc)] = ((k32, v32), (np.asarray(jk), np.asarray(jv)))
    out["argsort_f32"] = (f32, np.asarray(vk.argsort(jnp.asarray(f32), config=JCFG,
                                                      backend="radix_tiled")))
    out["sort_i32"] = (i32, np.asarray(vk.sort(jnp.asarray(i32), config=JCFG,
                                                backend="radix_tiled", descending=True)))
    return out


@pytest.mark.parametrize("backend", ["radix_tiled", "fused", "reference"])
def test_slice_matches_jax_radix_tiled(jax_radix_tiled_slice, backend):
    # fused and reference give the same stable answer as JAX's radix_tiled
    res = jax_radix_tiled_slice
    for desc in (False, True):
        (k, v), (jk, jv) = res[("kv32", desc)]
        ok, ov = vt.sort_pairs(_t(k), _t(v), backend=backend, descending=desc)
        _eq(ok, jk)
        _eq(ov, jv)
    f32, jperm = res["argsort_f32"]
    perm = vt.argsort(_t(f32), backend=backend)
    assert perm.dtype == torch.uint32
    _eq(perm, jperm)
    i32, jsorted = res["sort_i32"]
    _eq(vt.sort(_t(i32), backend=backend, descending=True), jsorted)


@pytest.mark.parametrize("backend", ["radix_tiled", "fused", "reference"])
@pytest.mark.parametrize("key_dtype,val_dtype", [(np.float32, np.float32), (np.int32, np.uint64),
                                                 (np.float64, np.int64), (np.uint64, np.uint64)])
def test_slice_matches_jax_reference(backend, key_dtype, val_dtype):
    rng = np.random.default_rng(21)
    n = 2777
    keys = (rng.standard_normal(n) * 30).round().astype(key_dtype)
    vals = rng.integers(-(2**31), 2**31, size=n).astype(val_dtype)
    for desc in (False, True):
        ok, ov = vt.sort_pairs(_t(keys), _t(vals), backend=backend, descending=desc)
        jk, jv = vk.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), backend="reference",
                               descending=desc)
        _eq(ok, jk)
        _eq(ov, jv)
        _eq(vt.sort(_t(keys), backend=backend, descending=desc),
            vk.sort(jnp.asarray(keys), backend="reference", descending=desc))


@pytest.mark.parametrize("backend", ["radix_tiled", "fused", "reference"])
@pytest.mark.parametrize("n", [0, 1])
def test_slice_tiny_inputs(backend, n):
    keys = np.arange(n, dtype=np.uint32)[::-1].copy()
    vals = np.arange(n, dtype=np.float32)
    ok, ov = vt.sort_pairs(_t(keys), _t(vals), backend=backend)
    jk, jv = vk.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), backend="reference")
    _eq(ok, jk)
    _eq(ov, jv)
    _eq(vt.argsort(_t(keys), backend=backend), vk.argsort(jnp.asarray(keys), backend="reference"))


def test_reference_backend_carries_many_payloads():
    rng = np.random.default_rng(31)
    n = 1500
    keys = rng.integers(0, 40, size=n).astype(np.uint64)
    vals = (rng.standard_normal(n).astype(np.float32), np.arange(n, dtype=np.int64),
            rng.integers(0, 255, size=n).astype(np.uint8))
    ok, ov = vt.sort_pairs(_t(keys), tuple(_t(v) for v in vals), backend="reference")
    jk, jv = vk.sort_pairs(jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals),
                           backend="reference")
    assert isinstance(ov, tuple)
    _eq(ok, jk)
    for o, j in zip(ov, jv):
        _eq(o, j)


# ---------------------------------------------------------------------------
# refusals


@pytest.mark.parametrize("backend", ["fused", "samplesort"])
def test_one_payload_engines_refuse_two(backend):
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="single payload"):
        vt.sort_pairs(k, (k, k), backend=backend)


def test_fused_refuses_more_than_fused_max_n():
    cfg = vt.SortConfig()
    assert cfg.fused_max_n == JaxSortConfig().fused_max_n == 1 << 15
    # the per-pass API's tile: JAX's chunk 2048, the port's 16384 from the
    # H100 sweep (PERF.md); the sorted result does not depend on it
    assert (JaxSortConfig().chunk, histogram.TILE) == (TILE, 16384)
    with pytest.raises(ValueError, match="fused_max_n"):
        vt.sort(torch.zeros(cfg.fused_max_n + 1, dtype=torch.int32), backend="fused")
    with pytest.raises(ValueError, match="fused_max_n"):
        vt.sort(torch.zeros(101, dtype=torch.int32), backend="fused",
                config=cfg.replace(fused_max_n=100))
    out = vt.sort(torch.arange(101, 0, -1, dtype=torch.int32), backend="fused",
                  config=cfg.replace(fused_max_n=101))
    np.testing.assert_array_equal(out.numpy(), np.arange(1, 102))
    with pytest.raises(TypeError, match="4- or 8-byte"):
        vt.sort_pairs(torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int16),
                      backend="fused")


def test_radix_tiled_refuses_n_of_2_pow_31():
    # a stride-0 view stands in for 2^31 keys without allocating them
    big = torch.zeros(1, dtype=torch.int32).view(torch.uint32).expand(1 << 31)
    base = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        radix_tiled.pass_destinations(big, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        radix_tiled.tile_destinations(big, 0, TILE, base)
    with pytest.raises(ValueError, match="2\\^31"):
        radix_tiled.sort_radix_tiled(big)


def test_onesweep_refuses_n_of_2_pow_31():
    big = torch.zeros(1, dtype=torch.int32).view(torch.uint32).expand(1 << 31)
    with pytest.raises(ValueError, match="2\\^31"):
        histogram.digit_histograms(big)
    with pytest.raises(ValueError, match="2\\^31"):
        radix_tiled.onesweep_pass(big, None, 0, torch.zeros(256, dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\^31"):
        radix_tiled.sort_onesweep(big)


def test_onesweep_wrappers_reject_what_the_kernels_do_not_take():
    k = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    offset = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(TypeError):
        histogram.digit_histograms(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        histogram.digit_histograms(k.view(2, 4))
    with pytest.raises(ValueError, match="offset"):
        radix_tiled.onesweep_pass(k, None, 0, torch.zeros(255, dtype=torch.int32))
    with pytest.raises(ValueError, match="offset"):
        radix_tiled.onesweep_pass(k, None, 0, offset.to(torch.int64))
    with pytest.raises(ValueError):
        radix_tiled.onesweep_pass(k, None, 32, offset)  # past the key's width
    with pytest.raises(ValueError):
        radix_tiled.onesweep_pass(k, torch.zeros(7, dtype=torch.int32), 0, offset)
    with pytest.raises(TypeError, match="payloads"):
        radix_tiled.onesweep_pass(k, torch.zeros(8, dtype=torch.complex128), 0, offset)
    meta = torch.zeros(8, dtype=torch.int32, device="meta").view(torch.uint32)
    with pytest.raises(ValueError, match="CUDA"):
        histogram.digit_histograms(meta)
    with pytest.raises(ValueError, match="CUDA"):
        radix_tiled.onesweep_pass(meta, None, 0, offset.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        radix_tiled.sort_radix_tiled(meta)  # off the CPU the onesweep sort, which needs CUDA


def test_radix_wrappers_reject_what_the_kernels_do_not_take():
    k = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(TypeError):
        histogram.tile_histograms(torch.zeros(8, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        histogram.tile_histograms(k, 32)  # past the key's width
    with pytest.raises(ValueError):
        radix_tiled.tile_destinations(k, 0, 4, torch.zeros((3, 256), dtype=torch.int32))
    base = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        radix_tiled.tile_scatter(k, torch.zeros(7, dtype=torch.int32), 0, 4, base)
    with pytest.raises(TypeError, match="payloads"):
        radix_tiled.tile_scatter(k, torch.zeros(8, dtype=torch.complex128), 0, 4, base)
    meta = torch.zeros(8, dtype=torch.int32, device="meta").view(torch.uint32)
    with pytest.raises(ValueError, match="CUDA"):
        radix_tiled.tile_scatter(meta, None, 0, 4, base.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        histogram.tile_histograms(meta, 0)  # neither the CPU's plain version nor a kernel
    with pytest.raises(ValueError, match="CUDA"):
        fused.sort_fused(meta)
    with pytest.raises(TypeError):
        fused.sort_fused(torch.zeros(8, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package


def _imported_modules(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "vkradixsort_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert any(f.name == "radix_tiled.py" for f in files)
    for f in files:
        for name in _imported_modules(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "vkradixsort_tpu"), (f, name)


def test_port_import_loads_no_jax():
    mods = ["vkradixsort_tpu_torch"] + [
        f"vkradixsort_tpu_torch.ops.{p.stem}"
        for p in sorted((ROOT / "vkradixsort_tpu_torch" / "ops").glob("*.py"))
        if p.stem != "__init__"
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules\n"
        + "       if m.split('.')[0] in ('jax', 'jaxlib', 'vkradixsort_tpu')]\n"
        + "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
