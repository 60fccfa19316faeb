"""The row sort of 2-D keys on the CPU: ``radix_tiled.sort_rows`` and
``argsort_rows`` (the plain versions of the row-segmented onesweep, with a
small forced tile so that rows of one tile, of a partial last tile and of
several tiles all occur) and the public 2-D calls on their route, held
against the JAX package's ``sort_segments`` and 2-D ``argsort`` on the same
numpy inputs, and against the plain reference of the benchmark's call
``topp_sort_rows``.

Tolerance: exact. A stable sort has one answer; floats compare as bit
patterns, NaNs and -0.0 included.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
import vkradixsort_tpu_torch as vt
from sortbench import harness
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from vkradixsort_tpu_torch.ops import histogram, keyorder, radix_tiled
from vkradixsort_tpu_torch.ops.common import bits_view, num_passes
from vkradixsort_tpu_torch.utils import profiling

TILE = 16  # the forced tile of the plain row passes
WIDTHS = {"1": 1, "7": 7, "tile-1": TILE - 1, "tile": TILE, "tile+1": TILE + 1}
ROWS = [1, 37]
KEY_DTYPES = [np.float32, np.float64, np.uint32, np.int64]
# (key dtype, payload dtype or None): every payload width on 32-bit keys, and
# those that ride 64-bit keys (1, 2, 4 bytes)
KV = [(np.float32, None), (np.float32, np.uint8), (np.float32, np.int32),
      (np.float32, np.float64), (np.float64, np.int16), (np.float64, np.int32),
      (np.uint32, np.int16), (np.uint32, np.uint64), (np.int64, np.uint8), (np.int64, None)]


@pytest.fixture(autouse=True)
def forced_tile(monkeypatch):
    """The plain row pass cuts its rows into tiles of :data:`TILE`."""
    monkeypatch.setattr(radix_tiled, "onesweep_rows_pass_plain",
                        functools.partial(radix_tiled.onesweep_rows_pass_plain, tile=TILE))


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.numpy().dtype.itemsize == want.dtype.itemsize
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _keys(dtype, rows, width, seed=0) -> np.ndarray:
    """Keys with heavy ties; floats also carry +-0.0, +-inf and NaNs of both
    signs, integers their dtype's extremes."""
    rng = np.random.default_rng([np.dtype(dtype).num, rows, width, seed])
    dtype = np.dtype(dtype)
    n = rows * width
    if dtype.kind == "f":
        keys = (rng.integers(-12, 12, size=n) / 4).astype(dtype)
        ibits = {4: np.uint32, 8: np.uint64}[dtype.itemsize]
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], dtype=dtype)
        neg_nan = (special[4:].view(ibits) | ibits(1 << (8 * dtype.itemsize - 1))).view(dtype)
        special = np.concatenate([special, neg_nan])
        at = rng.choice(n, size=min(n, 3 * rows), replace=False)
        keys[at] = special[np.arange(at.size) % special.size]
    else:
        info = np.iinfo(dtype)
        keys = rng.integers(0, 9, size=n).astype(dtype)
        keys[rng.random(n) < 0.05] = info.max
        keys[rng.random(n) < 0.05] = info.min
    return keys.reshape(rows, width)


def _payload(dtype, shape, seed=1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    raw = rng.integers(0, 2**63, size=n, dtype=np.int64).view(np.uint8)
    return raw[: n * np.dtype(dtype).itemsize].view(dtype).reshape(shape).copy()


def _twin_sort(keys: torch.Tensor, vals, descending: bool):
    """The row twin as the dispatcher drives it: encode, sort_rows, decode."""
    enc = keyorder.encode(keys, descending)
    out_k, out_v = radix_tiled.sort_rows(enc, vals)
    return keyorder.decode(out_k, keys.dtype, descending), out_v


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("key_dtype,payload", KV,
                         ids=lambda x: "none" if x is None else np.dtype(x).name)
def test_sort_rows_twin_matches_jax(key_dtype, payload, width, rows, descending):
    keys = _keys(key_dtype, rows, WIDTHS[width])
    vals = None if payload is None else _payload(payload, keys.shape)
    before = profiling.counters()
    ok, ov = _twin_sort(torch.from_numpy(keys), None if vals is None else torch.from_numpy(vals),
                        descending)
    assert profiling.since(before).get("radix.rows") == 1
    if vals is None:
        _eq(ok, vk.sort_segments(jnp.asarray(keys), descending=descending))
        assert ov is None
    else:
        jk, jv = vk.sort_segments(jnp.asarray(keys), jnp.asarray(vals), descending=descending)
        _eq(ok, jk)
        _eq(ov, jv)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_argsort_rows_twin_matches_jax(key_dtype, width, rows, descending):
    keys = _keys(key_dtype, rows, WIDTHS[width])
    before = profiling.counters()
    perm = radix_tiled.argsort_rows(keyorder.encode(torch.from_numpy(keys), descending))
    moved = profiling.since(before)
    assert moved.get("radix.rows") == 1
    assert moved.get("radix.positions_in_pass", 0) == (WIDTHS[width] > 1)
    assert perm.dtype == torch.uint32
    _eq(perm, vk.argsort(jnp.asarray(keys), descending=descending))


ROW_CALLS = {
    "sort_pairs": lambda k, v, d: vt.sort_pairs(k, v, descending=d),
    "sort_pairs_tuple": lambda k, v, d: vt.sort_pairs(k, (v,), descending=d)[1][0],
    "sort": lambda k, v, d: vt.sort(k, descending=d),
    "argsort": lambda k, v, d: vt.argsort(k, descending=d),
    "sort_segments": lambda k, v, d: vt.sort_segments(k, v, descending=d),
}
JAX_CALLS = {
    "sort_pairs": lambda k, v, d: vk.sort_pairs(k, v, descending=d),
    "sort_pairs_tuple": lambda k, v, d: vk.sort_pairs(k, (v,), descending=d)[1][0],
    "sort": lambda k, v, d: vk.sort(k, descending=d),
    "argsort": lambda k, v, d: vk.argsort(k, descending=d),
    "sort_segments": lambda k, v, d: vk.sort_segments(k, v, descending=d),
}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("key_dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("call", sorted(ROW_CALLS))
def test_2d_calls_on_their_route_match_jax(call, key_dtype, descending):
    """The public 2-D calls with the backend left to route: on CPU tensors
    "tiled", torch.sort along the rows, counted as route.tiled."""
    keys = _keys(key_dtype, 37, TILE + 1)
    vals = _payload(np.int32, keys.shape)
    before = profiling.counters()
    got = ROW_CALLS[call](torch.from_numpy(keys), torch.from_numpy(vals), descending)
    moved = profiling.since(before)
    assert {k: v for k, v in moved.items() if k.startswith("route.")} == {"route.tiled": 1}
    assert not moved.get("radix.rows")
    want = JAX_CALLS[call](jnp.asarray(keys), jnp.asarray(vals), descending)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        _eq(g, w)


def _topp_call(width):
    """The benchmark's call ``topp_sort_rows`` with its row width set to
    ``width``."""
    call = harness.load_call("topp_sort_rows")
    call.ROW = width
    return call


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("width", WIDTHS)
def test_sort_rows_twin_matches_the_calls_reference(width, rows):
    """Float32 logits with their int32 token ids, the twin and the public
    call against ``topp_sort_rows.reference`` (its own total order and the
    u64 composite of row and key), and the control rejected."""
    keys = _keys(np.float32, rows, WIDTHS[width])
    ids = _payload(np.int32, keys.shape)
    call = _topp_call(WIDTHS[width])
    ref_k, (ref_v,) = call.reference(torch.from_numpy(keys.reshape(-1)),
                                     (torch.from_numpy(ids.reshape(-1)),))
    ok, ov = _twin_sort(torch.from_numpy(keys), torch.from_numpy(ids), False)
    _eq(ok.reshape(-1), ref_k.numpy())
    _eq(ov.reshape(-1), ref_v.numpy())
    pk, (pv,) = call.program()(torch.from_numpy(keys.reshape(-1)), (torch.from_numpy(ids.reshape(-1)),))
    _eq(pk, ref_k.numpy())
    _eq(pv, ref_v.numpy())


def test_the_calls_control_reverses_ties_within_each_row():
    keys = _keys(np.float32, 37, TILE + 1)
    ids = _payload(np.int32, keys.shape)
    call = _topp_call(TILE + 1)
    flat = (torch.from_numpy(keys.reshape(-1)), (torch.from_numpy(ids.reshape(-1)),))
    ok, ov = _twin_sort(torch.from_numpy(keys), torch.from_numpy(ids), False)
    ck, (cv,) = call.reference(*flat, reverse_ties=True)
    assert torch.equal(ck.view(torch.int32), ok.reshape(-1).view(torch.int32))  # keys alike
    assert not torch.equal(cv, ov.reshape(-1))  # ties in reverse order
    assert torch.equal(cv.view(37, -1).sort(1).values, ov.sort(1).values)  # within each row


@pytest.mark.parametrize("width", [1, 7, 300, 4099])
@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64])
def test_digit_histograms_rows_are_each_rows_offsets(dtype, width):
    rows = 5
    keys = torch.from_numpy(_keys(np.uint32 if dtype == torch.uint32 else np.uint64, rows,
                                  width)).view(dtype)
    got = histogram.digit_histograms_rows(keys)
    assert got.dtype == torch.int32 and tuple(got.shape) == (num_passes(dtype), rows, 256)
    for r in range(rows):
        assert torch.equal(got[:, r], histogram.digit_histograms_plain(keys[r]) + r * width)


@pytest.mark.parametrize("tile", [1, 3, TILE, 1 << 14])
@pytest.mark.parametrize("values", ["none", "u16", "positions"])
def test_row_pass_does_not_depend_on_the_tile(tile, values):
    keys = torch.from_numpy(_keys(np.uint32, 6, 41)).view(torch.uint32)
    vals = {"none": None, "u16": torch.from_numpy(_payload(np.uint16, (6, 41))),
            "positions": radix_tiled.row_positions(6, 41, "cpu")}[values]
    offsets = histogram.digit_histograms_rows(keys)
    plain = radix_tiled.onesweep_rows_pass_plain.func  # the unforced plain pass
    want = plain(keys, vals, 8, offsets[1], 7)
    got = plain(keys, vals, 8, offsets[1], tile)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(bits_view(g), bits_view(w))


def test_positions_are_each_elements_place_in_its_row():
    keys = torch.from_numpy(_keys(np.uint32, 3, 9)).view(torch.uint32)
    offsets = histogram.digit_histograms_rows(keys)
    made = radix_tiled.onesweep_rows_pass(keys, radix_tiled.POSITIONS, 0, offsets[0])
    fed = radix_tiled.onesweep_rows_pass(keys, radix_tiled.row_positions(3, 9, "cpu"), 0,
                                         offsets[0])
    assert made[1].dtype == torch.uint32
    assert torch.equal(made[1], fed[1]) and torch.equal(made[0], fed[0])
    assert int(bits_view(made[1]).max()) == 8


@pytest.mark.parametrize("numel,key_bytes,payloads,rides", [
    (100, 4, (), True), (100, 4, (torch.int8,), True), (100, 4, (torch.int64,), True),
    (100, 8, (torch.int32,), True), (100, 8, (torch.int64,), False),
    (100, 4, (torch.int32, torch.int32), False), ((1 << 31) - 1, 4, (), True),
    (1 << 31, 4, (), False), (100, 4, (torch.bool,), True),
])
def test_accepts_rows(numel, key_bytes, payloads, rides):
    vals = tuple(torch.zeros(1, dtype=d) for d in payloads)
    assert radix_tiled.accepts_rows(numel, key_bytes, vals) == rides


def test_sort_rows_refuses_what_does_not_ride():
    keys = torch.zeros(2, 5, dtype=torch.uint64)
    with pytest.raises(TypeError):
        radix_tiled.sort_rows(keys, torch.zeros(2, 5, dtype=torch.int64))
    with pytest.raises(ValueError):
        radix_tiled.sort_rows(keys, torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(TypeError):
        radix_tiled.sort_rows(keys.view(-1))


@pytest.mark.parametrize("shape", [(0, 5), (4, 0), (3, 1)])
def test_sort_rows_of_empty_or_single_columns(shape):
    keys = torch.zeros(shape, dtype=torch.uint32)
    out_k, out_v = radix_tiled.sort_rows(keys, radix_tiled.POSITIONS)
    assert out_k.shape == shape and out_v.shape == shape and out_v.dtype == torch.uint32
    assert not out_v.numel() or int(bits_view(out_v).max()) == 0
