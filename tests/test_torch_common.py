"""The PyTorch port's key encodings and library-sort path, held bitwise
against the JAX package on the same numpy inputs (CPU tensors).

Tolerance: exact. Encodings are bit patterns and a stable sort has one
right answer, so every comparison is bitwise equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
from vkradixsort_tpu.ops import common as jcommon
from vkradixsort_tpu_torch.ops import common, segsort, tiled
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


N = 4096
# (name, numpy bit dtype of the same width) — bf16 has no numpy dtype, so
# every dtype travels as raw bits and is viewed on each side
DTYPES = [
    ("uint8", np.uint8), ("uint16", np.uint16), ("uint32", np.uint32), ("uint64", np.uint64),
    ("int8", np.uint8), ("int16", np.uint16), ("int32", np.uint32), ("int64", np.uint64),
    ("float16", np.uint16), ("bfloat16", np.uint16), ("float32", np.uint32),
    ("float64", np.uint64),
]
_SPECIALS = {  # +-0, +-inf, quiet and signalling NaNs of both signs, as bits
    "float16": [0x0000, 0x8000, 0x7C00, 0xFC00, 0x7E00, 0xFE00, 0x7C01, 0xFC01],
    "bfloat16": [0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81, 0xFF81],
    "float32": [0x0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                0x7F800001, 0xFF800001],
    "float64": [0x0, 1 << 63, 0x7FF0 << 48, 0xFFF0 << 48, 0x7FF8 << 48, 0xFFF8 << 48,
                (0x7FF0 << 48) | 1, (0xFFF0 << 48) | 1],
}
_SIGNED_BITS = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _bits(rng, name, bits_dtype, n=N):
    info = np.iinfo(bits_dtype)
    b = rng.integers(0, int(info.max), size=n, dtype=bits_dtype, endpoint=True)
    special = np.asarray(_SPECIALS.get(name, [0, int(info.max)]), dtype=bits_dtype)
    b[: special.size] = special
    return b


def _torch_of(bits, name):
    t = torch.from_numpy(bits.view(_SIGNED_BITS[bits.itemsize]).copy())
    return t.view(getattr(torch, name))


def _jax_of(bits, name):
    return jnp.asarray(bits).view(jnp.dtype(name))


def _np_bits(t):
    """Bit pattern of a torch tensor as numpy unsigned ints."""
    return common.bits_view(t).numpy().view(f"u{t.element_size()}")


@pytest.mark.parametrize("name,bits_dtype", DTYPES, ids=[d[0] for d in DTYPES])
def test_encode_decode_match_jax(rng, name, bits_dtype):
    bits = _bits(rng, name, bits_dtype)
    t = _torch_of(bits, name)
    enc = common.encode_keys(t)
    jenc = jcommon.encode_keys(_jax_of(bits, name))
    assert enc.dtype == common.sortable_dtype(t.dtype)
    np.testing.assert_array_equal(_np_bits(enc), np.asarray(jenc))
    dec = common.decode_keys(enc, t.dtype)
    assert dec.dtype == t.dtype
    np.testing.assert_array_equal(_np_bits(dec), bits)
    jdec = jcommon.decode_keys(jenc, jnp.dtype(name))
    np.testing.assert_array_equal(_np_bits(dec), np.asarray(jdec).view(bits_dtype))


def test_encode_rejects_bool_and_complex():
    for dtype in (torch.bool, torch.complex64):
        with pytest.raises(TypeError):
            common.encode_keys(torch.zeros(3, dtype=dtype))


def test_shape_helpers():
    assert [common.round_up(x, 8) for x in (0, 1, 8, 9)] == [0, 8, 8, 16]
    assert [common.cdiv(x, 8) for x in (0, 1, 8, 9)] == [0, 1, 1, 2]


@pytest.mark.parametrize(
    "key_dtype,payloads",
    [
        (np.uint32, ()),
        (np.uint32, (np.uint32,)),
        (np.uint32, (np.float32, np.int64)),
        (np.uint64, ()),
        (np.uint64, (np.uint32,)),
        (np.uint64, (np.uint64, np.float32)),
    ],
)
def test_tiled_matches_jax_tiled(rng, key_dtype, payloads):
    # heavy ties (a 16-value key domain, spread over the full width) make
    # every tie-order error visible
    n = 5003
    hi = np.iinfo(key_dtype).max
    keys = (rng.integers(0, 16, size=n).astype(np.uint64) * np.uint64(hi // 15)).astype(key_dtype)
    vals = [rng.integers(0, 1 << 30, size=n).astype(d) for d in payloads]
    out_k, out_v = tiled.sort_tiled(torch.from_numpy(keys), tuple(torch.from_numpy(v) for v in vals))
    if vals:
        jk, jv = vk.sort_pairs(jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals),
                               backend="tiled")
    else:
        jk, jv = vk.sort(jnp.asarray(keys), backend="tiled"), ()
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(jk))
    for o, j in zip(out_v, jv):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))


def test_signed_order_round_trip_and_segments(rng):
    enc = torch.from_numpy(rng.integers(0, 1 << 32, size=(6, 700), dtype=np.uint32) % 50)
    s = segsort.to_signed_order(enc)
    assert s.dtype == torch.int32
    assert torch.equal(segsort.from_signed_order(s, torch.uint32), enc)
    pos = torch.arange(700, dtype=torch.int32).expand(6, 700)
    out_k, (out_p,) = segsort.sort_segments(enc, (pos,))
    perm = np.argsort(enc.numpy(), axis=1, kind="stable")
    np.testing.assert_array_equal(out_k.numpy(), np.take_along_axis(enc.numpy(), perm, 1))
    np.testing.assert_array_equal(out_p.numpy(), perm)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_remix_matches_jax(rng, dtype):
    from vkradixsort_tpu.utils.timing import _remix
    from vkradixsort_tpu_torch.utils.timing import remix

    x = rng.integers(0, np.iinfo(dtype).max, size=N, dtype=dtype, endpoint=True)
    got = remix(torch.from_numpy(x))
    np.testing.assert_array_equal(_np_bits(got), np.asarray(_remix(jnp.asarray(x))))


def test_device_measurements_refuse_the_cpu():
    import vkradixsort_tpu_torch as vt
    from vkradixsort_tpu_torch.utils.timing import measure_seconds_per_call

    keys = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_seconds_per_call(vt.sort, keys)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            vt.GPUContext()


def test_context_helpers_refuse_the_cpu(monkeypatch):
    """``default_context()``, ``GPUContext.devices`` and ``mesh_1d`` raise
    without a card and never fall back to the CPU."""
    from vkradixsort_tpu_torch.engine import context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        context.GPUContext()
    with pytest.raises(RuntimeError, match="CUDA"):
        context.default_context()
    # a context made as if a card were there still finds none to mesh over
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    ctx = context.GPUContext("cuda:0")
    for call in (lambda: ctx.devices, ctx.mesh_1d, lambda: ctx.mesh_1d(1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
