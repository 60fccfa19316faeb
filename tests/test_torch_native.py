"""The port's native host runtime (``vkradixsort_tpu_torch.native``) held
against the JAX package's (``vkradixsort_tpu.native``) on the same numpy
inputs, on the CPU: fixtures, oracle sorts and exact checks.

Both runtimes are built here by the same compiler, so their seeded fixtures
agree bitwise (``std::uniform_int_distribution`` is the standard library's);
the oracles and checks agree with numpy as well. Also: the port's module
imports neither JAX nor the JAX package, builds its library under
``build/native/``, and its numpy fallback gives the same oracle and check
answers.

Tolerance: exact (bitwise).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

import vkradixsort_tpu_torch.native as tn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from vkradixsort_tpu import native as jn

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = [np.uint32, np.uint64]
SIZES = [0, 1, 63, 64, 65, 100_000]


@pytest.fixture(scope="module", autouse=True)
def both_native():
    """Both libraries built and loaded; otherwise both fall back to numpy
    and the fixture comparison would hold nothing."""
    assert jn.available(), "the JAX package's host runtime did not build"
    assert tn.available(), f"the port's host runtime did not build: {tn._LIB_ERR}"


def _keys(kind: str, n: int, dtype) -> np.ndarray:
    """"ties" (8 values), "max" (ties, a fifth equal to the dtype's maximum)
    or "uniform" (the whole range)."""
    rng = np.random.default_rng(n + np.dtype(dtype).itemsize)
    hi = int(np.iinfo(dtype).max)
    if kind == "uniform":
        return rng.integers(0, hi, size=n, dtype=dtype, endpoint=True)
    keys = rng.integers(0, 8, size=n).astype(dtype)
    if kind == "max":
        keys[rng.random(n) < 0.2] = hi
    return keys


def _range(name: str, dtype):
    return {"default": {},
            "narrow": {"lo": 100, "hi": 163},
            "full": {"lo": 0, "hi": int(np.iinfo(dtype).max)}}[name]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rng_range", ["default", "narrow", "full"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", [1, 0xBE7C])
def test_generate_uniform_matches_jax(seed, n, rng_range, dtype):
    kw = _range(rng_range, dtype)
    got = tn.generate_uniform(seed, n, dtype=dtype, **kw)
    assert got.dtype == dtype and got.shape == (n,)
    np.testing.assert_array_equal(got, jn.generate_uniform(seed, n, dtype=dtype, **kw))
    np.testing.assert_array_equal(got, tn.generate_uniform(seed, n, dtype=dtype, **kw))
    if n:
        assert got.min() >= kw.get("lo", 0) and got.max() <= kw.get("hi", 0x0FFFFFFF)
    if n >= 64:  # every chunk of the seeded grid is its own generator
        assert not np.array_equal(got, tn.generate_uniform(seed + 1, n, dtype=dtype, **kw))


@pytest.mark.parametrize("n", SIZES)
def test_generate_descending_matches_jax(n):
    got = tn.generate_descending(n)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jn.generate_descending(n))
    np.testing.assert_array_equal(got, np.arange(n, 0, -1).astype(np.uint32))


@pytest.mark.parametrize("n", [1, 1000, 70_001])
@pytest.mark.parametrize("kind", ["ties", "max", "uniform"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("algorithm", ["std", "radix"])
def test_oracle_sort_matches_jax(algorithm, dtype, kind, n):
    keys = _keys(kind, n, dtype)
    before = keys.copy()
    got = tn.oracle_sort(keys, algorithm)
    np.testing.assert_array_equal(keys, before)  # the input is untouched
    assert got.dtype == keys.dtype
    np.testing.assert_array_equal(got, jn.oracle_sort(keys, algorithm))
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("n", [0, 1, 1000, 70_001])
@pytest.mark.parametrize("kind", ["ties", "max", "uniform"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_oracle_argsort_matches_jax(dtype, kind, n):
    """u32 keys take the native radix argsort; u64 keys numpy's, in both
    modules."""
    keys = _keys(kind, n, dtype)
    got = tn.oracle_argsort(keys)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jn.oracle_argsort(keys))
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


def _mismatched(dtype, n: int, where: str):
    a = _keys("uniform", n, dtype)
    b = a.copy()
    at = {"none": None, "first": 0, "middle": n // 2, "last": n - 1}[where]
    if at is not None:
        b[at] ^= dtype(1 << 20)
        b[n - 1] ^= dtype(1)  # a later mismatch too, where there is room
    return a, b, -1 if at is None else at


@pytest.mark.parametrize("n", [1, 1000, 100_000])
@pytest.mark.parametrize("where", ["none", "first", "middle", "last"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_first_mismatch_matches_jax(dtype, where, n):
    a, b, want = _mismatched(dtype, n, where)
    assert tn.first_mismatch(a, b) == want
    assert jn.first_mismatch(a, b) == want


def _unsorted(case: str, dtype):
    """(array, its first unsorted index) for one case."""
    n = 5000
    a = np.sort(_keys("ties", n, dtype))
    if case in ("empty", "one", "sorted"):
        return a[:{"empty": 0, "one": 1, "sorted": n}[case]], -1
    if case == "descending":
        d = np.ascontiguousarray(a[::-1])
        return d, int(np.nonzero(d[:-1] > d[1:])[0][0])
    at = {"first": 0, "middle": n // 2, "last": n - 2}[case]
    a[at] = np.iinfo(dtype).max
    return a, at


@pytest.mark.parametrize("case", ["empty", "one", "sorted", "descending", "first", "middle",
                                  "last"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_first_unsorted_matches_jax(dtype, case):
    a, want = _unsorted(case, dtype)
    assert tn.first_unsorted(a) == want
    assert jn.first_unsorted(a) == want


def test_port_module_imports_no_jax():
    code = ("import sys, vkradixsort_tpu_torch.native as n; assert n.available(); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
            "or m == 'vkradixsort_tpu' or m.startswith('vkradixsort_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_library_lands_under_build_native():
    path = pathlib.Path(tn._LIB._name)
    assert path == tn.library_path() == tn.build()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert tn._LIB.vkrs_abi_version() == tn.ABI_VERSION == 1


def test_missing_compiler_falls_back(monkeypatch):
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_LIB_ERR", None)
    monkeypatch.setenv("CXX", str(ROOT / "build" / "no-such-compiler"))
    assert not tn.available() and isinstance(tn._LIB_ERR, OSError)
    keys = _keys("ties", 1000, np.uint32)
    np.testing.assert_array_equal(tn.oracle_sort(keys), np.sort(keys))


def _fallback_cases():
    """(name, call) pairs whose answers the numpy fallback must repeat."""
    cases = []
    for dtype in DTYPES:
        w = np.dtype(dtype).itemsize * 8
        for kind in ("ties", "max", "uniform"):
            keys = _keys(kind, 20_001, dtype)
            for alg in ("std", "radix"):
                cases.append((f"oracle_sort-{alg}-u{w}-{kind}",
                              lambda k=keys, a=alg: tn.oracle_sort(k, a)))
            cases.append((f"oracle_argsort-u{w}-{kind}", lambda k=keys: tn.oracle_argsort(k)))
        for where in ("none", "first", "middle", "last"):
            a, b, _ = _mismatched(dtype, 1000, where)
            cases.append((f"first_mismatch-u{w}-{where}",
                          lambda a=a, b=b: tn.first_mismatch(a, b)))
        for case in ("empty", "one", "sorted", "descending", "middle", "last"):
            a, _ = _unsorted(case, dtype)
            cases.append((f"first_unsorted-u{w}-{case}", lambda a=a: tn.first_unsorted(a)))
    cases.append(("generate_descending", lambda: tn.generate_descending(1000)))
    return cases


FALLBACK_CASES = _fallback_cases()


@pytest.mark.parametrize("name,call", FALLBACK_CASES, ids=[c[0] for c in FALLBACK_CASES])
def test_numpy_fallback_gives_the_same_answers(monkeypatch, name, call):
    native = call()
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_LIB_ERR", RuntimeError("forced fallback"))
    assert not tn.available()
    np.testing.assert_array_equal(call(), native)


def test_fallback_fixtures_keep_their_range(monkeypatch):
    """The fallback's keys differ from mt19937's, but keep the range and
    the seed, the full u64 range included."""
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_LIB_ERR", RuntimeError("forced fallback"))
    a = tn.generate_uniform(3, 10_000)
    assert a.dtype == np.uint32 and a.max() <= 0x0FFFFFFF
    np.testing.assert_array_equal(a, tn.generate_uniform(3, 10_000))
    b = tn.generate_uniform(3, 1000, 0, 2**64 - 1, np.uint64)
    assert b.dtype == np.uint64 and int(b.max()) > 2**63


def test_bad_arguments_raise():
    a = np.zeros(4, np.uint32)
    with pytest.raises(ValueError, match="shape and dtype"):
        tn.first_mismatch(a, np.zeros(5, np.uint32))
    with pytest.raises(ValueError, match="shape and dtype"):
        tn.first_mismatch(a, a.astype(np.uint64))
    with pytest.raises(ValueError, match="algorithm"):
        tn.oracle_sort(a, "quick")
