"""The port's benchmark twin (``vkradixsort_tpu_torch.bench``) against the
root ``bench.py``, on the CPU at small N.

Its gates give bench.py's own verdicts (``device_side_checks``,
``window_oracle_checks``, run through the JAX package) on one correct sort
output and on three corrupted ones: a stability fault inside a window (only
the windows see it), one key out of order and one value re-paired (both
outside every window: only the device-side checks see them). Its pairing
sum is bench.py's: exactly its uint64 sum under x64 (which
``tests/conftest.py`` turns on), and its uint32 sum modulo 2^32 without.
Its ``main`` draws bench.py's inputs and window starts from seed 0xBE7C,
prints exactly one JSON line, and ends in the failure line with exit code 1
on a corrupted sort, a failed ``stable=False`` diagnostic or a missing
card. Its module imports neither JAX nor the JAX package.

Tolerance: exact (bitwise); verdicts equal.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkradixsort_tpu as vk
import vkradixsort_tpu_torch as vt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from vkradixsort_tpu.utils.timing import _remix
from vkradixsort_tpu_torch import bench as tbench
from vkradixsort_tpu_torch.ops.common import bits_view
from vkradixsort_tpu_torch.utils.timing import measure_pairs_seconds_per_call

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 65536
KEYS = ("metric", "value", "unit", "vs_baseline")


def _root_bench():
    """The root bench.py as a module (its ``__main__`` block does not run)."""
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _root_bench()


def _bench_draws(n):
    """bench.py's draws from its seed, replayed line by line
    (``bench.py:144, 147, 158, 114-116``): the 1e6 keys, the n keys, the
    window starts."""
    rng = np.random.default_rng(0xBE7C)
    small = rng.integers(0, 1 << 32, size=1_000_000, dtype=np.uint32)
    keys_np = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    width = 1024
    starts = np.sort(rng.integers(0, n - width, size=16).astype(np.int64))
    starts[0] = 0
    starts[-1] = n - width
    return small, keys_np, starts.tolist()


def _outside(starts, n, width=1024):
    """Positions i with i and i + 1 in no window."""
    covered = np.zeros(n, bool)
    for s in starts:
        covered[s:s + width] = True
    return np.flatnonzero(~covered[:-1] & ~covered[1:])


def _case(kind):
    """(keys, out_k, out_v, window seed): a correct stable sort of keys with
    many ties over the full u32 range, or that output with one fault."""
    rng = np.random.default_rng(11)
    keys = rng.choice(rng.integers(0, 1 << 32, size=512, dtype=np.uint32), size=N)
    perm = np.argsort(keys, kind="stable")
    out_k, out_v = keys[perm], perm.astype(np.uint32)
    win_seed = 5
    free = _outside(tbench.window_starts(np.random.default_rng(win_seed), N), N)
    if kind == "stability":  # two equal keys' values swapped in the first window
        i = int(np.flatnonzero(out_k[:1023] == out_k[1:1024])[0])
        out_v[[i, i + 1]] = out_v[[i + 1, i]]
    elif kind == "key_order":  # a pair moved one place, outside every window
        i = int(free[out_k[free] != out_k[free + 1]][0])
        out_k[[i, i + 1]] = out_k[[i + 1, i]]
        out_v[[i, i + 1]] = out_v[[i + 1, i]]
    elif kind == "repair":  # two values of distinct keys exchanged, outside every window
        i = int(free[0])
        j = int(free[out_k[free] != out_k[i]][0])
        out_v[[i, j]] = out_v[[j, i]]
    return keys, out_k, out_v, win_seed


# kind: (device-side verdict, window verdict)
CASES = {"correct": (True, True), "stability": (True, False), "key_order": (False, True),
         "repair": (False, True)}


@pytest.mark.parametrize("kind", list(CASES))
def test_device_side_checks_give_bench_py_verdicts(kind):
    keys, out_k, out_v, _ = _case(kind)
    vals = np.arange(N, dtype=np.uint32)
    want = jbench.device_side_checks(vk, jnp, jax, jnp.asarray(keys), jnp.asarray(vals),
                                     jnp.asarray(out_k), jnp.asarray(out_v))
    got = tbench.device_side_checks(torch.from_numpy(keys), torch.from_numpy(vals),
                                    torch.from_numpy(out_k), torch.from_numpy(out_v))
    assert got == want == CASES[kind][0]


@pytest.mark.parametrize("kind", list(CASES))
def test_window_oracle_checks_give_bench_py_verdicts(kind):
    keys, out_k, out_v, win_seed = _case(kind)
    want, want_detail = jbench.window_oracle_checks(
        jnp, jnp.asarray(out_k), jnp.asarray(out_v), keys, np.random.default_rng(win_seed))
    got, detail = tbench.window_oracle_checks(
        torch.from_numpy(out_k), torch.from_numpy(out_v), keys, np.random.default_rng(win_seed))
    assert (got, detail) == (want, want_detail)
    assert got == CASES[kind][1]


@pytest.mark.parametrize("kind", ["correct", "repair"])
def test_pairing_sum_is_bench_py_sum(kind):
    # bench.py's mix is the u32 step of the JAX package's timing._remix
    keys, out_k, out_v, _ = _case(kind)
    got = tbench.pairing_sum(torch.from_numpy(out_k), torch.from_numpy(out_v))
    x64 = jnp.sum((_remix(jnp.asarray(out_k)) * _remix(jnp.asarray(out_v))).astype(jnp.uint32))
    assert x64.dtype == jnp.uint64 and got == int(x64)
    with jax.enable_x64(False):
        x32 = jnp.sum((_remix(jnp.asarray(out_k)) * _remix(jnp.asarray(out_v)))
                      .astype(jnp.uint32))
        assert x32.dtype == jnp.uint32 and got % 2**32 == int(x32)
    want = tbench.pairing_sum(torch.from_numpy(keys), torch.arange(N, dtype=torch.int32)
                              .view(torch.uint32))
    assert (got == want) == (kind == "correct")


def _lines(capsys):
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1, out
    line = json.loads(out[0])
    assert set(KEYS) <= set(line)
    return line


def test_main_on_the_cpu_prints_one_json_line(capsys):
    assert tbench.main(["--device", "cpu", "--n", str(N)]) == 0
    line = _lines(capsys)
    assert set(line) == set(KEYS)
    assert line["value"] > 0 and line["unit"] == "M keys/s/chip"
    assert f"N={N}" in line["metric"] and "cpu" in line["metric"]
    assert "stable, validated" in line["metric"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / 52.7, abs=0.011)


def test_main_draws_bench_py_inputs_and_windows(monkeypatch, capsys):
    calls, starts = [], []
    sort_pairs, window_starts = vt.sort_pairs, tbench.window_starts

    def spy_sort(keys, values, **kw):
        calls.append(bits_view(keys).numpy().view(np.uint32).copy())
        return sort_pairs(keys, values, **kw)

    def spy_starts(*a, **kw):
        starts.append(window_starts(*a, **kw))
        return starts[-1]

    monkeypatch.setattr(vt, "sort_pairs", spy_sort)
    monkeypatch.setattr(tbench, "window_starts", spy_starts)
    assert tbench.main(["--device", "cpu", "--n", str(N)]) == 0
    _lines(capsys)
    small, keys_np, want_starts = _bench_draws(N)
    np.testing.assert_array_equal(calls[0], small)
    np.testing.assert_array_equal(calls[1], keys_np)
    assert starts == [want_starts]


def _swap(t, i, j):
    """A copy of ``t`` with elements i and j exchanged (torch indexes no
    unsigned tensor)."""
    b = bits_view(t).clone()
    b[[i, j]] = b[[j, i]]
    return b.view(t.dtype)


def _corrupt(kind, starts):
    """A sort_pairs that gives one call a faulty output: the 1e6 check's
    (``small``), the N sort's inside the first window (``window``) or
    outside every window (``order``), or the stable=False diagnostic's."""
    sort_pairs = vt.sort_pairs
    free = int(_outside(starts, N)[0])

    def bad(keys, values, stable=True, **kw):
        k, v = sort_pairs(keys, values, stable=stable, **kw)
        n = keys.numel()
        if kind == "small" and n == 1_000_000 or kind == "window" and n == N and stable:
            v = _swap(v, 0, 1)
        elif kind == "order" and n == N and stable:
            k, v = _swap(k, free, free + 1), _swap(v, free, free + 1)
        elif kind == "unstable" and not stable:
            v = _swap(v, free, free + 1000)
        return k, v

    return bad


@pytest.mark.parametrize("kind,error", [("small", "oracle mismatch"),
                                        ("window", "window-oracle validation FAILED"),
                                        ("order", "device-side validation failed"),
                                        ("unstable", "stable=False failed")])
def test_main_on_a_corrupted_sort_prints_the_failure_line(monkeypatch, capsys, kind, error):
    monkeypatch.setattr(vt, "sort_pairs", _corrupt(kind, _bench_draws(N)[2]))
    assert tbench.main(["--device", "cpu", "--n", str(N)]) == 1
    line = _lines(capsys)
    assert line["value"] == 0 and line["vs_baseline"] == 0 and "FAILED" in line["metric"]
    assert line["error"].startswith("AssertionError") and error in line["error"]


def test_main_without_a_card_prints_the_failure_line(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the probe succeeds")
    assert tbench.main([]) == 1
    line = _lines(capsys)
    assert line["value"] == 0 and line["error"].startswith("device-init")


@pytest.mark.parametrize("argv", [["--n", "1024"], ["--n", "x"]])
def test_main_refuses_a_bad_n(argv):
    with pytest.raises(SystemExit) as e:
        tbench.main(argv)
    assert e.value.code == 2


@pytest.mark.parametrize("payloads", [1, 2])
def test_measure_pairs_refuses_the_cpu(payloads):
    keys = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    vals = tuple(torch.zeros(8, dtype=torch.int32) for _ in range(payloads))
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_pairs_seconds_per_call(vt.sort_pairs, keys, vals if payloads > 1 else vals[0])


def test_bench_imports_no_jax():
    code = ("import sys, vkradixsort_tpu_torch.bench, vkradixsort_tpu_torch.utils.timing\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'vkradixsort_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
