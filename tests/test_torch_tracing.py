"""The port's spans and counters (utils/profiling.py) on the CPU.

With no profiler running, no span enters ``torch.profiler.record_function``.
Under one, each entry point, engine, radix step and library-sort step shows
as a ``vkrs/<layer>/<step>`` range, nested as the calls are. The counters
count each call's route, each kernel wrapper's launches and each kernel
build.
"""

import ast
import collections
import functools
import pathlib
import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vkradixsort_tpu_torch as vt
from vkradixsort_tpu_torch.ops import kernels, radix_tiled
from vkradixsort_tpu_torch.parallel.distributed import LocalMesh, sort_sharded
from vkradixsort_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

OPS = pathlib.Path(__file__).resolve().parents[1] / "vkradixsort_tpu_torch" / "ops"
N = 1000
WRAPPERS = ("tile_histograms", "tile_destinations", "tile_scatter", "digit_histograms",
            "onesweep_pass", "tilesort", "mergepath_level", "sort_fused", "block_pass",
            "global_group", "gather_payload", "place_runs", "gather_columns", "key_order",
            "digit_histograms_rows", "onesweep_rows_pass")


@pytest.fixture(autouse=True, scope="module")
def profiler_started_once():
    """The profiler's first start in a process takes about 2 s; pay it once
    here, not in the first case that profiles."""
    with profile(activities=[ProfilerActivity.CPU]):
        pass


def _keys(dtype=torch.uint32, n=N, seed=5):
    bits = 32 if dtype == torch.uint32 else 64
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**bits, size=n, dtype=np.uint64)
    return torch.from_numpy(k.astype(np.uint32) if bits == 32 else k).view(dtype)


def _spans(call):
    """``call()`` under the CPU profiler: its ``vkrs/`` ranges, in order of
    start, as (name, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("vkrs/")), key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


CALLS = {
    "sort": lambda: vt.sort(_keys()),
    "sort_2d": lambda: vt.sort(_keys().view(10, 100)),
    "sort_pairs_tiled": lambda: vt.sort_pairs(_keys(), (torch.arange(N), torch.arange(N))),
    "sort_pairs_radix": lambda: vt.sort_pairs(_keys(), torch.arange(N, dtype=torch.int32),
                                              backend="radix_tiled"),
    "argsort_tiled": lambda: vt.argsort(_keys(torch.uint64)),
    "argsort_radix": lambda: vt.argsort(_keys(), backend="radix_tiled"),
    "sort_segments": lambda: vt.sort_segments(_keys().view(10, 100), torch.arange(N).view(10, 100)),
    "sort_pairs_2d": lambda: vt.sort_pairs(_keys().view(10, 100),
                                           torch.arange(N, dtype=torch.int32).view(10, 100)),
    "argsort_2d": lambda: vt.argsort(_keys().view(10, 100)),
    "sort_sharded": lambda: sort_sharded(_keys(n=4 * 256), LocalMesh(["cpu"] * 4)),
}


@pytest.mark.parametrize("name", CALLS)
def test_no_range_without_a_profiler(name):
    entered = []

    class Counting:
        def __init__(self, span_name):
            entered.append(span_name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    with mock.patch.object(torch.profiler, "record_function", Counting):
        CALLS[name]()
    assert entered == []


def test_span_is_a_shared_no_op_off_and_a_range_on():
    assert profiling.span("vkrs/a") is profiling.span("vkrs/b")
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("vkrs/a")
    assert isinstance(on, torch.profiler.record_function)


@pytest.mark.parametrize("dtype,passes", [(torch.uint32, 4), (torch.uint64, 8)])
def test_radix_steps_nest_in_the_engine_and_the_call(dtype, passes):
    # the dispatcher's radix_tiled sort is the card's onesweep sort on every
    # device: one histogram step a call, one scatter step a pass, no scan
    spans = _spans(CALLS["sort_pairs_radix"] if dtype == torch.uint32 else
                   lambda: vt.sort_pairs(_keys(dtype), torch.arange(N, dtype=torch.int32),
                                         backend="radix_tiled"))
    names = collections.Counter(s[0] for s in spans)
    assert names == {"vkrs/sort_pairs": 1, "vkrs/engine/radix_tiled": 1,
                     "vkrs/radix/histogram": 1, "vkrs/radix/scatter": passes}
    call, engine = spans[0], spans[1]
    assert (call[0], engine[0]) == ("vkrs/sort_pairs", "vkrs/engine/radix_tiled")
    assert _inside(engine, call)
    steps = spans[2:]
    assert [s[0] for s in steps] == ["vkrs/radix/histogram"] + ["vkrs/radix/scatter"] * passes
    assert all(_inside(s, engine) for s in steps)


@pytest.mark.parametrize("dtype,passes", [(torch.uint32, 4), (torch.uint64, 8)])
def test_onesweep_sort_counts_once_and_moves_a_pass(dtype, passes):
    # the card's radix sort (here through its plain versions): one
    # histogram step a call, one scatter step a pass, no scan
    spans = _spans(lambda: radix_tiled.sort_onesweep(_keys(dtype),
                                                     torch.arange(N, dtype=torch.int32)))
    assert [s[0] for s in spans] == ["vkrs/radix/histogram"] + ["vkrs/radix/scatter"] * passes


@pytest.mark.parametrize("payloads", [2, 5])
def test_radix_tiled_payload_set_gathers_once(payloads):
    # a payload set rides as positions through the onesweep passes, then
    # one gather step moves every column
    vals = tuple(torch.arange(N, dtype=torch.int64) + i for i in range(payloads))
    spans = _spans(lambda: vt.sort_pairs(_keys(), vals, backend="radix_tiled"))
    names = [s[0] for s in spans]
    assert names.count("vkrs/radix/gather") == 1 and names[-1] == "vkrs/radix/gather"
    assert names.count("vkrs/radix/scatter") == 4
    assert _inside(spans[-1], spans[1])


@pytest.mark.parametrize("payloads", [0, 1, 3])
def test_tiled_route_sorts_once_and_gathers_each_payload(payloads):
    vals = tuple(torch.arange(N) + i for i in range(payloads))
    spans = _spans(lambda: vt.sort_pairs(_keys(), vals))
    names = [s[0] for s in spans]
    assert names == (["vkrs/sort_pairs", "vkrs/engine/tiled", "vkrs/tiled/sort"]
                     + ["vkrs/tiled/gather"] * payloads)
    assert all(_inside(s, spans[1]) for s in spans[2:])


@pytest.mark.parametrize("name,want", [
    ("argsort_tiled", ["vkrs/argsort", "vkrs/engine/tiled", "vkrs/tiled/sort"]),
    ("sort_2d", ["vkrs/sort", "vkrs/sort_segments", "vkrs/engine/tiled"]),
    ("sort_segments", ["vkrs/sort_segments", "vkrs/engine/tiled"]),
    ("argsort_2d", ["vkrs/argsort", "vkrs/engine/tiled"]),
    ("sort", ["vkrs/sort", "vkrs/engine/tiled", "vkrs/tiled/sort"]),
])
def test_entry_spans(name, want):
    assert [s[0] for s in _spans(CALLS[name])] == want


def test_distributed_steps_are_vkrs_spans():
    names = {s[0] for s in _spans(CALLS["sort_sharded"])}
    assert names and all(n.startswith("vkrs/sort_sharded/") for n in names)


@pytest.mark.parametrize("name,route", [
    ("sort", "tiled"), ("sort_pairs_tiled", "tiled"), ("sort_pairs_radix", "radix_tiled"),
    ("argsort_tiled", "tiled"), ("argsort_radix", "radix_tiled"),
])
@pytest.mark.parametrize("calls", [1, 3])
def test_route_counts_one_a_call(name, route, calls):
    before = profiling.counters()
    for _ in range(calls):
        CALLS[name]()
    moved = {k: v for k, v in profiling.since(before).items() if k.startswith("route.")}
    assert moved == {"route." + route: calls}


def test_segments_take_no_route():
    # 2-D keys take no route of the 1-D rows (keys, kv, argsort, ...): they
    # read the row table by width, and count its engine once a call (on CPU
    # tensors "tiled")
    before = profiling.counters()
    CALLS["sort_segments"]()
    moved = profiling.since(before)
    assert {k: v for k, v in moved.items() if k.startswith("route.")} == {"route.tiled": 1}
    assert not moved.get("radix.rows")


@pytest.mark.parametrize("name", ["sort_2d", "sort_segments", "sort_pairs_2d", "argsort_2d"])
@pytest.mark.parametrize("calls", [1, 3])
def test_2d_calls_count_their_route(name, calls):
    before = profiling.counters()
    for _ in range(calls):
        CALLS[name]()
    moved = {k: v for k, v in profiling.since(before).items() if k.startswith("route.")}
    assert moved == {"route.tiled": calls}


@pytest.mark.parametrize("name,passes,positions", [("sort_pairs_2d", 4, 0), ("argsort_2d", 4, 1),
                                                   ("sort_2d", 4, 0)])
def test_rows_radix_steps_nest_in_the_engine_and_the_call(monkeypatch, name, passes, positions):
    # a 2-D call the row table sends to radix_tiled (here through the plain
    # versions): route.radix_tiled and radix.rows once, the row histogram
    # step once and a scatter step a pass, inside vkrs/engine/radix_tiled
    from vkradixsort_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "_route_rows", lambda keys, vals=(): "radix_tiled")
    before = profiling.counters()
    spans = _spans(CALLS[name])
    moved = profiling.since(before)
    assert moved.get("route.radix_tiled") == 1 and moved.get("radix.rows") == 1
    assert moved.get("radix.positions_in_pass", 0) == positions
    names = [s[0] for s in spans]
    engine = names.index("vkrs/engine/radix_tiled")
    steps = spans[engine + 1:]
    assert [s[0] for s in steps] == ["vkrs/radix/histogram"] + ["vkrs/radix/scatter"] * passes
    assert all(_inside(s, spans[engine]) for s in steps)


@pytest.mark.parametrize("dtype,passes", [(torch.uint32, 4), (torch.uint64, 8)])
def test_sort_rows_counts_once_and_moves_a_pass(dtype, passes):
    before = profiling.counters()
    spans = _spans(lambda: radix_tiled.sort_rows(_keys(dtype).view(10, 100),
                                                 torch.arange(N, dtype=torch.int32).view(10, 100)))
    assert [s[0] for s in spans] == ["vkrs/radix/histogram"] + ["vkrs/radix/scatter"] * passes
    assert profiling.since(before) == {"radix.rows": 1}


def test_counters_snapshot_and_since():
    profiling.count("test.a")
    profiling.count("test.b", 2.5)
    snap = profiling.counters()
    profiling.count("test.a", 2)
    assert snap["test.a"] + 2 == profiling.counters()["test.a"]
    assert profiling.since(snap) == {"test.a": 2}
    snap["test.a"] = -1  # a snapshot is a copy
    assert profiling.COUNTERS["test.a"] != -1


def test_counts_from_many_threads_add_up():
    threads, each = 16, 2000
    before = profiling.counters()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [profiling.count("test.threads")
                                                    for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.since(before) == {"test.threads": threads * each}


@functools.cache
def _counted_launches() -> dict:
    """Each function of ops/ that launches a kernel (calls ``kernels.call``
    or ``kernels.launch``), with the ``launch.`` counters it adds."""
    out = {}
    for path in OPS.glob("*.py"):
        for fn in ast.walk(ast.parse(path.read_text())):
            if not isinstance(fn, ast.FunctionDef) or fn.name in ("call", "launch"):
                continue
            calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                     and isinstance(c.func, ast.Attribute) and isinstance(c.func.value, ast.Name)]
            if not any(c.func.value.id == "kernels" and c.func.attr in ("call", "launch")
                       for c in calls):
                continue
            out[fn.name] = [c.args[0].value for c in calls
                            if (c.func.value.id, c.func.attr) == ("profiling", "count")
                            and isinstance(c.args[0], ast.Constant)]
    return out


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_each_kernel_wrapper_counts_its_launches(wrapper):
    # on the card each launch adds one to launch.<wrapper>, the name the
    # bench twin's log prints (tests/test_torch_cuda.py reads them there)
    assert _counted_launches()[wrapper] == ["launch." + wrapper]


def test_every_launching_wrapper_is_counted():
    assert sorted(_counted_launches()) == sorted(WRAPPERS)


def test_build_counts_and_spans_only_when_nvcc_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_compile", lambda out: out.write_bytes(b""))
    before = profiling.counters()
    spans = _spans(kernels.build)
    assert [s[0] for s in spans] == ["vkrs/kernels/build"]
    assert _spans(kernels.build) == []  # the library exists: nothing to build
    assert profiling.since(before) == {"kernels.builds": 1}


def test_load_adds_its_seconds(monkeypatch):
    monkeypatch.setattr(kernels, "build", lambda: pathlib.Path("libvkrs_kernels_test.so"))
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: mock.MagicMock())
    before = profiling.counters()
    kernels.load.__wrapped__()
    moved = profiling.since(before)
    assert list(moved) == ["kernels.load_s"] and moved["kernels.load_s"] > 0
