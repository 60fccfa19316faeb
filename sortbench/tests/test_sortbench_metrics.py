"""The metric readers and the trace reduction, on synthetic numbers."""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from sortbench import harness, trace

METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"
H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_run(**kw):
    base = dict(config={"key": {"dtype": "uint32"}, "columns": {"row_id": "uint32"}},
                traffic={"payloads": ["row_id"]}, device_kind=H100,
                peaks=json.loads((METRICS.parent / "peaks.json").read_text()), setup_s=6.5,
                window_s=10.0, rows=2_000_000_000, call_ms=[1.0, 2.0, 3.0, 4.0, 100.0],
                issue_s=[1e-4, 3e-4, 2e-4], window_peak_bytes=4_400_000_000, trace=None)
    base.update(kw)
    return harness.Run(**base)


def summary(**kw):
    base = dict(calls=10, rows=1_000_000_000, window_us=50_000.0, busy_us=49_000.0,
                device_op_us=47_760.0, kernels=280, device_ops=[], idle_gaps=[])
    base.update(kw)
    return trace.Summary(**base)


def test_rate_over_whole_window():
    assert reader("rows_per_s")(make_run()) == pytest.approx(200.0)  # 2e9 rows / 10 s, in M


def test_p95_over_all_calls():
    ms = list(np.random.default_rng(1).exponential(3.0, 1001))
    got = reader("call_ms_p95")(make_run(call_ms=ms))
    assert got == pytest.approx(np.percentile(ms, 95))
    assert reader("call_ms_p95")(make_run(call_ms=[1.0])) is None


def test_peak_setup_issue():
    run = make_run()
    assert reader("peak_mem_gb")(run) == pytest.approx(4.4)
    assert reader("setup_s")(run) == 6.5
    assert reader("dispatch.issue_ms")(run) == pytest.approx(0.2)


@pytest.mark.parametrize("key,payloads,row_bytes", [
    ("uint32", ["row_id"], 8),
    ("uint64", ["row_id"], 12),
    ("uint32", ["row_id", "value", "attr"], 16),
])
def test_roofline_byte_counts(key, payloads, row_bytes):
    cols = {"row_id": "uint32", "value": "float32", "attr": "int32"}
    config = {"key": {"dtype": key}, "columns": cols}
    traffic = {"payloads": payloads}
    read = reader("kernels.sort_roofline")
    # 1e9 rows moved once each way at 3.35 TB/s, over 47.76 ms of device time
    run = make_run(config=config, traffic=traffic, trace=summary())
    least = 2 * 1e9 * row_bytes / 3.35e12
    assert read(run) == pytest.approx(100 * least / 0.04776)
    assert read(make_run(trace=summary(), device_kind="some other card")) is None
    assert read(make_run(trace=summary(device_op_us=0.0))) is None


def test_u32_pairs_roofline_reads_about_ten_percent():
    """The 1e8 u32 kv sort at 4.72 ms a call (PERF.md section 5) is 10.1%."""
    run = make_run(trace=summary(calls=1, rows=100_000_000, device_op_us=4720.0))
    assert reader("kernels.sort_roofline")(run) == pytest.approx(10.12, abs=0.01)


def test_kernels_per_call_and_idle_share():
    run = make_run(trace=summary())
    assert reader("driver.kernels_per_call")(run) == 28.0
    assert reader("device.idle_share")(run) == pytest.approx(2.0)
    for name in ("driver.kernels_per_call", "device.idle_share", "kernels.sort_roofline"):
        assert reader(name)(make_run()) is None  # untraced: nothing to read
    assert reader("device.idle_share")(make_run(trace=summary(busy_us=0.0))) is None


def test_union_and_gaps():
    merged = trace.union([(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)])
    assert merged == [[0, 3], [5, 9], [12, 13]]
    assert trace.gaps(merged, -1, 15) == [(-1, 0), (3, 5), (9, 12), (13, 15)]
    assert trace.gaps(merged, 0, 9) == [(3, 5)]


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_synthetic_trace():
    events = [
        _x(trace.STRETCH, "user_annotation", 100.0, 100.0),
        _x("aten::sort", "cpu_op", 100.0, 30.0),
        _x("cudaLaunchKernel", "cuda_runtime", 105.0, 5.0),
        _x("cudaEventSynchronize", "cuda_runtime", 150.0, 40.0),
        _x("radix_scatter", "kernel", 90.0, 30.0),  # starts before the stretch: clipped to 20
        _x("radix_scatter", "kernel", 115.0, 10.0),  # overlaps the first: union
        _x("histogram", "kernel", 140.0, 20.0),
        _x("Memset (Device)", "gpu_memset", 170.0, 5.0),
        _x("late", "kernel", 210.0, 5.0),  # after the stretch: left out
        {"ph": "i", "name": "marker", "ts": 120.0},
    ]
    s = trace.summarize(events, calls=2, rows=2000)
    assert s.window_us == 100.0
    assert s.busy_us == 25.0 + 20.0 + 5.0
    assert s.device_op_us == 20.0 + 10.0 + 20.0 + 5.0
    assert s.kernels == 3
    assert s.device_ops[0] == ["radix_scatter", pytest.approx(30e-6)]
    # gaps: 125-140 (the host in aten::sort until 130: 5 us; then nothing
    # else; sync from 150), 160-170 (sync), 175-200 (sync)
    assert [round(g[1] * 1e6, 6) for g in s.idle_gaps] == [25.0, 15.0, 10.0]
    assert [g[0] for g in s.idle_gaps] == ["cudaEventSynchronize", "aten::sort",
                                           "cudaEventSynchronize"]


def test_summarize_needs_the_stretch():
    with pytest.raises(ValueError):
        trace.summarize([_x("k", "kernel", 0.0, 1.0)], 1, 1)


def test_run_fields_are_what_readers_read():
    names = {f.name for f in dataclasses.fields(harness.Run)}
    for path in METRICS.glob("*.py"):
        src = path.read_text()
        for word in ("run.trace", "run.rows", "run.call_ms", "run.issue_s", "run.setup_s",
                     "run.window_s", "run.window_peak_bytes", "run.peaks", "run.device_kind",
                     "run.config", "run.traffic"):
            if word in src:
                assert word.split(".")[1] in names, (path.name, word)


def test_steady_part_leaves_out_the_edges():
    """Busy and idle time are read between the third call's issue and the
    last call's; counts and device time cover the whole stretch."""
    events = [_x(trace.STRETCH, "user_annotation", 0.0, 100.0)]
    events += [_x(trace.CALL, "user_annotation", t, 1.0) for t in (0.0, 10.0, 20.0, 80.0)]
    events += [_x("k", "kernel", 5.0, 10.0), _x("k", "kernel", 30.0, 40.0),
               _x("k", "kernel", 75.0, 20.0)]
    s = trace.summarize(events, calls=4, rows=400, in_flight=2)
    assert s.window_us == 60.0  # 20 to 80
    assert s.busy_us == 40.0 + 5.0  # 30-70, 75-80
    assert s.device_op_us == 70.0 and s.kernels == 3
    assert [round(g[1] * 1e6, 6) for g in s.idle_gaps] == [10.0, 5.0]


@pytest.mark.parametrize("name", ["rows_per_s", "call_ms_p95", "dispatch.issue_ms",
                                  "driver.kernels_per_call", "device.idle_share"])
def test_part_metrics_read_as_their_twins(name):
    """``part.<metric>`` is the same reading, split for the host-paced cells."""
    for run in (make_run(), make_run(trace=summary())):
        assert reader(f"part.{name}")(run) == reader(name)(run)


def test_answer_bytes_counts_each_storage_once():
    keys = torch.empty(128, dtype=torch.int32)  # 512 B
    vals = torch.empty(300, dtype=torch.int32)  # 1200 B, held as 1536
    assert harness.answer_bytes((keys, (vals,))) == 512 + 1536
    both = torch.empty(256, dtype=torch.int32)
    assert harness.answer_bytes((both[:128], (both[128:],))) == 1024


def test_peak_memory_leaves_out_kept_answers(monkeypatch):
    """The peak of a stretch is read less the answers held in it: a call's
    own answer counts while the call is issued, a kept one not after."""
    mem = {"now": 0, "peak": 0}

    def alloc(n):
        mem["now"] += n
        mem["peak"] = max(mem["peak"], mem["now"])

    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: mem["peak"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda device=None: mem.update(peak=mem["now"]))
    answer = (torch.empty(128, dtype=torch.int32), (torch.empty(128, dtype=torch.int32),))
    m = harness.PeakMemory(torch.device("cpu"))
    m.cuda = True
    alloc(10_000)  # the inputs
    m.start()
    alloc(1024 + 2000)  # a call: its answer and its scratch
    alloc(-2000)
    m.hold(answer)  # its answer is kept
    for _ in range(3):  # later calls, their answers freed
        alloc(1024 + 2000)
        alloc(-3024)
    m.close()
    assert m.held == 1024
    assert m.own == 10_000 + 1024 + 2000
    assert m.whole == 10_000 + 1024 + 1024 + 2000
