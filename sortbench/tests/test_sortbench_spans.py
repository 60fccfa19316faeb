"""The reduction of a traced stretch by the program's spans
(``sortbench/spans.py``), on synthetic traces and on a small CPU run."""

import dataclasses
import importlib.util
import json
import pathlib

import pytest
from conftest import small_cell

from sortbench import harness, spans, trace

METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"
H100 = "NVIDIA H100 80GB HBM3"
PEAK = 3.35e12
U32 = {"key": {"dtype": "uint32"}, "columns": {"row_id": "uint32"}}
U64 = {"key": {"dtype": "uint64"}, "columns": {"row_id": "uint32"}}
PAIRS = {"payloads": ["row_id"]}


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def _span(name, ts, dur, device=None):
    """A host ``vkrs/`` range and, when ``device`` = (ts, dur) is given,
    its ``gpu_user_annotation`` twin on the stream."""
    out = [_x(name, "user_annotation", ts, dur)]
    if device is not None:
        out.append(_x(name, "gpu_user_annotation", *device, tid=7))
    return out


def _calls():
    """Two calls of a radix sort of one pass inside the stretch [0, 200]:
    the call (host 10-60, 110-160) holds the engine, which holds the
    histogram and the scatter steps; one copy runs in the call's own
    time, and one kernel runs under no span."""
    ev = [_x(trace.STRETCH, "user_annotation", 0.0, 200.0)]
    for base in (0.0, 100.0):
        ev += [_x(trace.CALL, "user_annotation", base + 8, 55.0)]
        ev += _span("vkrs/sort_pairs", base + 10, 50.0, device=(base + 20, 60.0))
        ev += _span("vkrs/engine/radix_tiled", base + 12, 40.0, device=(base + 20, 50.0))
        ev += _span("vkrs/radix/histogram", base + 14, 6.0, device=(base + 20, 10.0))
        ev += _span("vkrs/radix/scatter", base + 22, 20.0, device=(base + 35, 35.0))
        ev += [_x("histogram_kernel", "kernel", base + 20, 10.0, tid=7),
               _x("radix_pass_kernel", "kernel", base + 35, 35.0, tid=7),
               _x("Memcpy DtoD", "gpu_memcpy", base + 72, 6.0, tid=7),
               _x("cudaEventSynchronize", "cuda_runtime", base + 62, 30.0)]
    ev += [_x("stray_kernel", "kernel", 190.0, 4.0, tid=7)]
    return ev


def test_innermost_span_takes_the_device_time():
    got = spans.summarize(_calls())
    s = got["spans"]
    assert s["vkrs/radix/histogram"]["device_us"] == 20.0
    assert s["vkrs/radix/histogram"]["kernels"] == 2
    assert s["vkrs/radix/scatter"]["device_us"] == 70.0
    assert s["vkrs/engine/radix_tiled"]["device_us"] == 0.0  # its kernels are its steps'
    assert s["vkrs/sort_pairs"]["device_us"] == 12.0  # the copies after the engine
    assert s["vkrs/sort_pairs"]["kernels"] == 0
    assert s[spans.OUTSIDE] == {"count": 0, "host_us": 0.0, "self_us": 0.0, "device_us": 4.0,
                                "kernels": 1}


def test_span_totals_add_up_to_the_device_time():
    ev = _calls()
    got = spans.summarize(ev)
    summary = trace.summarize(ev, calls=2, rows=2000)
    assert sum(s["device_us"] for s in got["spans"].values()) == summary.device_op_us
    assert got["device_op_us"] == summary.device_op_us


def test_self_time_leaves_out_nested_spans():
    s = spans.summarize(_calls())["spans"]
    assert s["vkrs/sort_pairs"] == {**s["vkrs/sort_pairs"], "count": 2, "host_us": 100.0,
                                    "self_us": 20.0}
    assert s["vkrs/engine/radix_tiled"]["self_us"] == 2 * (40.0 - 6.0 - 20.0)
    assert s["vkrs/radix/scatter"]["self_us"] == s["vkrs/radix/scatter"]["host_us"] == 40.0


def test_idle_goes_to_the_innermost_span_of_the_host():
    # two calls, too few for a steady part: the whole stretch [0, 200];
    # busy 20-30, 35-70, 72-78, the same 100 later, and 190-194
    got = spans.summarize(_calls())
    assert got["idle_window_us"] == 200.0
    idle = got["idle_us"]
    # gap 0-20: the host in sort_pairs 10-12, engine 12-14, histogram 14-20
    # (and 110-120 in the second call); 30-35 in the scatter step (22-42)
    assert idle["vkrs/sort_pairs"] == 4.0
    assert idle["vkrs/engine/radix_tiled"] == 4.0
    assert idle["vkrs/radix/histogram"] == 12.0
    assert idle["vkrs/radix/scatter"] == 10.0
    assert sum(idle.values()) == pytest.approx(200.0 - 106.0)
    assert idle[spans.OUTSIDE_PROGRAM] == pytest.approx(10 + 2 + 32 + 2 + 12 + 6)


def test_spans_leave_every_summary_field_and_reader_as_they_were():
    with_spans = _calls()
    without = [e for e in with_spans if not str(e["name"]).startswith(spans.PREFIX)]
    a = trace.summarize(with_spans, calls=2, rows=2000)
    b = trace.summarize(without, calls=2, rows=2000)
    for f in dataclasses.fields(trace.Summary):
        if f.name != "idle_gaps":
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    # the gaps are the same; what the host did in them may now be a span
    assert [g[1] for g in a.idle_gaps] == [g[1] for g in b.idle_gaps]
    for path in METRICS.glob("*.py"):
        spec = importlib.util.spec_from_file_location(f"m_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        runs = [harness.Run(U32, PAIRS, H100, {H100: {"hbm_bytes_per_s": PEAK}}, 6.0, 10.0,
                            2000, [1.0, 2.0], [1e-4], 100, s) for s in (a, b)]
        assert mod.read(runs[0]) == mod.read(runs[1]), path.name


def _program(**named):
    base = {"count": 0, "host_us": 0.0, "self_us": 0.0, "device_us": 0.0, "kernels": 0}
    return {"spans": {k: {**base, **v} for k, v in named.items()},
            "idle_us": {"vkrs/tiled/sort": 30.0, spans.OUTSIDE_PROGRAM: 10.0},
            "device_op_us": 0.0, "idle_window_us": 200.0}


@pytest.mark.parametrize("config,passes,row,key", [(U32, 4, 8, 4), (U64, 8, 12, 8)])
def test_step_rooflines(config, passes, row, key):
    calls, rows = 10, 10 * 10**8
    scatter_us, hist_us = 10 * 3750.0, 10 * 765.0
    prog = _program(**{"vkrs/radix/scatter": {"count": passes * calls, "device_us": scatter_us},
                       "vkrs/radix/histogram": {"count": passes * calls, "device_us": hist_us}})
    got = spans.metrics(prog, calls, rows, config, PAIRS, PEAK)
    least_scatter = 2 * row * rows * passes / PEAK
    least_hist = key * rows * passes / PEAK
    assert got["kernels.scatter_roofline"] == pytest.approx(100 * least_scatter / 37.5e-3)
    assert got["kernels.histogram_roofline"] == pytest.approx(100 * least_hist / 7.65e-3)


def test_u32_scatter_roofline_reads_about_half():
    # 3.76 ms of rank-and-scatter a 1e8 u32 kv call on the H100 (PERF.md section 5)
    prog = _program(**{"vkrs/radix/scatter": {"count": 4, "device_us": 3760.0}})
    got = spans.metrics(prog, 1, 10**8, U32, PAIRS, PEAK)["kernels.scatter_roofline"]
    assert 50 < got < 52


def test_scan_self_and_idle_in_program():
    prog = _program(**{"vkrs/radix/scan": {"count": 8, "device_us": 320.0},
                       "vkrs/sort_pairs": {"count": 2, "self_us": 60.0}})
    got = spans.metrics(prog, 2, 2000, U32, PAIRS, PEAK)
    assert got["driver.scan_ms"] == pytest.approx(0.16)
    assert got["dispatch.self_ms"] == pytest.approx(0.03)
    assert got["device.idle_in_program_share"] == pytest.approx(15.0)


def test_no_span_no_metric():
    empty = _program()
    assert spans.metrics(empty, 2, 2000, U32, PAIRS, PEAK) == {}
    # the library route: no radix step, so no roofline or scan, and no
    # fallback to kernel names
    tiled = _program(**{"vkrs/sort_pairs": {"count": 2, "self_us": 10.0},
                        "vkrs/tiled/sort": {"count": 2, "device_us": 50.0}})
    assert set(spans.metrics(tiled, 2, 2000, U32, PAIRS, PEAK)) == {
        "dispatch.self_ms", "device.idle_in_program_share"}


def test_needs_the_stretch():
    with pytest.raises(ValueError):
        spans.summarize([_x("vkrs/sort", "user_annotation", 0.0, 1.0)])


def test_small_run_on_the_cpu():
    cell = small_cell("u32-pairs-small", 1 << 21, rows={"sizes": [1 << 16], "each": 4},
                      trace_calls=6)
    r = spans.run(cell, 2**31 + 77, 6, "cpu")
    json.dumps(r)
    s = r["program"]["spans"]
    assert {k: v["count"] for k, v in s.items()} == {
        "vkrs/sort_pairs": 6, "vkrs/engine/tiled": 6, "vkrs/tiled/sort": 6,
        "vkrs/tiled/gather": 6}
    assert r["program"]["counters_per_call"] == {"route.tiled": 1.0}
    assert r["metrics"]["dispatch.self_ms"] > 0
    assert r["issue_us"]["untraced"] > 0 and r["issue_us"]["traced"] > 0
