"""The program's own spans and counters in one run of a cell.

The port names its steps: ``vkrs/<layer>/<step>`` ranges on the
profiler's timeline (``vkradixsort_tpu_torch.utils.profiling.span``) and
counters that are always on (``profiling.counters()``). :func:`summarize`
reduces a traced stretch by those spans, beside what ``trace.summarize``
reads of the same events:

* per span name: how many, host us, self host us (less the ``vkrs/``
  spans nested in it), and the device us and kernels of the device
  operations whose innermost ``vkrs/`` range it is (the trace's
  ``gpu_user_annotation`` events, which also hold the kernels launched
  through ctypes); operations under none go under ``(outside)``, so the
  spans' device us and ``(outside)``'s add up to ``device_op_us``;
* idle device time of the steady part by the innermost ``vkrs/`` span the
  host was in, else ``(outside program)``.

:func:`metrics` turns that into the per-layer numbers it exists for: the
rank-and-scatter and histogram steps' shares of their rooflines, the
scan's device ms, the entry point's self host ms and the share of the
steady part in which the card idles while the host is inside the program.

Run from the root of a checkout (one JSON line on stdout):

    python3 -m sortbench.spans --workload <cell> --seed <n> [--calls <c>]

It makes the cell's inputs as ``run.py`` does, warms up, runs ``--calls``
calls untraced and then the same number traced (default: the traffic's
``trace_calls``), and prints ``program`` (spans, idle by span, counters a
call, set-up counters), ``metrics``, the host's median issue time a call
untraced and traced, and the trace's ``breakdown``. Nothing here is run by
``run.py``. On a program without spans or counters each part reads empty.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile

PREFIX = "vkrs/"
OUTSIDE = "(outside)"
OUTSIDE_PROGRAM = "(outside program)"
ENTRY = "vkrs/sort_pairs"


def _nest(spans: list) -> list:
    """``(name, start, end, self)`` of properly nested ``(name, start,
    end)`` host spans of one thread, where ``self`` is the ``(start,
    end)`` pieces of the span that no span nested in it covers."""
    order = sorted(spans, key=lambda s: (s[1], -(s[2] - s[1])))
    out, stack = [], []  # stack: indices into out of the open spans
    for name, a, b in order:
        while stack and out[stack[-1]][2] <= a:
            stack.pop()
        if stack:
            parent = out[stack[-1]]
            # cut [a, b] out of the parent's last self piece, which holds it
            pa, pb = parent[3][-1]
            parent[3][-1:] = [p for p in ((pa, a), (b, pb)) if p[1] > p[0]]
        out.append((name, a, b, [(a, b)]))
        stack.append(len(out) - 1)
    return out


def _pieces(nested: list) -> list:
    """The self pieces of :func:`_nest`'s spans, ``(start, end, name)`` in
    order of time: where each span is the innermost."""
    return sorted((p, q, name) for name, _, _, pieces in nested for p, q in pieces)


def _innermost(intervals: list):
    """A lookup from a time to the name of the innermost of the properly
    nested ``(name, start, end)`` intervals that holds it, or None."""
    pieces = _pieces(_nest(intervals))
    starts = [p for p, _, _ in pieces]

    def find(t: float):
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if i >= 0 and t <= pieces[i][1] else None

    return find


def summarize(events: list, in_flight: int = 2) -> dict:
    """The ``vkrs/`` spans of the traced stretch in Chrome-trace ``events``
    (``trace.load``): ``{"spans": {name: {count, host_us, self_us,
    device_us, kernels}}, "idle_us": {name: us}, "device_op_us": float,
    "idle_window_us": float}``. The stretch and its steady part are those
    of ``trace.summarize``; the host spans are the stretch's thread's."""
    from sortbench import trace

    xs = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in xs if e.get("name") == trace.STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise ValueError(f"the trace has no {trace.STRETCH!r} range")
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    tid = stretch[0].get("tid")
    a, b = trace.steady_part(xs, lo, hi, in_flight)

    def interval(e):
        s = float(e["ts"])
        return s, s + float(e.get("dur", 0))

    host = [(e["name"], *interval(e)) for e in xs if e.get("cat") == "user_annotation"
            and e.get("tid") == tid and str(e.get("name")).startswith(PREFIX)]
    gpu = [(e["name"], *interval(e)) for e in xs if e.get("cat") == "gpu_user_annotation"
           and str(e.get("name")).startswith(PREFIX)]
    spans = {}

    def entry(name):
        return spans.setdefault(name, {"count": 0, "host_us": 0.0, "self_us": 0.0,
                                       "device_us": 0.0, "kernels": 0})

    nested = _nest([s for s in host if lo <= s[1] <= hi])
    for name, s, t, pieces in nested:
        e = entry(name)
        e["count"] += 1
        e["host_us"] += t - s
        e["self_us"] += sum(q - p for p, q in pieces)
    owner = _innermost(gpu)
    device, total = [], 0.0
    for e in xs:
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        s, t = interval(e)
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        d = entry(owner((s + t) / 2) or OUTSIDE)
        d["device_us"] += t - s
        d["kernels"] += e["cat"] == "kernel"
        total += t - s
        device.append((max(s, a), min(t, b)))
    busy = trace.union([(s, t) for s, t in device if t > s])
    idle, selfs, j = {}, _pieces(nested), 0
    for g0, g1 in trace.gaps(busy, a, b):  # in order of time, as the pieces
        while j < len(selfs) and selfs[j][1] <= g0:
            j += 1
        inside = 0.0
        for p, q, name in selfs[j:]:
            if p >= g1:
                break
            ov = min(q, g1) - max(p, g0)
            idle[name] = idle.get(name, 0.0) + ov
            inside += ov
        idle[OUTSIDE_PROGRAM] = idle.get(OUTSIDE_PROGRAM, 0.0) + (g1 - g0) - inside
    return {"spans": spans, "idle_us": idle, "device_op_us": total, "idle_window_us": b - a}


WIDTH = {"uint32": 4, "int32": 4, "float32": 4, "uint64": 8, "int64": 8, "float64": 8}


def metrics(program: dict, calls: int, rows: int, config: dict, traffic: dict,
            peak_bytes_per_s: float | None) -> dict:
    """The per-layer numbers the spans give, each left out where its span
    is absent: ``kernels.scatter_roofline`` and
    ``kernels.histogram_roofline`` (% of the least traffic of their steps
    at the card's peak: a pass reads and writes each row once in
    rank-and-scatter and reads each key once in the histogram),
    ``driver.scan_ms`` (device ms a call under ``vkrs/radix/scan``),
    ``dispatch.self_ms`` (self host ms a call of ``vkrs/sort_pairs``) and
    ``device.idle_in_program_share`` (% of the steady part in which the
    card idles while the host is inside a ``vkrs/`` span)."""
    spans, out = program["spans"], {}
    key = WIDTH[config["key"]["dtype"]]
    row = key + sum(WIDTH[config["columns"][p]] for p in traffic["payloads"])
    for name, width, moved in (("scatter", row, 2), ("histogram", key, 1)):
        s = spans.get(f"vkrs/radix/{name}")
        if s and s["device_us"] > 0 and peak_bytes_per_s and calls:
            least_s = moved * width * rows * (s["count"] / calls) / peak_bytes_per_s
            out[f"kernels.{name}_roofline"] = 100.0 * least_s / (s["device_us"] * 1e-6)
    if "vkrs/radix/scan" in spans and calls:
        out["driver.scan_ms"] = spans["vkrs/radix/scan"]["device_us"] / calls / 1e3
    if ENTRY in spans and calls:
        out["dispatch.self_ms"] = spans[ENTRY]["self_us"] / calls / 1e3
    if spans and program["idle_window_us"] > 0:
        inside = sum(us for name, us in program["idle_us"].items() if name != OUTSIDE_PROGRAM)
        out["device.idle_in_program_share"] = 100.0 * inside / program["idle_window_us"]
    return out


def _counters():
    """The program's counters, or {} where it keeps none."""
    try:
        from vkradixsort_tpu_torch.utils import profiling
        return profiling.counters()
    except (ImportError, AttributeError):
        return {}


def _moved(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def run(cell, seed: int, calls: int | None, device="cuda:0") -> dict:
    """Set-up, ``calls`` untraced calls, then as many traced, in the cell
    ``cell`` (``harness.find_cell``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from sortbench import generator, harness, inputs, trace

    device = torch.device(device)
    traffic = cell.traffic
    sort_fn = harness.load_call(traffic["call"]).program()
    c0 = _counters()
    table = inputs.make_table(cell.config, traffic, device, seed)
    plan = generator.plan(traffic, table.rows, seed)
    args = [(table.keys[c.key_set][c.offset:c.offset + c.rows],
             tuple(table.columns[p][c.offset:c.offset + c.rows] for p in traffic["payloads"]))
            for c in plan]
    in_flight = int(traffic.get("in_flight", 2))
    calls = int(calls or traffic["trace_calls"])
    warm = harness.closed_loop(sort_fn, args, plan, device, in_flight,
                               calls=max(len(plan), in_flight + 1))
    setup = _moved(c0, _counters())
    c1 = _counters()
    untraced = harness.closed_loop(sort_fn, args, plan, device, in_flight,
                                   first=warm.next_call, calls=calls)
    per_call = {k: v / untraced.calls for k, v in _moved(c1, _counters()).items()}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(trace.STRETCH):
            traced = harness.closed_loop(sort_fn, args, plan, device, in_flight,
                                         first=untraced.next_call, calls=calls,
                                         call_range=lambda: record_function(trace.CALL))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        events = trace.load(path)
    summary = trace.summarize(events, traced.calls, traced.rows, in_flight)
    program = summarize(events, in_flight)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    peaks = json.loads((harness.HERE / "peaks.json").read_text())
    peak = peaks.get(kind, {}).get("hbm_bytes_per_s")
    return {
        "workload": cell.name, "seed": seed, "device": kind, "calls": traced.calls,
        "program": {**program, "counters_per_call": per_call, "setup_counters": setup},
        "metrics": metrics(program, traced.calls, traced.rows, cell.config, traffic, peak),
        "issue_us": {"untraced": statistics.median(untraced.issue_s) * 1e6,
                     "traced": statistics.median(traced.issue_s) * 1e6},
        "breakdown": {"device_op_us": summary.device_op_us, "kernels": summary.kernels,
                      "window_us": summary.window_us, "busy_us": summary.busy_us,
                      "device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m sortbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=None)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("[sortbench.spans] needs a CUDA device: no result", file=sys.stderr)
        return 2
    from sortbench import harness

    cell = harness.find_cell(args.workload)
    print(json.dumps(run(cell, args.seed, args.calls, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
