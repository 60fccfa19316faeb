"""The reduction of a profiled stretch to what the per-layer metrics read.

``torch.profiler`` traces the stretch (host operations and the card's
kernels, copies and memsets, on one timeline) and exports it as a Chrome
trace; :func:`summarize` reads that file's events. The stretch is the
benchmark's own ``record_function`` range ``STRETCH``, from its first
issue to its closing synchronize, and each call's issue is a range
``CALL`` inside it.

Counts and summed device time cover every call of the stretch. Busy and
idle time are read over its steady part, from the issue of the call after
the first ``in_flight`` to the issue of the last call: at the stretch's
edges the card waits for its first launch and the host for its last
answer, which a window of many seconds does not see.
"""

from __future__ import annotations

import dataclasses
import json

STRETCH = "sortbench.stretch"
CALL = "sortbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10  # entries in each list of the breakdown
NAME_CHARS = 160


@dataclasses.dataclass
class Summary:
    calls: int
    rows: int
    window_us: float  # the steady part's wall length
    busy_us: float  # union of device intervals inside the steady part
    device_op_us: float  # summed device-operation time of the stretch
    kernels: int  # kernels of the stretch
    device_ops: list  # [name, seconds], most time first
    idle_gaps: list  # [what the host was doing, seconds], longest first


def union(intervals) -> list:
    """Merged, sorted ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy: list, start: float, end: float) -> list:
    """The ``(start, end)`` stretches of ``[start, end]`` that no merged
    interval of ``busy`` covers."""
    out, t = [], start
    for a, b in busy:
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def host_activity(gap, host) -> str:
    """The host event that overlaps the gap most (the innermost of equals)."""
    a, b = gap
    best, key = "idle", (0.0, 0.0)
    for name, s, e in host:
        ov = min(b, e) - max(a, s)
        if ov > 0 and (ov, -(e - s)) > key:
            best, key = name, (ov, -(e - s))
    return best


def _clip(s, e, lo, hi):
    return max(s, lo), min(e, hi)


def steady_part(spans: list, lo: float, hi: float, in_flight: int) -> tuple:
    """``(start, end)`` of the stretch's steady part, by its call ranges;
    the whole stretch when it has too few calls."""
    starts = sorted(float(e["ts"]) for e in spans
                    if e.get("name") == CALL and e.get("cat") == "user_annotation")
    if len(starts) < in_flight + 2:
        return lo, hi
    return starts[in_flight], starts[-1]


def summarize(events: list, calls: int, rows: int, in_flight: int = 2) -> Summary:
    """Reduce Chrome-trace events (``traceEvents``) of one stretch."""
    spans = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in spans if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if not stretch:
        raise ValueError(f"the trace has no {STRETCH!r} range")
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    a, b = steady_part(spans, lo, hi, in_flight)
    device, steady, by_name, kernels = [], [], {}, 0
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = _clip(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), lo, hi)
        if t <= s:
            continue
        device.append((s, t))
        name = str(e.get("name"))[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        kernels += e["cat"] == "kernel"
        s, t = _clip(s, t, a, b)
        if t > s:
            steady.append((s, t))
    busy = union(steady)
    host = [(str(e.get("name"))[:NAME_CHARS], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in spans if e.get("cat") in HOST_CATS and e.get("name") not in (STRETCH, CALL)]
    idle = sorted(gaps(busy, a, b), key=lambda g: g[1] - g[0], reverse=True)[:TOP]
    return Summary(
        calls=calls,
        rows=rows,
        window_us=b - a,
        busy_us=sum(t - s for s, t in busy),
        device_op_us=sum(t - s for s, t in device),
        kernels=kernels,
        device_ops=[[n, us * 1e-6] for n, us in
                    sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]],
        idle_gaps=[[host_activity(g, host), (g[1] - g[0]) * 1e-6] for g in idle],
    )


def load(path) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]
