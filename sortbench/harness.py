"""One run of one cell: set-up, the window, the traced stretch, the check.

A cell is found by its name in ``BENCHMARK.json``: its configuration file
(whose key law other than ``uniform`` or ``zipf`` is the file
``sortbench/keys/<distribution>.py``, see :mod:`sortbench.inputs`), its
traffic file ``sortbench/traffic/<traffic>.json``, the traffic's call
``sortbench/calls/<call>.py`` and, for every metric it reports, the reader
``sortbench/metrics/<metric>.py`` (``read(run)``, which returns a number or
None). A call file gives ``program()``, the port's public call as
``fn(keys, payloads) -> (first column, tuple of further columns)``, and
``reference(keys, payloads, reverse_ties=False)``, the plain answer in the
same shape, which imports nothing of the port; ``reverse_ties=True`` is the
call's control. A later cell, mix, call, key law or metric is new files and
new entries; nothing here names one.

The window is a closed loop with one caller: before it issues call i+1 the
host waits for call i-1 (``in_flight`` 2), CUDA events on the stream time
each call, and every input comes from the pool that set-up made and warmed
up. At moments drawn from the seed the loop keeps the answer of the next
call of a plan entry chosen for that moment (``generator.samples``); once
the window has closed and its peak memory has been read, the reference
of the cell's call works the same inputs out again and every kept answer
is compared with it, row by row. The window's peak memory is read without
the answers kept for the check (:class:`PeakMemory`): it is what the sort
holds beside its inputs.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

from sortbench import generator, inputs, reference, trace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vkradixsort_tpu"})


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries of the metrics this cell reports
    per_layer: list
    metrics_dir: pathlib.Path


def find_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "sortbench" / "traffic" / f"{w['traffic']}.json").read_text())

    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    # a per-layer metric without a list of cells goes where its end-to-end metric goes
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                root / "sortbench" / "metrics")


def _load(path: pathlib.Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metrics_dir: pathlib.Path, name: str):
    """The ``read`` function of ``metrics_dir/<name>.py``."""
    return _load(metrics_dir / f"{name}.py", f"sortbench_metric.{name}").read


def load_call(name: str):
    """The call file ``sortbench/calls/<name>.py``, beside the harness: its
    ``program()`` and ``reference(keys, payloads, reverse_ties=False)``."""
    return _load(HERE / "calls" / f"{name}.py", f"sortbench_call.{name}")


def read_metrics(cell: Cell, entries: list, run) -> dict:
    """Each metric's reader on ``run``; a reader that returns None is left out."""
    out = {}
    for m in entries:
        value = load_reader(cell.metrics_dir, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def program_sort():
    """The port's public ``sort_pairs`` on its default route, on ``(keys,
    payload tuple)``: the program of the call ``sort_pairs``."""
    return load_call("sort_pairs").program()


def control(call):
    """The control of a call: its reference in the program's place, with
    rows of equal keys in reverse input order."""
    return functools.partial(call.reference, reverse_ties=True)


class HostEvent:
    """A CUDA event's interface on the host clock, for runs on the CPU."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device):
    return torch.cuda.Event(enable_timing=True) if device.type == "cuda" else HostEvent()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def answer_bytes(out) -> int:
    """The device memory an answer ``(first column, tuple of further
    columns)`` of a call holds: each storage once, rounded up to the caching
    allocator's 512-byte blocks."""
    first, rest = out
    storages = {}
    for t in (first, *rest):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    return sum(-(-n // 512) * 512 for n in storages.values())


class PeakMemory:
    """The allocator's peak over the window, with and without the answers
    kept for the check. Each kept answer would have been freed once its
    call was issued; from there on the peak is read less the bytes of the
    answers held, in stretches that start with
    ``reset_peak_memory_stats()`` (one per kept answer). ``whole`` and
    ``own`` stay 0 off the card."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.held = self.whole = self.own = 0

    def start(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def close(self):
        """Ends a stretch: takes in its peak and starts the next."""
        if self.cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.whole = max(self.whole, peak)
            self.own = max(self.own, peak - self.held)
            torch.cuda.reset_peak_memory_stats(self.device)

    def hold(self, out):
        """``out`` outlives its call from here on."""
        self.close()
        self.held += answer_bytes(out)


@dataclasses.dataclass
class Window:
    seconds: float
    calls: int
    rows: int
    call_ms: list
    issue_s: list
    kept: list  # (plan index, answer)
    next_call: int


def closed_loop(sort_fn, args, plan, device, in_flight: int, *, first: int = 0,
                seconds: float | None = None, calls: int | None = None,
                keep_at=(), call_range=None, memory: PeakMemory | None = None) -> Window:
    """Issue plan calls from ``first`` on until ``seconds`` have passed or
    ``calls`` were issued, at most ``in_flight`` on the device at once, then
    synchronize. For each ``(time, plan index)`` of ``keep_at`` (in order
    of time), the answer of the first call of that plan entry issued at or
    after that many seconds into the loop is kept (issued after the close,
    untimed, where the loop ends first). ``call_range()``, when
    given, is entered around each call's issue; ``memory``, when given, is
    told of each answer kept. The garbage collector is
    off inside the loop, so none of its pauses lands in a call."""
    ring = [(_event(device), _event(device)) for _ in range(in_flight + 1)]
    pending = collections.deque()
    call_ms, issue_s, kept = [], [], []
    waiting = collections.Counter()  # plan index -> answers due
    due = 0
    rows, i = 0, first
    gc_on = gc.isenabled()
    gc.disable()
    try:
        _sync(device)
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            if ((seconds is not None and now >= seconds)
                    or (calls is not None and i - first >= calls)):
                break
            if len(pending) == in_flight:
                s, e = pending.popleft()
                e.synchronize()
                call_ms.append(s.elapsed_time(e))
            while due < len(keep_at) and now >= keep_at[due][0]:
                waiting[keep_at[due][1]] += 1
                due += 1
            j = i % len(plan)
            keys, vals = args[j]
            s, e = ring[i % len(ring)]
            s.record()
            t = time.perf_counter()
            if call_range is None:
                out = sort_fn(keys, vals)
            else:
                with call_range():
                    out = sort_fn(keys, vals)
            issue_s.append(time.perf_counter() - t)
            e.record()
            if waiting[j]:
                waiting[j] -= 1
                if memory is not None:
                    memory.hold(out)
                kept.append((j, out))
            del out
            pending.append((s, e))
            rows += plan[j].rows
            i += 1
        _sync(device)
        elapsed = time.perf_counter() - t0
    finally:
        if gc_on:
            gc.enable()
    call_ms.extend(s.elapsed_time(e) for s, e in pending)
    # an answer due before the close whose plan entry was not issued again
    # by then is late, not missing: it is the next call of that entry
    for _, j in keep_at[due:]:
        waiting[j] += 1
    for j, n in sorted(waiting.items()):
        for _ in range(n):
            kept.append((j, sort_fn(*args[j])))
    return Window(elapsed, i - first, rows, call_ms, issue_s, kept, i)


def traced_stretch(sort_fn, args, plan, device, in_flight, first, calls):
    """The closed loop for ``calls`` calls under ``torch.profiler``, reduced
    by :func:`trace.summarize`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(trace.STRETCH):
            w = closed_loop(sort_fn, args, plan, device, in_flight, first=first, calls=calls,
                            call_range=lambda: record_function(trace.CALL))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        events = trace.load(path)
    return trace.summarize(events, w.calls, w.rows, in_flight)


def check(kept, args, plain) -> tuple:
    """Compare every kept answer with ``plain``'s answer (the reference of
    the cell's call) on the same inputs; frees each answer once compared.
    ``(mismatched rows, wrong answers, answers checked)``."""
    mismatched = wrong = checked = 0
    while kept:
        j, (out_first, out_rest) = kept.pop(0)
        ref_first, ref_rest = plain(*args[j])
        m = reference.mismatched_rows(out_first, out_rest, ref_first, ref_rest)
        del out_first, out_rest, ref_first, ref_rest
        mismatched += m
        wrong += m > 0
        checked += 1
    return mismatched, wrong, checked


def card_reading() -> dict:
    """The card's name, power limit and clocks from ``nvidia-smi``."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return {"nvidia_smi": f"not read: {err}"}
    return {"nvidia_smi": r.stdout.strip().splitlines()[:1] or r.stderr.strip()[-200:]}


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    config: dict
    traffic: dict
    device_kind: str
    peaks: dict
    setup_s: float
    window_s: float
    rows: int
    call_ms: list
    issue_s: list
    window_peak_bytes: int
    trace: trace.Summary | None


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             sort_fn=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``sort_fn``
    replaces the program of the cell's call (the control and the fault
    tests do)."""
    device = torch.device(device)
    seed %= 1 << 64
    mark = time.perf_counter()
    parts = {"before_s": mark - t_start}  # the interpreter, torch, the harness

    def part(name):
        nonlocal mark
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    call = load_call(cell.traffic["call"])
    if sort_fn is None:
        sort_fn = call.program()
    part("program_import_s")
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    part("context_s")
    traffic = cell.traffic
    table = inputs.make_table(cell.config, traffic, device, seed)
    plan = generator.plan(traffic, table.rows, seed)
    args = [(table.keys[c.key_set][c.offset:c.offset + c.rows],
             tuple(table.columns[p][c.offset:c.offset + c.rows] for p in traffic["payloads"]))
            for c in plan]
    _sync(device)
    part("inputs_s")
    in_flight = int(traffic.get("in_flight", 2))
    n_keep = int(traffic["check_answers"])
    # every plan entry once, and the window's pattern of kept answers and
    # calls in flight, so the allocator holds what the window will ask of it
    keep_at = generator.samples(traffic, plan, seconds, seed)
    warm = closed_loop(sort_fn, args, plan, device, in_flight,
                       calls=max(len(plan), n_keep + in_flight + 1),
                       keep_at=[(0.0, j) for _, j in keep_at])
    warm.kept.clear()
    part("warmup_s")  # the first run of a checkout builds the kernels here
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    memory = PeakMemory(device)
    memory.start()

    win = closed_loop(sort_fn, args, plan, device, in_flight, first=warm.next_call,
                      seconds=seconds, keep_at=keep_at, memory=memory)
    memory.close()

    summary = None
    if traced:
        summary = traced_stretch(sort_fn, args, plan, device, in_flight, win.next_call,
                                 int(traffic["trace_calls"]))
    card = card_reading() if device.type == "cuda" else {}
    mismatched, wrong, checked = check(win.kept, args, call.reference)

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    peaks = json.loads((HERE / "peaks.json").read_text())
    run = Run(cell.config, traffic, kind, peaks, setup_s, win.seconds, win.rows, win.call_ms,
              win.issue_s, memory.own, summary)
    metrics = read_metrics(cell, cell.per_layer if traced else cell.end_to_end, run)
    result = {
        "correct": mismatched == 0 and checked == n_keep,
        "attempted": win.calls,
        "failed": wrong + (n_keep - checked),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": kind,
            "count": cell.chips,
            "memory_peak_bytes": max(setup_peak, memory.whole),
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_us * 1e-6
        result["device"]["window_s"] = summary.window_us * 1e-6
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["setup_parts"] = parts
    result["held_answer_bytes"] = memory.held
    result["card"] = card
    result["checks"] = {
        "mismatched_rows": {"value": mismatched, "limit": 0},
        "unchecked_answers": {"value": n_keep - checked, "limit": 0},
    }
    log(f"[sortbench] {cell.name} seed={seed} calls={win.calls} rows={win.rows} "
        f"window_s={win.seconds:.6f} setup_s={setup_s:.6f} parts={json.dumps(parts)} {card}")
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
