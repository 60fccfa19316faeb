"""Tracing and profiling helpers.

Port of ``vkradixsort_tpu/utils/profiling.py``. The reference's only
instrumentation is a wall clock around submit and wait-idle, printed with a
component prefix; here:

  * ``trace(logdir)``: ``torch.profiler`` around the enclosed block (CPU,
    and CUDA where a card is visible), written as a Chrome trace
    (``trace.json`` in ``logdir``, for Perfetto or chrome://tracing);
  * ``timed(label)``: the wall clock of a block, fenced by
    ``torch.cuda.synchronize`` on the devices of the CUDA tensors stored in
    the yielded dict (for throwaway measurements; ``utils/timing.py`` times
    device work by CUDA events);
  * ``log(component, ...)``: ``[Component] message`` lines on stderr;
  * ``span(name)``: the program's spans, ``vkrs/<layer>/<step>`` ranges on
    the profiler's timeline (host and device on one clock), entered only
    while a profiler runs;
  * ``count(name, n)``, ``counters()``, ``since(before)``: the program's
    counters (``route.<engine>``, ``launch.<kernel wrapper>``,
    ``kernels.builds``, ``kernels.load_s``), always on.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import sys
import threading
import time

import torch

DEFAULT_TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "trace"
_OFF = contextlib.nullcontext()

# name -> running total; every process starts from nothing
COUNTERS: dict[str, float] = {}
_COUNTING = threading.Lock()  # sorts may run on several threads at once


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs, else a shared no-op context: with no profiler a span
    costs a flag test, under a microsecond, where an unguarded range takes
    over ten. Name spans ``vkrs/<layer>/<step>``."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _COUNTING:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def counters() -> dict:
    """A snapshot of every counter."""
    with _COUNTING:
        return dict(COUNTERS)


def since(before: dict) -> dict:
    """The counters that moved since the snapshot ``before``, by how much."""
    return {k: v - before.get(k, 0) for k, v in counters().items() if v != before.get(k, 0)}


def log(component: str, *message) -> None:
    """``[Component] message`` to stderr (the reference's prefix style)."""
    print(f"[{component}]", *message, file=sys.stderr, flush=True)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree):
    """Wait until the device work that produced the tensors of ``tree``
    (nested lists, tuples and dicts) is done; returns ``tree``. CPU tensors
    are done when they exist."""
    for d in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(d)
    return tree


@contextlib.contextmanager
def trace(logdir: str | os.PathLike = DEFAULT_TRACE_DIR):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``logdir/trace.json``. Call :func:`block` on the
    block's outputs inside it, or the trace ends before the device work."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(logdir)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    log("profiler", f"trace written to {logdir}")


@contextlib.contextmanager
def timed(label: str, component: str = "vkradixsort"):
    """Wall-clock a block with a completion fence. Yields a dict that
    receives ``seconds`` on exit; store the block's outputs in it (any key)
    and the fence waits for the devices of its CUDA tensors."""
    out = {}
    t0 = time.perf_counter()
    yield out
    block(list(out.values()))
    out["seconds"] = time.perf_counter() - t0
    log(component, f"{label} finished in {out['seconds'] * 1e3:.3f} ms")
