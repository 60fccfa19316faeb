"""Median host time, in ms, for one call of the window to return to its
caller, without a synchronize: the dispatcher, the route table and the host
side of the engine's launches. The benchmark's own span around each call,
outside the profiler."""

import statistics


def read(run):
    return statistics.median(run.issue_s) * 1e3 if run.issue_s else None
