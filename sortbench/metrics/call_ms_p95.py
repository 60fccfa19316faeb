"""The 95th percentile of the CUDA-event time of every call in the window,
in ms (linear interpolation between ranks, as numpy's default)."""

import statistics


def read(run):
    if len(run.call_ms) < 2:
        return None
    return statistics.quantiles(run.call_ms, n=100, method="inclusive")[94]
