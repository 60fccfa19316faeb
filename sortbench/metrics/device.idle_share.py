"""The share, in %, of the profiled stretch's steady part in which no
kernel, copy or memset ran on the card: 1 - (union of their intervals) /
(the steady part's wall time, from the issue of the call after the first
``in_flight`` to the issue of the last; ``trace.steady_part``)."""


def read(run):
    t = run.trace
    if t is None or t.window_us <= 0 or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
