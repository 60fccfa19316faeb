"""Rows sorted per second, in millions: every row of every call issued in
the window, over the window's wall time up to its closing synchronize. A
row is one key with all its payloads."""


def read(run):
    return run.rows / run.window_s / 1e6 if run.window_s > 0 else None
