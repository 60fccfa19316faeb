"""The sort's peak device memory over the window, in GB (1e9 B): the
allocator's ``max_memory_allocated()`` from ``reset_peak_memory_stats()``
at the window's start, less the answers the check keeps
(``harness.PeakMemory``). It counts the cell's inputs and the calls in
flight: the memory the sort takes beside a table."""


def read(run):
    return run.window_peak_bytes / 1e9
