"""Seconds from the start of the benchmark's process to the start of the
window: imports, the card's context, the kernel library's build or load,
the inputs and the warm-up."""


def read(run):
    return run.setup_s
