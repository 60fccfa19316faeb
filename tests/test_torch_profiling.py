"""The PyTorch port's profiling helpers (utils/profiling.py) on the CPU:
the cases of tests/test_profiling.py, on torch tensors, less its traffic
estimate (the port has none). The spans and counters are tested in
tests/test_torch_tracing.py."""

import os

import torch

from vkradixsort_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_timed_and_block(capsys):
    with profiling.timed("noop", component="Test") as out:
        out["y"] = profiling.block(torch.arange(8) * 2)
    assert out["seconds"] >= 0
    assert torch.equal(out["y"], torch.arange(8) * 2)
    err = capsys.readouterr().err
    assert "[Test] noop finished in" in err


def test_log_prefix(capsys):
    profiling.log("MultiRadixSort", "GPU sort finished in", 1.23, "[ms].")
    assert capsys.readouterr().err.startswith("[MultiRadixSort]")


def test_trace_writes_dir(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        profiling.block(torch.cumsum(torch.ones(1024), 0))
    assert os.path.isdir(d)
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
