"""Shared fixtures of the benchmark's own tests (``python -m pytest
sortbench/tests -q``). Tests that need the card are marked ``cuda`` and
skip inside the ``cuda_device`` fixture when there is none."""

import dataclasses
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    """Torch on one intra-op thread, as ``run.py`` sets it: several test
    workers side by side then do not thrash each other's threads."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the benchmark's card tests run on the H100")
    return "cuda:0"


def small_cell(name: str, table_rows: int, **traffic):
    """The cell ``name`` of BENCHMARK.json at ``table_rows`` rows, with
    traffic parameters replaced."""
    from sortbench import harness

    cell = harness.find_cell(name)
    return dataclasses.replace(cell, config={**cell.config, "rows": table_rows},
                               traffic={**cell.traffic, **traffic})
