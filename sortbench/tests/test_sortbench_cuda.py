"""On the card: a short traced run of each cell at a reduced size is
correct and reads every per-layer metric; the control is rejected.

    python -m pytest sortbench/tests/test_sortbench_cuda.py -q   # on the H100
"""

import time

import pytest
from conftest import small_cell

from sortbench import harness

# 2^24 rows: above the 2^23 at which the route table sends one payload to
# radix_tiled; 2^26 for argsort, whose radix_tiled route starts above 2^25
CELLS = {"u32-pairs-1e8": 1 << 24, "u64zipf-pairs-1e8": 1 << 24, "u32-pairs-small": 1 << 24,
         "u32-lowentropy-pairs-1e8": 1 << 24, "u32-argsort-1e8": 1 << 26}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_on_the_card(cuda_device, name):
    r = harness.run_cell(small_cell(name, CELLS[name]), 2**31 + 11, 1.0, True, cuda_device,
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in harness.find_cell(name).per_layer}
    for k, v in r["metrics"].items():
        if k.endswith("_roofline"):
            assert 0 < v["value"] <= 100
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["u32-pairs-1e8", "u64zipf-pairs-1e8", "u32-lowentropy-pairs-1e8",
                                  "u32-argsort-1e8"])
def test_control_rejected_on_the_card(cuda_device, name):
    cell = small_cell(name, CELLS[name])
    control = harness.control(harness.load_call(cell.traffic["call"]))
    r = harness.run_cell(cell, 2**31 + 12, 0.5, False, cuda_device, time.perf_counter(),
                         sort_fn=control)
    assert not r["correct"] and r["checks"]["mismatched_rows"]["value"] > 0
