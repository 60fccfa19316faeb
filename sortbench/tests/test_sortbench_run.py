"""A whole run on the CPU at a small size: the program passes the check;
the control and each fault a one-card sort can have do not."""

import json
import time

import pytest
import torch
from conftest import small_cell

from sortbench import generator, harness, reference

SEED = 2**31 + 4242
# enough rows that uniform 32-bit keys have ties (about 8 pairs at 2^18)
SIZES = {
    "u32-pairs-1e8": dict(rows=1 << 18),
    "u64zipf-pairs-1e8": dict(rows=1 << 16),
    "u32-pairs-small": dict(rows=1 << 21, rows_spec={"sizes": [1 << 19], "each": 4}),
}


def cell(name):
    s = dict(SIZES[name])
    extra = {"rows": s.pop("rows_spec")} if "rows_spec" in s else {}
    return small_cell(name, s["rows"], check_answers=2, trace_calls=6, **extra)


def run(name, seconds=0.5, traced=False, sort_fn=None):
    return harness.run_cell(cell(name), SEED, seconds, traced, "cpu", time.perf_counter(),
                            sort_fn=sort_fn)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_program_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4
    rate = "part.rows_per_s" if name == "u32-pairs-small" else "rows_per_s"
    assert set(r["metrics"]) >= {rate, "peak_mem_gb", "setup_s"}
    assert set(r["metrics"]) == {m["name"] for m in harness.find_cell(name).end_to_end}
    assert list(r)[-1] == "checks"
    assert r["checks"] == {"mismatched_rows": {"value": 0, "limit": 0},
                           "unchecked_answers": {"value": 0, "limit": 0}}
    json.dumps(r)


def test_traced_run_reports_per_layer_metrics():
    r = run("u32-pairs-small", traced=True)
    assert r["correct"]
    # on the CPU only the host's span has something to read
    assert set(r["metrics"]) == {"part.dispatch.issue_ms"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in r["device"] and r["device"]["window_s"] > 0


def unchanged(keys, payloads):
    return keys.clone(), tuple(p.clone() for p in payloads)


def half_left_out(keys, payloads):
    """Sorts the first half of the rows and passes the rest through."""
    sort = harness.program_sort()
    h = keys.shape[0] // 2
    k, ps = sort(keys[:h], tuple(p[:h] for p in payloads))
    return (torch.cat([reference.bits(k), reference.bits(keys[h:])]).view(keys.dtype),
            tuple(torch.cat([reference.bits(a), reference.bits(p[h:])]).view(p.dtype)
                  for a, p in zip(ps, payloads)))


def answer_altered(keys, payloads):
    """The program's answer with one payload value changed where it is made."""
    k, ps = harness.program_sort()(keys, payloads)
    last = ps[-1].clone()
    reference.bits(last)[keys.shape[0] // 3] ^= 1
    return k, (*ps[:-1], last)


@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("fault", [reference.control_sort, unchanged, half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
def test_check_rejects(name, fault):
    r = run(name, sort_fn=fault)
    assert not r["correct"]
    assert r["checks"]["mismatched_rows"]["value"] > 0
    assert r["failed"] >= 1


def test_answer_due_at_the_close_is_taken_late():
    """An answer due before the close whose plan entry is not issued again
    in the window is the next call of that entry, after the close."""
    keys = torch.arange(8, 0, -1, dtype=torch.int32).view(torch.uint32)
    vals = (torch.arange(8, dtype=torch.int32).view(torch.uint32),)
    plan = [generator.Call(0, 0, 8)]
    w = harness.closed_loop(reference.sort_pairs, [(keys, vals)], plan, torch.device("cpu"), 2,
                            calls=1, keep_at=[(1e9, 0)])
    assert w.calls == 1 and len(w.kept) == 1
    j, (out_k, out_v) = w.kept[0]
    assert j == 0 and reference.mismatched_rows(out_k, out_v,
                                                *reference.sort_pairs(keys, vals)) == 0
