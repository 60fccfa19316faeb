"""A whole run on the CPU at a small size: the program passes the check;
the control and each fault a one-card sort can have do not, through the
cell's call (``sort_pairs`` or ``argsort``)."""

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
    "u32-lowentropy-pairs-1e8": dict(rows=1 << 16),
    "u32-argsort-1e8": dict(rows=1 << 18),
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


# each call's answer for rows left in input order: what a step that returns
# its input unchanged gives
IN_ORDER = {
    "sort_pairs": lambda keys, payloads: (keys, payloads),
    "argsort": lambda keys, payloads: (
        torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device).view(torch.uint32),
        ()),
}


def columns(answer):
    first, rest = answer
    return [first, *rest]


def answer(cols):
    return cols[0], tuple(cols[1:])


# each fault below takes the name of the cell's call and gives the sort_fn
def control_sort(name):
    return harness.control(harness.load_call(name))


def unchanged(name):
    def fault(keys, payloads):
        return answer([c.clone() for c in columns(IN_ORDER[name](keys, payloads))])
    return fault


def half_left_out(name):
    """Runs the call on the first half of the rows and leaves the rest in
    input order."""
    program = harness.load_call(name).program()

    def fault(keys, payloads):
        h = keys.shape[0] // 2
        done = columns(program(keys[:h], tuple(p[:h] for p in payloads)))
        left = columns(IN_ORDER[name](keys, payloads))
        return answer([torch.cat([reference.bits(a), reference.bits(b[h:])]).view(a.dtype)
                       for a, b in zip(done, left)])
    return fault


def answer_altered(name):
    """The program's answer with one value of its last column changed where
    it is made."""
    program = harness.load_call(name).program()

    def fault(keys, payloads):
        cols = columns(program(keys, payloads))
        last = cols[-1].clone()
        reference.bits(last)[keys.shape[0] // 3] ^= 1
        return answer(cols[:-1] + [last])
    return fault


@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("fault", [control_sort, unchanged, half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
def test_check_rejects(name, fault):
    c = cell(name)
    r = harness.run_cell(c, SEED, 0.5, False, "cpu", time.perf_counter(),
                         sort_fn=fault(c.traffic["call"]))
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
