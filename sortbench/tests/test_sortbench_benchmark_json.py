"""BENCHMARK.json keeps to its contract's shapes, and a cell is found by
name from files alone."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from sortbench import generator, harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
METRIC_KEYS = {"name", "unit", "better", "source"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "sortbench/run.py"]
    assert BENCH["paths"] == ["sortbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got)), group


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("sortbench/configs/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        traffic = json.loads((ROOT / "sortbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "sortbench" / "calls" / f"{traffic['call']}.py").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "sortbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_per_layer_cells_report_what_they_move():
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in harness.find_cell(w).end_to_end}


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert all(m["moves"] in names for m in cell.per_layer)


# a later call and a later key law, as the files a later change would add
DESCENDING_CALL = '''
from sortbench import reference as plain


def program():
    import vkradixsort_tpu_torch as vk

    def sort(keys, payloads):
        out_k, out_v = vk.sort_pairs(keys, payloads[0], descending=True)
        return out_k, (out_v,)

    return sort


def reference(keys, payloads, reverse_ties=False):
    perm = plain.permutation((~plain.bits(keys)).view(keys.dtype), reverse_ties)
    return plain.take(keys, perm), tuple(plain.take(p, perm) for p in payloads)
'''
LOW_BITS_LAW = '''
import torch


def make(n, key, device, gen):
    return torch.randint(0, 1 << int(key["bits"]), (n,), dtype=torch.int32, device=device,
                         generator=gen).view(torch.uint32)
'''
RUN_TINY = """
import json, pathlib, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]  # the copy's sortbench before the repo's
from sortbench import harness
assert harness.HERE == pathlib.Path(sys.argv[1]).resolve() / "sortbench"
cell = harness.find_cell("tiny", root=pathlib.Path(sys.argv[1]))
control = harness.control(harness.load_call(cell.traffic["call"]))
runs = [harness.run_cell(cell, 2**31 + 9, 0.2, False, "cpu", time.perf_counter(), sort_fn=f)
        for f in (None, control)]
print(json.dumps([[r["correct"], r["checks"]["mismatched_rows"]["value"]] for r in runs]))
"""


def test_new_cell_from_new_files(tmp_path):
    """A later cell is a config file, a traffic file, a call file, a
    key-law file and entries: in a copy of the benchmark that gains only
    those, the harness finds the cell by name, plans its calls, and runs it
    whole on the CPU, where the program passes the check and the call's
    control does not; no code of the copy is edited."""
    shutil.copytree(ROOT / "sortbench", tmp_path / "sortbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "sortbench" / "calls" / "sort_pairs_desc.py").write_text(DESCENDING_CALL)
    (tmp_path / "sortbench" / "keys" / "low_bits.py").write_text(LOW_BITS_LAW)
    config = {"name": "u32-tiny", "source": "https://example.org/tiny", "rows": 5000,
              "key": {"dtype": "uint32", "distribution": "low_bits", "bits": 6},
              "columns": {"row_id": "uint32"}, "reduced": [], "assumed": {}}
    traffic = {"call": "sort_pairs_desc", "payloads": ["row_id"],
               "rows": {"log_uniform": [100, 1000], "sizes": 8}, "offset": "uniform",
               "key_sets": 1, "in_flight": 2, "check_answers": 3, "trace_calls": 4}
    (tmp_path / "sortbench" / "configs" / "u32-tiny.json").write_text(json.dumps(config))
    (tmp_path / "sortbench" / "traffic" / "tiny-mix.json").write_text(json.dumps(traffic))
    bench = {**BENCH,
             "configs": [{"name": "u32-tiny", "source": config["source"],
                          "file": "sortbench/configs/u32-tiny.json", "reduced": [], "why": "t"}],
             "workloads": [{"name": "tiny", "config": "u32-tiny", "traffic": "tiny-mix",
                            "chips": 1, "why": "t"}],
             "per_layer": BENCH["per_layer"] + [
                 {"name": "other.metric", "unit": "ms", "better": "lower", "source": "host_clock",
                  "layer": "x", "moves": "rows_per_s", "workloads": ["not-this-cell"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell("tiny", root=tmp_path)
    assert cell.config == config and cell.traffic == traffic
    assert cell.metrics_dir == tmp_path / "sortbench" / "metrics"
    assert "other.metric" not in {m["name"] for m in cell.per_layer}
    calls = generator.plan(cell.traffic, cell.config["rows"], 1)
    assert len(calls) == 8 and all(c.offset + c.rows <= 5000 for c in calls)
    with pytest.raises(KeyError):
        harness.find_cell("absent", root=tmp_path)
    out = subprocess.run([sys.executable, "-c", RUN_TINY, str(tmp_path), str(ROOT)],
                         cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    (ok, ok_missed), (control_ok, control_missed) = json.loads(out.stdout.splitlines()[-1])
    assert ok and ok_missed == 0
    assert not control_ok and control_missed > 0
