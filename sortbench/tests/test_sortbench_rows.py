"""The cell ``f32-topp-rows-1024x129280``: a top-p sampler's sort of every
row of a decode step's float32 logits with its int32 token ids. Its
configuration and traffic files, the call ``topp_sort_rows``, the key law
``normal``, a whole run of the cell on the CPU at two rows with the control
and the faults the comparison has to reject, and the reader
``kernels.rows_roofline``."""

import dataclasses
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch
from conftest import small_cell

from sortbench import generator, harness, inputs, reference, trace

HERE = pathlib.Path(__file__).resolve().parents[1]
CELL = "f32-topp-rows-1024x129280"
CONFIG = json.loads((HERE / "configs" / "f32-dsv3-logits-b1024.json").read_text())
TRAFFIC = json.loads((HERE / "traffic" / "rows-logits-pairs.json").read_text())
H100 = "NVIDIA H100 80GB HBM3"
SEED = 2**33 + 29
ROW = 129280


def call():
    return harness.load_call("topp_sort_rows")


def test_config_holds_the_deployment():
    """1,024 rows of DeepSeek-V3's 129,280 logits, nothing cut; an
    ascending, stable, exact sort of float32 keys carrying int32 ids."""
    assert CONFIG["name"] == "f32-dsv3-logits-b1024"
    assert CONFIG["rows"] == 1024 * 129280 == CONFIG["max_num_seqs"] * CONFIG["vocab_size"]
    assert call().ROW == CONFIG["vocab_size"] == ROW
    assert CONFIG["key"] == {"dtype": "float32", "distribution": "normal", "mean": 0, "std": 1}
    assert CONFIG["columns"] == {"token_id": "int32"} and CONFIG["reduced"] == []
    assert CONFIG["guarantees"] == {"order": "ascending", "stable": True, "exact": True}
    assert {"rows", "width", "key", "columns", "call", "deployment"} <= set(CONFIG["assumed"])
    assert 1 <= len(CONFIG["source"]) <= 200 and "apply_top_k_top_p" in CONFIG["source"]
    assert "DeepSeek-V3" in CONFIG["source"] and "vocab_size" in CONFIG["source"]


def test_traffic_is_the_whole_step():
    assert TRAFFIC["call"] == "topp_sort_rows" and TRAFFIC["payloads"] == ["token_id"]
    assert TRAFFIC["rows"] == "table" and TRAFFIC["key_sets"] == 2 and TRAFFIC["in_flight"] == 2
    assert TRAFFIC["check_answers"] == 2 and TRAFFIC["trace_calls"] == 32
    assert generator.sizes(TRAFFIC, CONFIG["rows"]) == [CONFIG["rows"]]
    for text in (TRAFFIC["source"], TRAFFIC["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text


def test_cell_is_found_with_its_metrics():
    cell = harness.find_cell(CELL)
    assert cell.chips == 1 and cell.config == CONFIG and cell.traffic == TRAFFIC
    assert {m["name"] for m in cell.end_to_end} == {"rows_per_s", "call_ms_p95", "peak_mem_gb",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "dispatch.issue_ms", "driver.kernels_per_call", "kernels.sort_roofline",
        "device.idle_share", "kernels.keyorder_roofline", "kernels.rows_roofline"}


def test_seed_fixes_the_logits():
    config = {**CONFIG, "rows": 2 * ROW}
    a, b = (inputs.make_table(config, TRAFFIC, "cpu", SEED) for _ in range(2))
    c = inputs.make_table(config, TRAFFIC, "cpu", SEED + 1)
    for x, y in zip(a.keys + [a.columns["token_id"]], b.keys + [b.columns["token_id"]]):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert not torch.equal(a.keys[0], c.keys[0]) and not torch.equal(a.keys[0], a.keys[1])
    assert a.keys[0].dtype == torch.float32 and a.columns["token_id"].dtype == torch.int32
    k = a.keys[0]
    assert abs(float(k.mean())) < 0.01 and abs(float(k.std()) - 1) < 0.01  # N(0, 1)
    assert k.unique().numel() < k.numel()  # ties exist, so stability shows


def test_normal_law_scales_and_refuses_other_dtypes():
    gen = torch.Generator().manual_seed(3)
    x = inputs.make_keys(100_000, {"dtype": "float32", "distribution": "normal", "mean": 5,
                                   "std": 2}, "cpu", gen)
    assert abs(float(x.mean()) - 5) < 0.05 and abs(float(x.std()) - 2) < 0.05
    with pytest.raises(ValueError):
        inputs.make_keys(4, {"dtype": "float64", "distribution": "normal", "mean": 0, "std": 1},
                         "cpu", gen)


def _rows_keys(rows, seed=SEED):
    gen = torch.Generator().manual_seed(seed)
    keys = torch.randn(rows * ROW, generator=gen)
    keys[::97] = torch.round(keys[::97] * 4) / 4  # more ties
    ids = torch.randint(-(2**31), 2**31, (rows * ROW,), dtype=torch.int32, generator=gen)
    return keys, ids


def test_reference_is_numpy_stable_argsort_of_each_row():
    keys, ids = _rows_keys(3)
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan")])
    keys[:5] = specials
    keys[ROW:ROW + 5] = specials
    keys[ROW + 5] = (torch.tensor([float("nan")]).view(torch.int32) | -(2**31)).view(torch.float32)
    out_k, (out_v,) = call().reference(keys, (ids,))
    bits = keys.view(torch.int32).numpy()
    order = np.where(bits < 0, ~bits, bits ^ np.int32(-(2**31))).view(np.uint32)
    perm = np.concatenate([r * ROW + np.argsort(order[r * ROW:(r + 1) * ROW], kind="stable")
                           for r in range(3)])
    np.testing.assert_array_equal(out_v.numpy(), ids.numpy()[perm])
    np.testing.assert_array_equal(out_k.view(torch.int32).numpy(), bits[perm])


def test_program_and_reference_refuse_partial_rows():
    keys, ids = _rows_keys(1)
    for fn in (call().program(), call().reference):
        with pytest.raises(ValueError):
            fn(keys[:-1], (ids[:-1],))


def rows_cell():
    """The cell at two rows, six traced calls."""
    return small_cell(CELL, 2 * ROW, check_answers=2, trace_calls=6)


def control(keys, payloads):
    """The call's control: rows of equal keys in reverse input order."""
    return harness.control(call())(keys, payloads)


def unchanged(keys, payloads):
    """Every row left in input order."""
    return keys.clone(), tuple(p.clone() for p in payloads)


def half_left_out(keys, payloads):
    """The program on the first half of the rows, the rest in input order."""
    h = keys.shape[0] // ROW // 2 * ROW
    out_k, out_vs = call().program()(keys[:h], tuple(p[:h] for p in payloads))
    return (torch.cat([out_k, keys[h:]]),
            tuple(torch.cat([o, p[h:]]) for o, p in zip(out_vs, payloads)))


def answer_altered(keys, payloads):
    """The program's answer with one bit of its payload changed."""
    out_k, (out_v,) = call().program()(keys, payloads)
    out_v = out_v.clone()
    reference.bits(out_v)[keys.shape[0] // 3] ^= 1
    return out_k, (out_v,)


def whole_array_sorted(keys, payloads):
    """One sort of the whole flat array in place of a sort of each row."""
    import vkradixsort_tpu_torch as vk

    out_k, out_v = vk.sort_pairs(keys, payloads[0])
    return out_k, (out_v,)


def test_control_fails_the_check():
    keys, ids = _rows_keys(2)
    ref = call().reference(keys, (ids,))
    assert reference.mismatched_rows(*control(keys, (ids,)), *ref) > 100
    assert reference.mismatched_rows(*call().program()(keys, (ids,)), *ref) == 0


def test_cell_runs_on_the_cpu():
    r = harness.run_cell(rows_cell(), SEED, 0.3, False, "cpu", time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4
    assert r["checks"]["mismatched_rows"]["value"] == 0
    assert set(r["metrics"]) >= {"rows_per_s", "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("fault", [control, unchanged, half_left_out, answer_altered,
                                   whole_array_sorted], ids=lambda f: f.__name__)
def test_check_rejects(fault):
    r = harness.run_cell(rows_cell(), SEED, 0.3, False, "cpu", time.perf_counter(), sort_fn=fault)
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["mismatched_rows"]["value"] > 0


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_with(device_ops, kind=H100):
    t = trace.Summary(calls=32, rows=32 * 132_382_720, window_us=2e5, busy_us=1.99e5,
                      device_op_us=1.9e5, kernels=224, device_ops=device_ops, idle_gaps=[])
    return harness.Run(config=CONFIG, traffic=TRAFFIC, device_kind=kind,
                       peaks=json.loads((HERE / "peaks.json").read_text()), setup_s=9.0,
                       window_s=10.0, rows=1, call_ms=[6.0], issue_s=[1e-4],
                       window_peak_bytes=1, trace=t)


def test_rows_roofline_reads_a_hand_made_trace():
    read = reader("kernels.rows_roofline")
    ops = [["void vkrs::(anonymous namespace)::onesweep_rows_kernel<unsigned int, 4, false>(...)",
            0.12],
           ["void vkrs::(anonymous namespace)::digit_histograms_rows_kernel<unsigned int>(...)",
            0.01],
           ["void vkrs::(anonymous namespace)::key_order_kernel<unsigned int, 1>(...)", 0.02],
           ["void vkrs::(anonymous namespace)::onesweep_kernel<unsigned int, 4, false>(...)",
            0.5]]
    least = 2 * 8 * 32 * 132_382_720 / 3.35e12  # 16 B a row: the f32 key and its int32 id
    assert read(run_with(ops)) == pytest.approx(100 * least / 0.13)
    assert read(run_with(ops[2:])) is None  # no row kernel: the parent's program
    assert read(run_with(ops, kind="cpu")) is None
    assert read(dataclasses.replace(run_with(ops), trace=None)) is None
