"""The cell ``f64desc-v3-pairs-1e8``: db-benchmark groupby q8's sort of
the frame's float64 v3 in descending order with its int32 id6. Its
configuration and traffic files, the call ``sort_pairs_desc``, the key law
``runif_round``, a whole run of the cell on the CPU at a small size with
the control and the faults of ``test_sortbench_run.py``, and the reader
``kernels.keyorder_roofline``."""

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
CELL = "f64desc-v3-pairs-1e8"
CONFIG = json.loads((HERE / "configs" / "f64-h2o-g1.json").read_text())
TRAFFIC = json.loads((HERE / "traffic" / "table-desc-pairs.json").read_text())
V3 = CONFIG["key"]
H100 = "NVIDIA H100 80GB HBM3"
SEED = 2**33 + 17


def test_config_holds_the_deployment():
    """G1_1e8_1e2_0_0 at its published size, nothing cut; q8's descending,
    stable, exact sort of v3 carrying id6."""
    assert CONFIG["name"] == "f64-h2o-g1" and CONFIG["rows"] == 100_000_000
    assert CONFIG["key"] == {"dtype": "float64", "distribution": "runif_round", "max": 100,
                             "digits": 6}
    assert CONFIG["columns"] == {"id6": "int32"} and CONFIG["reduced"] == []
    assert CONFIG["guarantees"] == {"order": "descending", "stable": True, "exact": True}
    assert {"rows", "key", "nulls", "columns", "call", "deployment"} <= set(CONFIG["assumed"])
    assert 1 <= len(CONFIG["source"]) <= 200 and "G1_1e8_1e2_0_0" in CONFIG["source"]


def test_traffic_is_the_whole_frame():
    assert TRAFFIC["call"] == "sort_pairs_desc" and TRAFFIC["payloads"] == ["id6"]
    assert TRAFFIC["rows"] == "table" and TRAFFIC["key_sets"] == 2 and TRAFFIC["in_flight"] == 2
    assert TRAFFIC["check_answers"] == 2 and TRAFFIC["trace_calls"] == 32
    assert generator.sizes(TRAFFIC, CONFIG["rows"])
    for text in (TRAFFIC["source"], TRAFFIC["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text


def test_cell_is_found_with_its_metrics():
    cell = harness.find_cell(CELL)
    assert cell.chips == 1 and cell.config == CONFIG and cell.traffic == TRAFFIC
    assert {m["name"] for m in cell.end_to_end} == {"rows_per_s", "call_ms_p95", "peak_mem_gb",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "dispatch.issue_ms", "driver.kernels_per_call", "kernels.sort_roofline",
        "device.idle_share", "kernels.keyorder_roofline"}


def test_seed_fixes_the_frame():
    config = {**CONFIG, "rows": 4096}
    a, b = (inputs.make_table(config, TRAFFIC, "cpu", SEED) for _ in range(2))
    c = inputs.make_table(config, TRAFFIC, "cpu", SEED + 1)
    for x, y in zip(a.keys + [a.columns["id6"]], b.keys + [b.columns["id6"]]):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert not torch.equal(a.keys[0], c.keys[0]) and not torch.equal(a.keys[0], a.keys[1])
    assert a.keys[0].dtype == torch.float64 and a.columns["id6"].dtype == torch.int32
    assert not torch.isnan(a.keys[0]).any()  # 0% NA


def v3_keys(n, seed=SEED, digits=6):
    return inputs.make_keys(n, {**V3, "digits": digits}, "cpu",
                            torch.Generator().manual_seed(seed))


def call():
    return harness.load_call("sort_pairs_desc")


@pytest.mark.parametrize("digits", [6, 1])
def test_reference_is_numpy_stable_argsort_of_negated_keys(digits):
    keys = v3_keys(20_000, digits=digits)
    id6 = torch.arange(20_000, dtype=torch.int32)
    out_k, (out_v,) = call().reference(keys, (id6,))
    perm = np.argsort(-keys.numpy(), kind="stable")
    np.testing.assert_array_equal(out_v.numpy(), perm)
    np.testing.assert_array_equal(out_k.numpy().view(np.uint64), keys.numpy()[perm].view(np.uint64))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reference_follows_the_total_order_on_edge_values(dtype):
    """+NaN, +inf, max, 1, the least denormal, +0.0, -0.0, -denormal, -1,
    -max, -inf, -NaN: descending total order, NaNs by their sign bit."""
    f = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    u = {torch.float64: np.uint64, torch.float32: np.uint32}[dtype]
    sign = u(1) << u(8 * dtype.itemsize - 1)
    pos = np.array([np.nan, np.inf, np.finfo(f).max, 1.0, np.finfo(f).smallest_subnormal, 0.0],
                   dtype=f)
    want = np.concatenate([pos, (pos[::-1].view(u) | sign).view(f)])  # then -0.0 ... -NaN
    shuffled = want[np.random.default_rng(3).permutation(want.size)]
    keys = torch.from_numpy(shuffled.copy())
    out_k, (out_v,) = call().reference(keys, (torch.arange(keys.numel()),))
    np.testing.assert_array_equal(out_k.numpy().view(u), want.view(u))
    np.testing.assert_array_equal(shuffled[out_v.numpy()].view(u), want.view(u))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.uint32, torch.uint64])
def test_reference_orders_integer_keys(dtype):
    g = torch.Generator().manual_seed(5)
    bits = torch.randint(-(2**62), 2**62, (4000,), generator=g, dtype=torch.int64)
    keys = bits.view(torch.int8)[: 4000 * dtype.itemsize].view(dtype).clone()
    out_k, (out_v,) = call().reference(keys, (torch.arange(4000),))
    wide = keys.view({4: torch.int32, 8: torch.int64}[dtype.itemsize]).numpy()
    if dtype in (torch.uint32, torch.uint64):
        wide = wide.view({4: np.uint32, 8: np.uint64}[dtype.itemsize])
    perm = sorted(range(4000), key=lambda i: (-int(wide[i]), i))
    np.testing.assert_array_equal(out_v.numpy(), perm)


def test_control_fails_the_check():
    keys = v3_keys(20_000, digits=1)  # 1001 values: nearly every row tied
    payloads = (torch.arange(20_000, dtype=torch.int32),)
    ref = call().reference(keys, payloads)
    control = harness.control(call())(keys, payloads)
    assert reference.mismatched_rows(*control, *ref) > 10_000
    assert reference.mismatched_rows(*call().program()(keys, payloads), *ref) == 0


def q8_cell():
    """The cell at 2^16 rows, six traced calls."""
    return small_cell(CELL, 1 << 16, check_answers=2, trace_calls=6)


def control(keys, payloads):
    """The call's control: rows of equal keys in reverse input order."""
    return harness.control(call())(keys, payloads)


def unchanged(keys, payloads):
    """Every row left in input order."""
    return keys.clone(), tuple(p.clone() for p in payloads)


def half_left_out(keys, payloads):
    """The program on the first half of the rows, the rest in input order."""
    h = keys.shape[0] // 2
    out_k, out_vs = call().program()(keys[:h], tuple(p[:h] for p in payloads))
    return (torch.cat([out_k, keys[h:]]),
            tuple(torch.cat([o, p[h:]]) for o, p in zip(out_vs, payloads)))


def answer_altered(keys, payloads):
    """The program's answer with one bit of its payload changed."""
    out_k, (out_v,) = call().program()(keys, payloads)
    out_v = out_v.clone()
    reference.bits(out_v)[keys.shape[0] // 3] ^= 1
    return out_k, (out_v,)


def test_cell_runs_on_the_cpu():
    r = harness.run_cell(q8_cell(), SEED, 0.3, False, "cpu", time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4
    assert r["checks"]["mismatched_rows"]["value"] == 0
    assert set(r["metrics"]) >= {"rows_per_s", "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("fault", [control, unchanged, half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
def test_check_rejects(fault):
    r = harness.run_cell(q8_cell(), SEED, 0.3, False, "cpu", time.perf_counter(), sort_fn=fault)
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["mismatched_rows"]["value"] > 0


def test_runif_round_gives_rounded_values_from_the_seed():
    keys = v3_keys(200_000)
    assert keys.dtype == torch.float64
    assert torch.equal(keys, v3_keys(200_000)) and not torch.equal(keys, v3_keys(200_000, SEED + 1))
    k = torch.round(keys * 1e6)
    assert torch.equal(k / 1e6, keys)  # each key the double nearest k / 1e6
    assert 0 <= float(keys.min()) and float(keys.max()) <= 100
    assert abs(float(keys.mean()) - 50) < 0.5  # uniform over [0, 100]
    assert (keys.unique().numel()) < keys.numel()  # ties exist


def test_runif_round_refuses_other_dtypes():
    with pytest.raises(ValueError):
        inputs.make_keys(4, {**V3, "dtype": "uint64"}, "cpu", torch.Generator())


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_with(device_ops, kind=H100, call="sort_pairs_desc"):
    t = trace.Summary(calls=32, rows=3_200_000_000, window_us=3.4e5, busy_us=3.39e5,
                      device_op_us=3.3e5, kernels=352, device_ops=device_ops, idle_gaps=[])
    return harness.Run(config=CONFIG, traffic={**TRAFFIC, "call": call}, device_kind=kind,
                       peaks=json.loads((HERE / "peaks.json").read_text()), setup_s=9.0,
                       window_s=10.0, rows=1, call_ms=[10.0], issue_s=[1e-4],
                       window_peak_bytes=1, trace=t)


def test_keyorder_roofline_reads_a_hand_made_trace():
    read = reader("kernels.keyorder_roofline")
    ops = [["void vkrs::(anonymous namespace)::onesweep_kernel<unsigned long long, 4>(...)", 0.26],
           ["void vkrs::(anonymous namespace)::key_order_kernel<unsigned long long, 2>(...)", 0.02],
           ["void vkrs::(anonymous namespace)::key_order_kernel<unsigned long long, 1>(...)", 0.01]]
    least = 4 * 8 * 3_200_000_000 / 3.35e12  # 32 B a row, both directions
    assert read(run_with(ops)) == pytest.approx(100 * least / 0.03)
    # argsort encodes alone: half the traffic
    assert read(run_with(ops, call="argsort")) == pytest.approx(50 * least / 0.03)
    assert read(run_with(ops[:1])) is None  # no key_order kernel: the parent's program
    assert read(run_with(ops, kind="cpu")) is None
    assert read(dataclasses.replace(run_with(ops), trace=None)) is None
