"""Configuration and traffic files, the table made from the seed, and the
plan of calls."""

import hashlib
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from sortbench import generator, inputs

HERE = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((HERE / "configs").glob("*.json"))
TRAFFIC = sorted((HERE / "traffic").glob("*.json"))
BIG_SEED = 2**31 + 987654321


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_loads(path):
    c = json.loads(path.read_text())
    assert c["name"] == path.stem
    assert c["rows"] >= 1 and c["key"]["dtype"] in ("uint32", "uint64")
    assert c["guarantees"] == {"order": "ascending", "stable": True, "exact": True}
    assert isinstance(c["reduced"], list) and isinstance(c["assumed"], dict)
    assert 1 <= len(c["source"]) <= 200


@pytest.mark.parametrize("path", TRAFFIC, ids=lambda p: p.stem)
def test_traffic_loads(path):
    t = json.loads(path.read_text())
    assert (HERE / "calls" / f"{t['call']}.py").is_file()
    assert isinstance(t["payloads"], list) and (t["payloads"] or t["call"] == "argsort")
    assert t["in_flight"] in (1, 2) and t["check_answers"] >= 1 and t["trace_calls"] >= 1
    assert generator.sizes(t, 100_000_000)
    assert 1 <= len(t["source"]) <= 200 and "\n" not in t["source"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_seed_fixes_table(path):
    config = {**json.loads(path.read_text()), "rows": 4096}
    traffic = {"payloads": list(config["columns"]), "key_sets": 2}
    a = inputs.make_table(config, traffic, "cpu", BIG_SEED)
    b = inputs.make_table(config, traffic, "cpu", BIG_SEED)
    c = inputs.make_table(config, traffic, "cpu", BIG_SEED + 1)
    for x, y in zip(a.keys + list(a.columns.values()), b.keys + list(b.columns.values())):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert not torch.equal(a.keys[0].view(torch.uint8), c.keys[0].view(torch.uint8))
    assert not torch.equal(a.keys[0].view(torch.uint8), a.keys[1].view(torch.uint8))
    assert a.keys[0].dtype == {"uint32": torch.uint32, "uint64": torch.uint64}[config["key"]["dtype"]]
    assert torch.equal(a.columns["row_id"].view(torch.int32), torch.arange(4096, dtype=torch.int32))


# sha256 of a table's bytes (key sets, then the configuration's columns in
# its order) at 4096 rows and two key sets, drawn on the CPU's generator:
# the digests of these three configurations' tables before key laws became
# files, so their draws are still byte for byte what they were
TABLE_SHA256 = {
    "u32-uniform": "d19b200691793b74d44ebee3b93b566ee58188f8ef9c6611d7a67431485a3366",
    "u64-uniform": "bc089d73abc418542b6a9bea650c277affa1ccb33d12186c8e63253a9c4a1e4c",
    "u64-zipf": "07f305a3142704aa64365f69254323f93f6328fff8873e10b3b0867565a3df01",
}


@pytest.mark.parametrize("name", sorted(TABLE_SHA256))
def test_table_digest_pinned(name):
    config = {**json.loads((HERE / "configs" / f"{name}.json").read_text()), "rows": 4096}
    traffic = {"payloads": list(config["columns"]), "key_sets": 2}
    t = inputs.make_table(config, traffic, "cpu", BIG_SEED)
    h = hashlib.sha256()
    for x in t.keys + [t.columns[c] for c in config["columns"]]:
        h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == TABLE_SHA256[name]


@pytest.mark.parametrize("dtype,words", [("uint32", 5), ("uint64", 5), ("uint32", 2)])
def test_and_words_bit_probability(dtype, words):
    """Each bit of the AND of ``words`` uniform draws is 1 with probability
    2^-words, within 4 sigma at 2^18 keys."""
    n = 1 << 18
    key = {"dtype": dtype, "distribution": "and_words", "words": words}
    k = inputs.make_keys(n, key, "cpu", torch.Generator().manual_seed(11))
    assert k.dtype == inputs.UNSIGNED[dtype] and k.shape == (n,)
    width = k.element_size() * 8
    signed = k.view(inputs.INT_OF[dtype]).long()
    p = 2.0**-words
    sigma = math.sqrt(p * (1 - p) / n)
    for b in range(width):
        share = float(((signed >> b) & 1).double().mean())
        assert abs(share - p) < 4 * sigma, (b, share)


def test_and_words_low_entropy_config():
    """The configuration's law: 36% of the keys are 0 ((31/32)^32) and each
    8-bit digit is 0 in 77.6% of them ((31/32)^8)."""
    c = json.loads((HERE / "configs" / "u32-lowentropy.json").read_text())
    k = inputs.make_keys(1 << 18, c["key"], "cpu", torch.Generator().manual_seed(12))
    v = k.view(torch.int32).long() & 0xFFFFFFFF
    assert abs(float((v == 0).double().mean()) - (31 / 32) ** 32) < 0.005
    for d in range(4):
        assert abs(float((((v >> 8 * d) & 0xFF) == 0).double().mean()) - (31 / 32) ** 8) < 0.005


def test_unknown_key_law_is_refused():
    with pytest.raises(ValueError, match="no_such_law"):
        inputs.make_keys(8, {"dtype": "uint32", "distribution": "no_such_law"}, "cpu",
                         torch.Generator().manual_seed(1))


def test_uniform_keys_cover_32_bits():
    k = inputs.make_keys(1 << 16, {"dtype": "uint32", "distribution": "uniform"}, "cpu",
                         torch.Generator().manual_seed(3)).view(torch.int32).long() & 0xFFFFFFFF
    assert k.min() < 1 << 24 and k.max() > (1 << 32) - (1 << 24)
    assert abs(float((k >= 1 << 31).float().mean()) - 0.5) < 0.01


def test_zipf_has_numpy_law():
    """The device sampler and numpy's zipf agree on the share of each small
    value (a quarter of the keys equal 1) and of the tail."""
    n = 400_000
    ours = inputs.zipf(n, 1.3, "cpu", torch.Generator().manual_seed(5)).numpy()
    theirs = np.random.default_rng(5).zipf(1.3, size=n)
    assert ours.min() >= 1
    for v in (1, 2, 3, 4, 5):
        assert abs((ours == v).mean() - (theirs == v).mean()) < 0.004, v
    assert abs((ours == 1).mean() - 1 / 3.9319) < 0.004  # 1 / zeta(1.3)
    for edge in (10, 1000, 10**6):
        assert abs((ours > edge).mean() - (theirs > edge).mean()) < 0.004, edge


def test_plan_same_sizes_every_seed():
    t = json.loads((HERE / "traffic" / "partition-pairs.json").read_text())
    n = 100_000_000
    a = generator.plan(t, n, BIG_SEED)
    b = generator.plan(t, n, BIG_SEED + 1)
    assert sorted(c.rows for c in a) == sorted(c.rows for c in b)
    assert [c.offset for c in a] != [c.offset for c in b]
    assert a == generator.plan(t, n, BIG_SEED)
    each = t["rows"]["each"]
    assert sorted(c.rows for c in a) == sorted(t["rows"]["sizes"] * each)
    # aligned offsets: each call is one whole partition of its own size
    assert all(c.offset % c.rows == 0 and c.offset + c.rows <= n for c in a)
    assert len({(c.rows, c.offset) for c in a}) > len(a) // 2


def test_plan_two_sizes_in_seeded_order():
    t = {"rows": {"sizes": [1 << 16, 1 << 20], "each": 8}, "offset": "aligned"}
    a, b = generator.plan(t, 1 << 24, 1), generator.plan(t, 1 << 24, 2)
    assert sorted(c.rows for c in a) == sorted(c.rows for c in b) == [1 << 16] * 8 + [1 << 20] * 8
    assert [c.rows for c in a] != [c.rows for c in b]


def test_plan_log_uniform_sizes():
    t = {"rows": {"log_uniform": [1 << 16, 1 << 22], "sizes": 256}, "offset": "uniform"}
    n = 100_000_000
    a = generator.plan(t, n, BIG_SEED)
    assert sorted(c.rows for c in a) == sorted(c.rows for c in generator.plan(t, n, 5))
    lo, hi = t["rows"]["log_uniform"]
    assert len(a) == t["rows"]["sizes"]
    assert all(lo <= c.rows <= hi and 0 <= c.offset <= n - c.rows for c in a)
    logs = sorted(math.log2(c.rows) for c in a)
    assert abs(np.mean(logs) - (math.log2(lo) + math.log2(hi)) / 2) < 0.01


@pytest.mark.parametrize("rows", [{"sizes": [], "each": 2}, {"sizes": [10, 2000], "each": 1},
                                  {"sizes": [10], "each": 0}])
def test_plan_refuses_bad_sizes(rows):
    with pytest.raises(ValueError):
        generator.plan({"rows": rows}, 1000, 1)


def test_plan_whole_table_alternates_key_sets():
    t = json.loads((HERE / "traffic" / "table-pairs.json").read_text())
    p = generator.plan(t, 1000, 7)
    assert [(c.key_set, c.offset, c.rows) for c in p] == [(0, 0, 1000), (1, 0, 1000)]


def test_samples_from_seed_same_sizes():
    t = json.loads((HERE / "traffic" / "partition-pairs.json").read_text())
    n = 100_000_000
    p1, p2 = generator.plan(t, n, BIG_SEED), generator.plan(t, n, BIG_SEED + 1)
    a = generator.samples(t, p1, 10.0, BIG_SEED)
    b = generator.samples(t, p2, 10.0, BIG_SEED + 1)
    assert len(a) == t["check_answers"] and a == generator.samples(t, p1, 10.0, BIG_SEED)
    assert [x for x, _ in a] == sorted(x for x, _ in a)
    assert all(0.5 <= x <= 9.0 for x, _ in a)
    assert a != b
    # the same sizes kept on every seed, spread over the plan's range
    assert sorted(p1[j].rows for _, j in a) == sorted(p2[j].rows for _, j in b)
    kept = sorted(p1[j].rows for _, j in a)
    assert kept == sorted(t["rows"]["sizes"] * (len(a) // len(t["rows"]["sizes"])))
    assert len({j for _, j in a}) == len(a)


def test_samples_whole_table_keep_each_key_set():
    t = json.loads((HERE / "traffic" / "table-pairs.json").read_text())
    p = generator.plan(t, 1000, 3)
    assert sorted(j for _, j in generator.samples(t, p, 10.0, 3)) == [0, 1]
