"""The call files (``sortbench/calls/<call>.py``): each reference is the
plain answer of its call, the program agrees with it on the CPU, and the
comparison rejects the control and an answer of another dtype."""

import pytest
import torch

from sortbench import harness, reference

CALLS = ["argsort", "sort_pairs"]


def tied_keys(n, seed, dtype=torch.uint32):
    """``n`` keys from 64 values, so most rows tie."""
    g = torch.Generator().manual_seed(seed)
    wide = {torch.uint32: torch.int32, torch.uint64: torch.int64}[dtype]
    k = torch.randint(0, 64, (n,), generator=g, dtype=wide) * 0x01010101 - (1 << 30)
    return k.view(dtype)


def test_argsort_reference_is_stable_sort_indices():
    keys = tied_keys(5000, 1)
    perm, rest = harness.load_call("argsort").reference(keys, ())
    assert rest == () and perm.dtype == torch.uint32 and perm.shape == keys.shape
    want = torch.sort(keys.view(torch.int32).long() & 0xFFFFFFFF, stable=True).indices
    assert torch.equal(perm.view(torch.int32).long(), want)


def test_argsort_reference_rejects_reversed_ties():
    keys = tied_keys(5000, 2)
    call = harness.load_call("argsort")
    ref, _ = call.reference(keys, ())
    control, _ = harness.control(call)(keys, ())
    assert sorted(control.view(torch.int32).tolist()) == list(range(5000))
    assert reference.mismatched_rows(control, (), ref, ()) > 4000


def test_argsort_answer_of_another_dtype_fails_every_row():
    keys = tied_keys(1000, 3)
    ref, _ = harness.load_call("argsort").reference(keys, ())
    as_int64 = ref.view(torch.int32).long()
    assert reference.mismatched_rows(as_int64, (), ref, ()) == 1000
    assert reference.mismatched_rows(ref[:-1], (), ref, ()) == 1000


def test_argsort_reference_takes_no_payload():
    with pytest.raises(ValueError):
        harness.load_call("argsort").reference(tied_keys(8, 4), (tied_keys(8, 5),))


def test_sort_pairs_reference_is_the_plain_sort():
    keys, vals = tied_keys(3000, 6, torch.uint64), (tied_keys(3000, 7),)
    call = harness.load_call("sort_pairs")
    for ties in (False, True):
        got = call.reference(keys, vals, reverse_ties=ties)
        want = reference.sort_pairs(keys, vals, reverse_ties=ties)
        assert reference.mismatched_rows(*got, *want) == 0


@pytest.mark.parametrize("name", CALLS)
@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64], ids=str)
def test_program_agrees_with_reference(name, dtype):
    keys = tied_keys(1 << 12, 8, dtype)
    payloads = () if name == "argsort" else (tied_keys(1 << 12, 9),)
    call = harness.load_call(name)
    out = call.program()(keys, payloads)
    assert reference.mismatched_rows(*out, *call.reference(keys, payloads)) == 0


def test_program_sort_is_the_sort_pairs_call():
    keys, vals = tied_keys(2000, 10), (tied_keys(2000, 11),)
    out = harness.program_sort()(keys, vals)
    assert reference.mismatched_rows(*out, *reference.sort_pairs(keys, vals)) == 0


def test_unknown_call_is_refused():
    with pytest.raises(FileNotFoundError):
        harness.load_call("no_such_call")
