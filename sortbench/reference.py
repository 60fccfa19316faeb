"""The plain reference of a stable key-value sort, and the comparison that
decides ``correct``.

Plain PyTorch; it imports nothing of the program, and works every answer
out again from the inputs the benchmark handed to the program. The one
answer it gives: keys in ascending order of their unsigned value, and rows
with equal keys in their input order (stable), every payload moved with
its key.

How it gets there differs from the program's routes: 32-bit keys are
widened to unique 64-bit composites ``key * 2^32 + position``, so any sort
of them gives the stable order; 64-bit keys take one stable ``torch.sort``
of int64 (the program sorts them with its radix kernels). Comparisons are
of bit patterns, so a float payload compares exactly, NaN too.

``reverse_ties=True`` puts rows with equal keys in reverse input order: an
exact sort that breaks the configuration's guarantee of stability. It is
the control that the comparison has to reject.
"""

from __future__ import annotations

import torch

_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bits(x: torch.Tensor) -> torch.Tensor:
    """The same-width signed-int view of a tensor (torch implements
    compares and indexing for these on every device)."""
    return x.view(_BITS[x.element_size()])


def signed_order(keys: torch.Tensor) -> torch.Tensor:
    """Unsigned keys as same-width signed ints of the same order."""
    if keys.dtype == torch.uint32:
        return bits(keys) ^ -(1 << 31)
    if keys.dtype == torch.uint64:
        return bits(keys) ^ -(1 << 63)
    raise TypeError(f"the reference sorts uint32/uint64 keys, got {keys.dtype}")


def permutation(keys: torch.Tensor, reverse_ties: bool = False) -> torch.Tensor:
    """int64 ``perm`` with ``keys[perm]`` in order, equal keys in input
    order (or, with ``reverse_ties``, in reverse input order)."""
    n = keys.shape[0]
    s = signed_order(keys)
    if reverse_ties:
        s = s.flip(0)
    if keys.dtype == torch.uint32:
        pos = torch.arange(n, dtype=torch.int64, device=keys.device)
        composite = (s.to(torch.int64) << 32) | pos
        perm = torch.sort(composite).values & 0xFFFFFFFF
    else:
        perm = torch.sort(s, stable=True).indices
    return n - 1 - perm if reverse_ties else perm


def take(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return bits(x)[perm].view(x.dtype)


def sort_pairs(keys: torch.Tensor, payloads: tuple, reverse_ties: bool = False):
    """``(sorted keys, tuple of payloads moved with them)``."""
    perm = permutation(keys, reverse_ties)
    return take(keys, perm), tuple(take(p, perm) for p in payloads)


def mismatched_rows(out_keys, out_payloads, ref_keys, ref_payloads) -> int:
    """Rows of the answer at which the keys or any payload differ from the
    reference, bit for bit; every row when the shapes do not agree."""
    n = ref_keys.shape[0]
    outs = (out_keys, *out_payloads)
    refs = (ref_keys, *ref_payloads)
    if len(outs) != len(refs) or any(o.shape != r.shape or o.dtype != r.dtype
                                     for o, r in zip(outs, refs)):
        return n
    bad = torch.zeros(n, dtype=torch.bool, device=ref_keys.device)
    for o, r in zip(outs, refs):
        bad |= bits(o).to(r.device) != bits(r)
    return int(bad.sum())
