"""The call ``sort_pairs_desc``: the table's keys sorted in descending
order with the payload columns the traffic names, rows of equal keys in
input order, on the port's default route (an ``ORDER BY key DESC``).

``program()`` is the port's public ``sort_pairs(..., descending=True)``;
``reference`` is plain torch that brings its own key order: each key of 4
or 8 bytes mapped to the unsigned int of its place in IEEE-754 total order
(floats ``where(bits < 0, ~bits, bits ^ sign)``, so ``-0.0`` sorts below
``+0.0`` and a NaN by its sign bit; signed ints with the sign bit flipped;
unsigned ints as they are), complemented, then the stable permutation of
``sortbench/reference.py``. Both give ``(sorted keys, tuple of payloads
moved with them)``. ``reverse_ties=True`` is the control."""

import torch

from sortbench import reference as plain

UNSIGNED = {4: torch.uint32, 8: torch.uint64}


def program():
    import vkradixsort_tpu_torch as vk

    def sort(keys, payloads):
        if len(payloads) == 1:
            out_k, out_v = vk.sort_pairs(keys, payloads[0], descending=True)
            return out_k, (out_v,)
        out_k, out_vs = vk.sort_pairs(keys, tuple(payloads), descending=True)
        return out_k, tuple(out_vs)

    return sort


def total_order(keys: torch.Tensor) -> torch.Tensor:
    """Unsigned ints whose ascending order is the keys' total order."""
    size = keys.element_size()
    if size not in UNSIGNED:
        raise TypeError(f"the reference orders keys of 4 or 8 bytes, got {keys.dtype}")
    b = plain.bits(keys)
    sign = -(1 << (8 * size - 1))
    if keys.dtype.is_floating_point:
        b = torch.where(b < 0, ~b, b ^ sign)
    elif keys.dtype.is_signed:
        b = b ^ sign
    return b.view(UNSIGNED[size])


def reference(keys, payloads, reverse_ties=False):
    descending = (~plain.bits(total_order(keys))).view(UNSIGNED[keys.element_size()])
    perm = plain.permutation(descending, reverse_ties)
    return plain.take(keys, perm), tuple(plain.take(p, perm) for p in payloads)
