"""The call ``argsort``: the stable permutation that sorts the table's
keys, on the port's default route; the traffic carries no payload.

``program()`` is the port's public ``argsort``, and ``reference`` the plain
permutation (``sortbench/reference.permutation``), both as ``(permutation,
())``. The port returns uint32 positions below 2^32 rows, so the reference
does too, and the comparison is bit for bit: another dtype or shape fails
every row. ``reverse_ties=True`` is the control."""

import torch

from sortbench import reference as plain


def program():
    import vkradixsort_tpu_torch as vk

    def argsort(keys, payloads):
        return vk.argsort(keys), ()

    return argsort


def reference(keys, payloads, reverse_ties=False):
    if payloads:
        raise ValueError("argsort carries no payload")
    # the low 32 bits of the int64 permutation (from 2^32 rows on the port
    # returns uint64, and the dtypes differ)
    perm = plain.permutation(keys, reverse_ties).to(torch.int32)
    return perm.view(torch.uint32), ()
