"""The call ``sort_pairs``: the table's keys sorted with the payload columns
the traffic names, stably, on the port's default route.

``program()`` is the port's public ``sort_pairs``; ``reference`` is the
plain answer (``sortbench/reference.py``), both as ``(sorted keys, tuple
of payloads moved with them)``. ``reverse_ties=True`` is the control."""

from sortbench import reference as plain


def program():
    import vkradixsort_tpu_torch as vk

    def sort(keys, payloads):
        if len(payloads) == 1:
            out_k, out_v = vk.sort_pairs(keys, payloads[0])
            return out_k, (out_v,)
        out_k, out_vs = vk.sort_pairs(keys, tuple(payloads))
        return out_k, tuple(out_vs)

    return sort


def reference(keys, payloads, reverse_ties=False):
    return plain.sort_pairs(keys, payloads, reverse_ties)
