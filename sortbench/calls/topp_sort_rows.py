"""The call ``topp_sort_rows``: a top-p sampler's sort. The table is the
logits of one decode step, ``[requests, ROW]`` float32 laid out row after
row, and every row is sorted ascending and stably with its token ids, as
vLLM's ``apply_top_k_top_p`` (``vllm/v1/sample/ops/topk_topp_sampler.py``)
does with ``logits.sort(dim=-1, descending=False)`` before its softmax and
cumulative sum.

``ROW`` is DeepSeek-V3's vocabulary, ``vocab_size`` 129,280 in
https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json: the
sampler sees the whole vocabulary, since the vocabulary-parallel logits are
gathered before sampling.

``program()`` views the keys and the one payload as ``(-1, ROW)`` and
calls the port's public ``sort_pairs`` on the 2-D tensors (its default
route, by row width); ``reference`` is plain torch that brings its own key
order: each float32 key mapped to the unsigned int of its place in IEEE-754
total order (``where(bits < 0, ~bits, bits ^ sign)``: ``-0.0`` below
``+0.0``, a NaN by its sign bit), widened to the u64 composite ``row << 32 |
order``, then the stable permutation of ``sortbench/reference.py``. Both
give ``(sorted keys, (sorted token ids,))`` flattened, and raise where the
table is not whole rows. ``reverse_ties=True`` is the control: ties in
reverse input order within each row."""

import torch

from sortbench import reference as plain

ROW = 129280


def _rows(n: int) -> int:
    if n % ROW:
        raise ValueError(f"topp_sort_rows sorts whole rows of {ROW}; got {n} keys")
    return n // ROW


def program():
    import vkradixsort_tpu_torch as vk

    def sort(keys, payloads):
        _rows(keys.shape[0])
        (token_ids,) = payloads
        out_k, out_v = vk.sort_pairs(keys.view(-1, ROW), token_ids.view(-1, ROW))
        return out_k.reshape(-1), (out_v.reshape(-1),)

    return sort


def total_order(keys: torch.Tensor) -> torch.Tensor:
    """int64 holding each float32 key's place in IEEE-754 total order, an
    unsigned 32-bit value."""
    if keys.dtype != torch.float32:
        raise TypeError(f"the reference orders float32 logits, got {keys.dtype}")
    b = plain.bits(keys)
    b = torch.where(b < 0, ~b, b ^ -(1 << 31))
    return b.to(torch.int64) & 0xFFFFFFFF


def reference(keys, payloads, reverse_ties=False):
    n = keys.shape[0]
    _rows(n)
    row = torch.arange(n, dtype=torch.int64, device=keys.device) // ROW
    composite = ((row << 32) | total_order(keys)).view(torch.uint64)
    del row
    perm = plain.permutation(composite, reverse_ties)
    del composite
    return plain.take(keys, perm), tuple(plain.take(p, perm) for p in payloads)
