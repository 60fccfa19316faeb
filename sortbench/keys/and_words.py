"""Low-entropy keys: each key the bitwise AND of ``words`` uniform draws of
its width (``{"dtype": "uint32"|"uint64", "distribution": "and_words",
"words": k}``), so every bit is 1 with probability 2^-k. This is the
entropy reduction of CCCL's radix sort benchmarks
(``cub/benchmarks/bench/radix_sort/pairs.cu``): k = 5 gives its entropy
point 0.201 = H(1/32)."""

from sortbench import inputs


def make(n, key, device, gen):
    k = int(key["words"])
    if k < 1:
        raise ValueError(f"and_words needs words >= 1, got {k}")
    dtype = key["dtype"]
    signed = inputs.INT_OF[dtype]  # torch ANDs the signed view on every device
    out = inputs.full_range(n, dtype, device, gen).view(signed)
    for _ in range(k - 1):
        out &= inputs.full_range(n, dtype, device, gen).view(signed)
    return out.view(inputs.UNSIGNED[dtype])
