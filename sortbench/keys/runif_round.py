"""Rounded uniform doubles: ``{"dtype": "float64", "distribution":
"runif_round", "max": m, "digits": d}`` draws each key as ``round(U * m,
d)``, U uniform on [0, 1) in float64 on the table's generator: the law of
R's ``round(runif(N, max=m), d)``, which db-benchmark's
``_data/groupby-datagen.R`` uses for its measure column ``v3`` (m = 100,
d = 6), not R's stream of draws. Every key is k / 10^d for a whole k in
[0, m x 10^d], the double nearest that quotient."""

import torch


def make(n, key, device, gen):
    if key["dtype"] != "float64":
        raise ValueError(f"runif_round keys are float64, got {key['dtype']}")
    scale = 10.0 ** int(key["digits"])
    u = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
    return torch.round(u * (float(key["max"]) * scale)) / scale
