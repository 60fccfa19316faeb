"""Normal keys: ``{"dtype": "float32", "distribution": "normal", "mean": m,
"std": s}`` draws each key as ``randn x s + m`` in float32 on the table's
generator: the law a sampler's logits are given when no model makes them.
The scale moves only which exponent bytes the keys hold."""

import torch


def make(n, key, device, gen):
    if key["dtype"] != "float32":
        raise ValueError(f"normal keys are float32, got {key['dtype']}")
    out = torch.randn(n, dtype=torch.float32, device=device, generator=gen)
    return out.mul_(float(key["std"])).add_(float(key["mean"]))
