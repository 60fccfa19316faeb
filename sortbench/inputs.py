"""The table a cell sorts, made on its device from the seed.

One ``torch.Generator`` on the device, seeded with the run's seed, draws
the key sets first, in order, then the configuration's random columns, so
the same seed gives the same table on the same kind of device. Nothing is
drawn on the host: a 1e8-row table takes milliseconds on the card.

Key distributions (the configuration's ``key``):

  uniform  every value of the key's width equally likely
  zipf     numpy's Zipf sampler (``random_zipf`` in numpy's
           ``distributions.c``, Devroye's rejection method) with exponent
           ``a``, in float64 on the device, reduced mod 2^64 - 1 as
           ``utils/fixtures.make_keys(..., "zipf")`` does: the law of
           numpy's draws, not their stream
  <name>   any other law is the file ``sortbench/keys/<name>.py``, whose
           ``make(n, key, device, gen)`` draws the ``n`` keys of one key
           set on the table's generator; a later law is a new file there
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import torch

INT_OF = {"uint32": torch.int32, "int32": torch.int32, "uint64": torch.int64,
          "int64": torch.int64}
UNSIGNED = {"uint32": torch.uint32, "uint64": torch.uint64}
_INT63_MAX = float(2**63 - 1)  # rounds to 2^63
ZIPF_CHUNK = 1 << 24  # candidates drawn at once: bounds the set-up's scratch memory
KEYS = pathlib.Path(__file__).resolve().parent / "keys"


@dataclasses.dataclass
class Table:
    keys: list  # one key column per key set, unsigned
    columns: dict  # name -> column

    @property
    def rows(self) -> int:
        return self.keys[0].shape[0]


def full_range(n: int, dtype: str, device, gen) -> torch.Tensor:
    idt = INT_OF[dtype]
    bits = torch.empty(n, dtype=idt, device=device).random_(
        torch.iinfo(idt).min, None, generator=gen)
    return bits.view(UNSIGNED[dtype]) if dtype in UNSIGNED else bits


def zipf(n: int, a: float, device, gen) -> torch.Tensor:
    """``n`` int64 draws of numpy's Zipf law with exponent ``a`` > 1."""
    am1 = a - 1.0
    b = 2.0**am1
    umin = _INT63_MAX ** -am1
    out = torch.empty(n, dtype=torch.int64, device=device)
    filled = 0
    while filled < n:
        m = min(ZIPF_CHUNK, int((n - filled) * 1.25) + 1024)
        u01 = torch.rand(m, dtype=torch.float64, device=device, generator=gen)
        v = torch.rand(m, dtype=torch.float64, device=device, generator=gen)
        u = u01 * umin + (1.0 - u01)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x < _INT63_MAX) & (x >= 1.0) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        got = x[ok][: n - filled]
        out[filled:filled + got.shape[0]] = got.to(torch.int64)
        filled += got.shape[0]
    return out


def make_keys(n: int, key: dict, device, gen) -> torch.Tensor:
    dtype, dist = key["dtype"], key["distribution"]
    if dist == "uniform":
        return full_range(n, dtype, device, gen)
    if dist == "zipf":
        if dtype != "uint64":
            raise ValueError("zipf keys are uint64 (mod 2^64 - 1)")
        # draws lie in [1, 2^63), so the reduction mod 2^64 - 1 keeps them
        return zipf(n, float(key["a"]), device, gen).view(torch.uint64)
    return key_law(dist)(n, key, device, gen)


def key_law(name: str):
    """The ``make`` of ``sortbench/keys/<name>.py``."""
    path = KEYS / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown key distribution {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"sortbench_keys.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def make_column(name: str, dtype: str, n: int, device, gen) -> torch.Tensor:
    if name == "row_id":  # the row's index in the table
        if dtype != "uint32":
            raise ValueError("row_id is uint32")
        return torch.arange(n, dtype=torch.int32, device=device).view(torch.uint32)
    if dtype == "float32":
        return torch.rand(n, dtype=torch.float32, device=device, generator=gen)
    return full_range(n, dtype, device, gen)


def make_table(config: dict, traffic: dict, device, seed: int) -> Table:
    """The key sets of ``traffic`` and the columns it carries, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = int(config["rows"])
    keys = [make_keys(n, config["key"], device, gen)
            for _ in range(int(traffic.get("key_sets", 1)))]
    columns = {}
    for name, dtype in config["columns"].items():  # config order: draws do not depend on traffic
        col = make_column(name, dtype, n, device, gen)
        if name in traffic["payloads"]:
            columns[name] = col
        else:
            del col
    return Table(keys, columns)
