"""The one traffic generator: a traffic file's parameters and a seed give
the plan of calls a run cycles through, and the answers the check keeps.

A traffic file (``sortbench/traffic/<name>.json``) holds:

  call           the port's public call the cell runs: the call file
                 ``sortbench/calls/<call>.py`` (``sort_pairs``, ``argsort``;
                 a later call is a new file there), which the harness loads
  payloads       the table's columns that ride along with the keys
  rows           "table" (each call sorts the whole table),
                 {"sizes": [n, ...], "each": K}: every listed size K times
                 in a plan, or
                 {"log_uniform": [lo, hi], "sizes": K}: K sizes at the
                 quantiles of a log-uniform law over [lo, hi], each once;
                 a plan takes its sizes in an order drawn from the seed
  offset         "uniform": each call's slice starts at an offset drawn
                 from the seed; "aligned": at a multiple of its own size
                 drawn from the seed, so the table is cut into partitions
                 of that size (default: 0)
  source         where the mix comes from (not read here)
  key_sets       how many key columns the pool holds; call i reads set
                 i mod key_sets
  in_flight      calls the host lets run at once (the loop waits for call
                 i-1 before it issues call i+1 when this is 2)
  check_answers  how many answers of the window the check keeps
  trace_calls    calls in the profiled stretch of a traced run

Every seed gets the same sizes, so a seed changes the order and the
offsets, not the amount of work. No cell runs log-uniform sizes or uniform
offsets yet; they are here so that a mix across the 2^23 route crossover
(PERF.md, Open questions) is a data file alone.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SAMPLE_SPAN = (0.05, 0.9)  # share of the window in which the kept answers lie


@dataclasses.dataclass(frozen=True)
class Call:
    key_set: int
    offset: int
    rows: int


def sizes(traffic: dict, table_rows: int) -> list[int]:
    """The sizes of one plan, before they are shuffled."""
    rows = traffic["rows"]
    if rows == "table":
        return [table_rows]
    if "each" in rows:
        listed = [int(n) for n in rows["sizes"]]
        if not listed or not all(1 <= n <= table_rows for n in listed) or int(rows["each"]) < 1:
            raise ValueError(f"bad rows {rows} for a table of {table_rows}")
        return [n for n in listed for _ in range(int(rows["each"]))]
    lo, hi = rows["log_uniform"]
    k = int(rows["sizes"])
    if not 1 <= lo <= hi <= table_rows or k < 1:
        raise ValueError(f"bad rows {rows} for a table of {table_rows}")
    a, b = math.log2(lo), math.log2(hi)
    return [int(round(2 ** (a + (b - a) * (i + 0.5) / k))) for i in range(k)]


def plan(traffic: dict, table_rows: int, seed: int) -> list[Call]:
    """The calls of one cycle of the plan, in order."""
    rng = np.random.default_rng([seed, 1])
    rows = sizes(traffic, table_rows)
    if len(rows) > 1:
        rows = [rows[i] for i in rng.permutation(len(rows))]
    key_sets = int(traffic.get("key_sets", 1))
    n_calls = max(len(rows), key_sets)
    calls = []
    for i in range(n_calls):
        n = rows[i % len(rows)]
        offset = 0
        where = traffic.get("offset", "zero")
        if where == "uniform":
            offset = int(rng.integers(0, table_rows - n + 1))
        elif where == "aligned":
            offset = n * int(rng.integers(0, table_rows // n))
        elif where != "zero":
            raise ValueError(f"unknown offset {where!r}")
        calls.append(Call(i % key_sets, offset, n))
    return calls


def samples(traffic: dict, plan: list, seconds: float, seed: int) -> list[tuple]:
    """``(seconds into the window, plan index)`` of each answer the check
    keeps: the answer of the first call of that plan entry issued at or
    after that time. The times are drawn from the seed; the entries are
    those at evenly spaced ranks of the plan's sizes, so every seed keeps
    answers of the same sizes (and the memory they hold is the same),
    paired with the times in an order drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    n = int(traffic["check_answers"])
    lo, hi = SAMPLE_SPAN
    times = sorted(float(t) for t in rng.uniform(lo * seconds, hi * seconds, n))
    by_size = sorted(range(len(plan)), key=lambda i: (plan[i].rows, i))
    entries = [by_size[int((k + 0.5) * len(plan) / n)] for k in range(n)]
    return list(zip(times, (entries[i] for i in rng.permutation(n))))
