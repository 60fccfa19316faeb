"""The share, in %, of the key-order kernel's device time in the profiled
stretch that its least traffic would take at the card's peak bandwidth.

The kernel (``key_order``, ``csrc/keyorder.cu``) maps the keys to the order
the sort runs in and, after the sort, maps them back: each direction reads
each key once and writes it once, 2 x key bytes a row. A call that returns
the sorted keys runs both directions (32 B a row for float64 keys);
``argsort`` returns positions, so it runs the first alone. Its time is the
summed device time of the stretch's operations whose name holds
``key_order``; a program without that kernel gives nothing. The peak is the
card's entry in ``sortbench/peaks.json``.
"""

KERNEL = "key_order"
WIDTH = {"uint32": 4, "int32": 4, "float32": 4, "uint64": 8, "int64": 8, "float64": 8}
ENCODE_ONLY = ("argsort",)  # calls that do not return the keys: no decode


def directions(traffic) -> int:
    return 1 if traffic["call"] in ENCODE_ONLY else 2


def read(run):
    t = run.trace
    peak = run.peaks.get(run.device_kind, {}).get("hbm_bytes_per_s")
    if t is None or not peak:
        return None
    seconds = sum(s for name, s in t.device_ops if KERNEL in name)
    if seconds <= 0:
        return None
    least_s = directions(run.traffic) * 2 * WIDTH[run.config["key"]["dtype"]] * t.rows / peak
    return 100.0 * least_s / seconds
