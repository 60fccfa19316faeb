"""The share, in %, of the summed device-operation time of the profiled
stretch that the least traffic of its sorts would take at the card's peak
bandwidth.

The least traffic of a sort reads each key and payload byte once and writes
it once: 2 x (key bytes + payload bytes) a row, so 16 B for a u32 key with a
u32 row id, 24 B for a u64 key with one, 32 B for a u32 key with three
4-byte columns. An argsort carries no payload: 8 B a row for u32 keys, which
is its least traffic too (read each 4-byte key, write its 4-byte position).
It counts the same work whatever implements the sort, so a
share above 100% means the time left out part of the work. The peak is the
card's entry in ``sortbench/peaks.json``; a card not listed gives nothing.
"""

WIDTH = {"uint32": 4, "int32": 4, "float32": 4, "uint64": 8, "int64": 8, "float64": 8}


def row_bytes(config, traffic):
    cols = config["columns"]
    return WIDTH[config["key"]["dtype"]] + sum(WIDTH[cols[p]] for p in traffic["payloads"])


def read(run):
    t = run.trace
    peak = run.peaks.get(run.device_kind, {}).get("hbm_bytes_per_s")
    if t is None or not peak or t.device_op_us <= 0:
        return None
    least_s = 2 * t.rows * row_bytes(run.config, run.traffic) / peak
    return 100.0 * least_s / (t.device_op_us * 1e-6)
