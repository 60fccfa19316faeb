"""The share, in %, of the column gather's device time in the profiled
stretch that its least traffic would take at the card's peak bandwidth.

The gather (``gather_columns``, ``csrc/gather.cu``) moves every payload
column through the sorted u32 positions: its least traffic reads each
position once and each payload byte once and writes each payload byte once,
4 + 2 x (payload bytes) a row, so 76 B for the five lineitem columns. Its
time is the summed device time of the stretch's operations whose name holds
``gather_columns``; a program without that kernel gives nothing. The peak
is the card's entry in ``sortbench/peaks.json``.
"""

KERNEL = "gather_columns"
WIDTH = {"uint8": 1, "int8": 1, "int16": 2, "uint32": 4, "int32": 4, "float32": 4, "uint64": 8,
         "int64": 8, "float64": 8}
POSITION_BYTES = 4


def payload_bytes(config, traffic):
    cols = config["columns"]
    return sum(WIDTH[cols[p]] for p in traffic["payloads"])


def read(run):
    t = run.trace
    peak = run.peaks.get(run.device_kind, {}).get("hbm_bytes_per_s")
    if t is None or not peak:
        return None
    seconds = sum(s for name, s in t.device_ops if KERNEL in name)
    if seconds <= 0:
        return None
    least_s = t.rows * (POSITION_BYTES + 2 * payload_bytes(run.config, run.traffic)) / peak
    return 100.0 * least_s / seconds
