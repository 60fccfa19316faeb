"""The share, in %, of the row sort kernels' device time in the profiled
stretch that the least traffic of the stretch's sorts would take at the
card's peak bandwidth.

The least traffic of a sort reads each key and payload byte once and writes
it once: 2 x (key bytes + payload bytes) a row of the table, 16 B for a
float32 logit with its int32 token id, counted as ``kernels.sort_roofline``
counts it, so it reads the same work whatever implements the rows. The time
is the summed device time of the operations whose names hold
``_rows_kernel``: the row-segmented onesweep's histogram and passes
(``digit_histograms_rows_kernel``, ``onesweep_rows_kernel``,
``csrc/onesweep.cu``), and no other kernel's. A program without them gives
nothing. The peak is the card's entry in ``sortbench/peaks.json``.
"""

KERNEL = "_rows_kernel"
WIDTH = {"uint32": 4, "int32": 4, "float32": 4, "uint64": 8, "int64": 8, "float64": 8}


def row_bytes(config, traffic):
    cols = config["columns"]
    return WIDTH[config["key"]["dtype"]] + sum(WIDTH[cols[p]] for p in traffic["payloads"])


def read(run):
    t = run.trace
    peak = run.peaks.get(run.device_kind, {}).get("hbm_bytes_per_s")
    if t is None or not peak:
        return None
    seconds = sum(s for name, s in t.device_ops if KERNEL in name)
    if seconds <= 0:
        return None
    least_s = 2 * t.rows * row_bytes(run.config, run.traffic) / peak
    return 100.0 * least_s / seconds
