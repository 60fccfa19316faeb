"""The control of the check: the reference of the cell's call
(``sortbench/calls/<call>.py``) in the program's place, with rows of equal
keys in reverse input order, which breaks the stability the configurations
guarantee. The check has to call every such run incorrect.

    python3 sortbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3

runs it on the card at the cell's own size, one seed after another in one
process, and prints one JSON line a seed (the numbers compared, with their
limits) and a last line ``{"control_rejected": ...}``. The benchmark's own
runs never run it.
"""

import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    import argparse

    import torch

    from sortbench import harness

    p = argparse.ArgumentParser(prog="python3 sortbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("[control] needs a CUDA device")
        return 2
    cell = harness.find_cell(args.workload)
    control = harness.control(harness.load_call(cell.traffic["call"]))
    rejected = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", time.perf_counter(),
                             sort_fn=control)
        torch.cuda.empty_cache()
        rejected.append(not r["correct"])
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
    print(json.dumps({"control_rejected": all(rejected), "runs": len(rejected)}), flush=True)
    return 0 if all(rejected) else 1


if __name__ == "__main__":
    sys.exit(main())
