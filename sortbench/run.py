"""The benchmark of vkradixsort_tpu_torch: one run of one cell on one card.

    python3 sortbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's inputs come from the seed, set-up
warms up the cell's own calls, the window runs a closed loop for
``--seconds``, and the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks``, last, holds each number compared with its limit,
which also close standard error. Without a card, or with fewer cards than
the cell asks for, or with JAX or the JAX package loaded, it prints no
result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)  # the folder's own modules are imported as sortbench.<name>
sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed paths inside the checkout (the port builds
# its own kernels under build/kernels; these catch any torch or Triton build)
CACHE = ROOT / "build" / "sortbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 sortbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from sortbench import harness

    torch.set_num_threads(1)
    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"[sortbench] {args.workload} needs {cell.chips} CUDA device(s); "
                    f"this machine has {avail}: no result")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"[sortbench] modules the benchmark may not load are loaded: {found}; "
                    "no result")
        return 3
    harness.log(f"[sortbench] correct: {result['correct']}")
    for name, c in result["checks"].items():
        harness.log(f"[sortbench] check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
