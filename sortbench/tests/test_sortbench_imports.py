"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole), and nothing of the program in the reference."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vkradixsort_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference", "generator", "inputs", "trace"])
def test_yardstick_imports_nothing_of_the_program(name):
    tops = imported_tops(HERE / f"{name}.py")
    assert "vkradixsort_tpu_torch" not in tops and not tops & FORBIDDEN


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _loaded_after(
        "import sys, json; sys.path.insert(0, '.'); import sortbench.reference, sortbench.inputs, "
        "sortbench.generator, sortbench.trace; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "vkradixsort_tpu_torch" not in tops and not tops & FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a small size, through the program: the
    port is loaded, and no module whose top-level name is forbidden
    (``vkradixsort_tpu_torch`` is not ``vkradixsort_tpu``)."""
    code = (
        "import sys, json, time, dataclasses; sys.path.insert(0, '.');"
        "from sortbench import harness;"
        "c = harness.find_cell('u32-pairs-1e8');"
        "c = dataclasses.replace(c, config={**c.config, 'rows': 4096});"
        "r = harness.run_cell(c, 2**31 + 5, 0.2, False, 'cpu', time.perf_counter());"
        "assert r['correct'], r;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _loaded_after(code)
    assert "vkradixsort_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_run_refuses_without_a_card():
    """Without a card the command prints no result and exits non-zero."""
    r = subprocess.run([sys.executable, "sortbench/run.py", "--workload", "u32-pairs-1e8",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=240,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(ROOT / "build")})
    assert r.returncode != 0 and r.stdout.strip() == ""
