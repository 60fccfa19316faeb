"""The work units of the test run under ``--dist loadfile`` (the root
``conftest.py``): each test of ``tests/test_distributed.py`` is a unit of
its own and goes out ahead of the whole files, every other file is one
unit, and no other mode is touched. A guard reads
``tests/test_distributed.py`` and ``tests/conftest.py`` for anything that
would make its tests share a worker's state.
"""

import ast
import importlib.util
import pathlib
from types import SimpleNamespace

import pytest
from xdist.remote import Producer

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPLIT = "tests/test_distributed.py"


class _Config:
    """The settings a scheduler reads from pytest's config."""

    def __init__(self, dist, workers=6):
        self.values = {"dist": dist, "tx": [f"{workers}*popen"]}
        self.option = SimpleNamespace(loadscopereorder=True)

    def getvalue(self, name):
        return self.values[name]


class _Worker:
    """A worker as the scheduler sees it: it records the tests sent to it."""

    shutting_down = False

    def __init__(self):
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def loadfile_scheduler(pytestconfig):
    """The scheduler that pytest's hook chain picks for ``--dist loadfile``,
    as the controller asks for it."""
    return pytestconfig.hook.pytest_xdist_make_scheduler(
        config=_Config("loadfile"), log=Producer("sched", enabled=False)
    )


def test_the_split_file_is_the_one_named():
    assert _root_conftest().SPLIT_BY_TEST == SPLIT
    assert (ROOT / SPLIT).is_file()


@pytest.mark.parametrize(
    "nodeid",
    [
        f"{SPLIT}::test_sort_sharded_float",
        f"{SPLIT}::test_sort_sharded_u32[uniform-8192]",
    ],
)
def test_each_distributed_test_is_its_own_unit(loadfile_scheduler, nodeid):
    assert loadfile_scheduler._split_scope(nodeid) == nodeid


@pytest.mark.parametrize(
    "nodeid, unit",
    [
        ("tests/test_merge.py::test_x[1]", "tests/test_merge.py"),
        ("tests/test_multihost.py::test_y", "tests/test_multihost.py"),
        ("tests/test_distributed_more.py::test_z", "tests/test_distributed_more.py"),
        ("tests/test_torch_distributed.py::test_w[a-1]", "tests/test_torch_distributed.py"),
    ],
)
def test_other_files_stay_whole(loadfile_scheduler, nodeid, unit):
    assert loadfile_scheduler._split_scope(nodeid) == unit


def test_split_tests_are_sent_first(pytestconfig):
    """xdist orders units by test count, which would put the one-test units
    last; the split file's go out first, in collection order."""
    collection = [
        "tests/test_merge.py::test_a",
        "tests/test_merge.py::test_b[1]",
        "tests/test_merge.py::test_b[2]",
        f"{SPLIT}::test_x",
        "tests/test_tiled.py::test_c",
        f"{SPLIT}::test_y[1]",
    ]
    sched = pytestconfig.hook.pytest_xdist_make_scheduler(
        config=_Config("loadfile", workers=1), log=Producer("sched", enabled=False)
    )
    worker = _Worker()
    sched.add_node(worker)
    sched.add_node_collection(worker, collection)
    sched.schedule()
    assert worker.sent == [3, 5]
    for index in (3, 5, 0, 1, 2):
        sched.mark_test_complete(worker, index)
    assert worker.sent == [3, 5, 0, 1, 2, 4]
    assert worker.shutting_down


@pytest.mark.parametrize("dist", ["no", "load", "loadscope", "loadgroup", "worksteal", "each"])
def test_other_modes_are_left_to_xdist(dist):
    hook = _root_conftest().pytest_xdist_make_scheduler
    assert hook(config=_Config(dist), log=Producer("sched", enabled=False)) is None


def _is_fixture(node):
    target = node.func if isinstance(node, ast.Call) else node
    return (isinstance(target, ast.Attribute) and target.attr == "fixture") or (
        isinstance(target, ast.Name) and target.id == "fixture"
    )


@pytest.mark.parametrize("path", [SPLIT, "tests/conftest.py"])
def test_no_shared_state_behind_the_split(path):
    """A class, or a fixture of wider than function scope, would let the
    tests of ``SPLIT`` depend on sharing one worker."""
    tree = ast.parse((ROOT / path).read_text())
    assert not [n.name for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    scopes = [
        kw.value
        for n in ast.walk(tree)
        if isinstance(n, ast.Call) and _is_fixture(n)
        for kw in n.keywords
        if kw.arg == "scope"
    ]
    assert all(isinstance(s, ast.Constant) and s.value == "function" for s in scopes)


def _parametrized(fn):
    names = set()
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call) and getattr(dec.func, "attr", None) == "parametrize":
            arg = dec.args[0]
            items = [arg] if isinstance(arg, ast.Constant) else arg.elts
            for item in items:
                names.update(s.strip() for s in item.value.split(","))
    return names


def test_split_tests_take_only_function_fixtures():
    tree = ast.parse((ROOT / SPLIT).read_text())
    tests = [
        n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("test")
    ]
    assert tests
    used = set()
    for fn in tests:
        used |= {a.arg for a in fn.args.args} - _parametrized(fn)
    used |= {
        a.value
        for n in ast.walk(tree)
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "usefixtures"
        for a in n.args
    }
    assert used <= {"rng", "monkeypatch"}, used
