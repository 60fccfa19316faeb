"""How pytest-xdist splits the test run into work units.

The test settings proper (the JAX CPU mesh, the ``rng`` fixture) are in
``tests/conftest.py``.
"""

import pytest

# Each test of this file runs the JAX reference's shard_map body eagerly,
# one primitive at a time (20-65 s a test, two retry tests 250-460 s), and
# takes only function-scoped fixtures; the file predates the port and is not
# edited. As one work unit it would keep a single worker busy for about 20
# minutes.
SPLIT_BY_TEST = "tests/test_distributed.py"


def _in_split_file(scope):
    return scope.split("::", 1)[0] == SPLIT_BY_TEST


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """Under ``--dist loadfile``, make each test of ``SPLIT_BY_TEST`` a work
    unit of its own, sent out ahead of the other files, which stay whole;
    otherwise leave the choice to xdist."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return nodeid if _in_split_file(nodeid) else super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            # xdist's order by test count would put the one-test units last.
            # They are about half of the run's work, and a worker is sent the
            # test after the one it runs before it starts it, so long tests at
            # the end of the queue keep one worker busy after the others stop.
            for scope in [s for s in self.workqueue if _in_split_file(s)][::-1]:
                self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return SplitScheduling(config, log)
