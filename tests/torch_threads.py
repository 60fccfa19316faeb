"""The port's CPU test files run torch on one intra-op thread.

Their shapes are small, and under the test runner's parallel workers more
threads mostly wait on each other and slow the other workers' files. A test
file takes the fixture by importing it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
