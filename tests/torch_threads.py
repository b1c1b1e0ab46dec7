"""A fixture shared by the port's CPU tests: torch on one intra-op thread
while a test module runs. Their ops are small, and beside other test
workers more threads only contend (an OpenMP ``index_add_`` backward took
0.5 s on eight threads, 0.6 ms on one; a CPU step that takes milliseconds
alone must stay under the stall test's 131 ms bucket). Import it into a
test module to apply it there."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
