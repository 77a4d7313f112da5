"""A fixture that runs a test module's torch work on one thread.

The port's CPU tests are thousands of small ops. Under the suite's
parallel workers every core is busy, and torch's default intra-op pool
(one thread a core) then waits at each op's barrier for threads that get
no core: a test of under a second alone took minutes. One thread runs
the same ops without the pool. Import the fixture into a test module to
apply it there (it is autouse)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
