"""A module fixture the port's test files share: run torch on one thread.

The plain versions make thousands of calls on small tensors.  With torch's
intra-op pool at 8 threads on an 8-core CPU, some of those calls (sin/cos,
advanced indexing) took about 3 ms in place of 40 us, and under
``pytest -n 6`` the pool's waiting threads took cores from the other test
processes.  A test file uses it with

    from torch_threads import one_torch_thread  # noqa: F401

(pytest finds a fixture imported into the module).  Not a test module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
