"""A module-scoped fixture that runs a test file's torch code on one
intra-op thread, for the files that hold the port against the JAX package
on the CPU.

The tier-1 suite runs six workers on the same cores, and torch's thread
pools oversubscribe them: six copies of tests/test_torch_accuracy_gate.py
at once took 83 s at one thread and 111 s at two, and that file took 521 s
at torch's default eight threads in a suite run. Import it into a test
module, ``from _torch_threads import one_thread  # noqa: F401``, to use it
there; the thread count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
