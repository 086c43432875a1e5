"""One PyTorch thread for each port test module on the CPU.

The tier-1 command runs the tests in six pytest-xdist workers on one
machine, and PyTorch gives each worker as many intra-op threads as the
machine has cores, so the workers together run several threads a core and
the small tensors of these tests spend their time waiting on one another.
On an 8-core machine, ``test_torch_variants_eval.py::
test_forward_cached_equals_live_for_every_variant`` took 3.6 s with one
thread and 325 s with eight, six copies of it running at once; the port's
CPU tests took 1587 test-seconds with one thread a worker against 3898
with eight (``-n 6``). Every CPU test file of the port imports
:func:`one_torch_thread`, an autouse module fixture: the module's tests run
with one intra-op thread, and the worker gets its own setting back after
them. The card's test files (``*_cuda.py``) keep PyTorch's default.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_a_port_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
