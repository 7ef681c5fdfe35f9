"""One PyTorch intra-op thread in every process that collects the port's
tests.

The tier-1 command runs the suite in six pytest-xdist workers, and each
worker imports every test module while it collects, before it runs any
test.  PyTorch's default is one OpenMP thread per core, and threads
that wait spin: six workers of eight threads each on an 8-core host ran
six copies of ``tests/test_torch_traffic.py``'s two CNN replays in 753 s
at the default against 45 s at one thread (33 s for one copy alone at
either setting).  Importing this module sets one thread for the worker;
the test states that the setting holds where the suite runs.  A file run
alone, without this module, keeps PyTorch's default.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)


def test_one_intra_op_thread():
    assert torch.get_num_threads() == 1
