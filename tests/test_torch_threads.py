"""One torch thread for each port test module.

The suite runs in six worker processes on an eight-core machine.  With
torch's default of one intra-op thread per core, every parallel region of
a worker waits for threads that the other workers keep off the cores: a
float64 ``gradcheck`` of ``flash_attention`` took 95 s beside two busy
test processes and 3 s with one thread (2.4 s alone either way).  Each
``tests/test_torch_*.py`` module imports :func:`one_torch_thread`, which
runs the module on one thread and gives the worker its thread count back
afterwards.  Results do not depend on it: every comparison in a module
runs under the same setting.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def single_thread():
    """Torch's intra-op pool at one thread inside, the caller's count
    restored on the way out (an exception included)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with single_thread():
        yield


def test_single_thread_restores_the_count():
    """Inside: one thread; after the block, the count it was entered with
    (set to 3 here, not this module's 1), whether the block returns or
    raises."""
    assert torch.get_num_threads() == 1
    torch.set_num_threads(3)
    try:
        with single_thread():
            assert torch.get_num_threads() == 1
        assert torch.get_num_threads() == 3
        with pytest.raises(RuntimeError), single_thread():
            raise RuntimeError
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(1)
