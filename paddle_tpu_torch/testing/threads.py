"""One intra-op thread for the port's CPU tests.

Their tensors are tiny, and the test workers share the host's cores: waking
torch's intra-op pool for each op then costs far more than the op (an 8 x 8
``tril`` ~100x more).  A test module that imports ``one_intra_op_thread``
runs its torch ops on one thread and gives the pool back after its last
test::

    from paddle_tpu_torch.testing.threads import \\
        one_intra_op_thread  # noqa: F401  (autouse)
"""
from __future__ import annotations

import contextlib

import pytest
import torch

__all__ = ["intra_op_threads", "one_intra_op_thread"]


@contextlib.contextmanager
def intra_op_threads(n: int):
    """Run the block with ``n`` intra-op threads, then restore the count."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Autouse in the module that imports it: one intra-op thread for the
    module's tests."""
    with intra_op_threads(1):
        yield
