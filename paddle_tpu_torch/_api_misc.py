"""Small top-level names of the paddle API (counterparts of the tail of
``paddle_tpu/__init__.py``): ``shape``, ``tolist``, ``check_shape``,
``is_grad_enabled_``, ``disable_signal_handler`` and ``LazyGuard``."""
from __future__ import annotations

import torch

from .core.tensor import Tensor


def shape(x):
    """``paddle.shape``: the shape as an int64 tensor."""
    dims = x.shape if isinstance(x, Tensor) else list(getattr(x, "shape", x))
    dev = x._value.device if isinstance(x, Tensor) else None
    return Tensor._from_value(torch.tensor(list(dims), dtype=torch.int64,
                                           device=dev))


def tolist(x):
    return x.tolist() if isinstance(x, Tensor) else list(x)


def check_shape(x):
    for s in (x.shape if isinstance(x, Tensor) else x):
        if s is not None and s < -1:
            raise ValueError("invalid dim %s in shape" % s)
    return True


def is_grad_enabled_():
    return torch.is_grad_enabled()


def disable_signal_handler():
    """No custom signal handlers are installed: nothing to disable."""


class LazyGuard:
    """``paddle.LazyGuard``: a scope marker; layers built in it have their
    parameters at once, as in the reference."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
