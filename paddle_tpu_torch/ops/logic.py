"""Comparison and logic helpers beyond the elementwise tables
(counterpart of ``paddle_tpu/ops/logic.py``)."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from .registry import register_op
from ._helpers import as_value, promote, targ, wrap


@register_op("allclose", category="logic", tensor_method=True)
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op("allclose", lambda a, b: torch.isclose(
        *promote(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan).all(),
        (x, targ(y)))


@register_op("isclose", category="logic", tensor_method=True)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op("isclose", lambda a, b: torch.isclose(
        *promote(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan),
        (x, targ(y)))


@register_op("equal_all", category="logic", tensor_method=True)
def equal_all(x, y, name=None):
    def fn(a, b):
        same = a.shape == b.shape and bool(torch.equal(*promote(a, b)))
        return torch.tensor(same, device=a.device)
    return apply_op("equal_all", fn, (x, targ(y)))


@register_op("is_empty", category="logic", tensor_method=True)
def is_empty(x, name=None):
    v = as_value(x)
    return wrap(torch.tensor(v.numel() == 0, device=v.device))


@register_op("is_tensor", category="logic")
def is_tensor(x):
    return isinstance(x, Tensor)


@register_op("in_dynamic_mode", category="logic")
def in_dynamic_mode():
    """True: the port has no static mode yet."""
    return True
