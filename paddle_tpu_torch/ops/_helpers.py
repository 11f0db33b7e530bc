"""Shared helpers for the API's op definitions (counterpart of
``paddle_tpu/ops/_helpers.py``)."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from .registry import register


def as_value(x) -> torch.Tensor:
    """A ``torch.Tensor`` with the reference's scalar defaults (Python
    floats float32, ints int64), made on the CPU; ``apply_op`` moves it
    beside its API operands."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    arr = _dt.default_cast(x)
    return torch.from_numpy(np.array(arr, copy=True))


def wrap(v) -> Tensor:
    return Tensor._from_value(v)


def targ(x):
    """An ``apply_op`` operand: an API tensor as it is (autograd sees the
    edge), anything else as a tensor with the reference's defaults."""
    return x if isinstance(x, Tensor) else as_value(x)


def promote(*vals):
    """Cast the tensors among ``vals`` to their common dtype on the
    reference's lattice (``dtypes.promote``); other values pass."""
    ts = [v for v in vals if isinstance(v, torch.Tensor)]
    if not ts:
        return vals
    rt = _dt.result_type(*(t.dtype for t in ts))
    return tuple(v.to(rt) if isinstance(v, torch.Tensor) and v.dtype != rt
                 else v for v in vals)


def inexact(v: torch.Tensor) -> torch.Tensor:
    """``v`` in the dtype an op that needs an inexact input computes in
    (``dtypes.to_inexact``)."""
    d = _dt.to_inexact(v.dtype)
    return v if v.dtype == d else v.to(d)


def def_unary(name: str, tfn: Callable, category="math", method=True,
              inplace=True, to_inexact=False, doc: str = ""):
    """A paddle-style unary elementwise op over ``tfn``; ``to_inexact``
    first takes an int or bool input to the float dtype the reference
    computes it in."""
    fn = (lambda v: tfn(inexact(v))) if to_inexact else tfn

    def op(x, name=None):
        return apply_op(op.__op_name__, fn, (targ(x),))

    op.__op_name__ = name
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or "Elementwise %s." % name
    register(name, op, category=category, tensor_method=method,
             inplace_alias=inplace)
    return op


def def_binary(name: str, tfn: Callable, category="math", method=True,
               inplace=True, to_inexact=False, doc: str = ""):
    """A paddle-style binary (broadcasting) op over ``tfn``, its operands
    promoted first as the reference's ``jnp`` functions promote them."""
    def fn(a, b):
        a, b = promote(a, b)
        if to_inexact:
            a, b = inexact(a), inexact(b)
        return tfn(a, b)

    def op(x, y, name=None):
        return apply_op(op.__op_name__, fn, (targ(x), targ(y)))

    op.__op_name__ = name
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or "Elementwise %s with numpy broadcasting." % name
    register(name, op, category=category, tensor_method=method,
             inplace_alias=inplace)
    return op


def norm_dims(axis, ndim):
    """``axis`` (None, an int or a sequence) as the ``dim`` argument of a
    torch reduction: None -> every axis (a 0-d tensor reduces over
    nothing)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)
