"""The API's op table (counterpart of ``paddle_tpu/ops/__init__.py``).

Importing this module imports every op family, attaches the Tensor
methods, indexing and the Python operators, and builds the top-level
in-place variants.  ``paddle_tpu_torch`` loads it lazily, at the first
API name asked for, so importing the engines or starting rank workers
does not build it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from . import registry
from . import creation, linalg, logic, manipulation, math, random  # noqa
from . import reduction  # noqa: F401
from . import inplace as _inplace
from ._helpers import as_value


def ops_namespace():
    """Every registered op and top-level in-place variant by name."""
    ns = {name: opdef.fn for name, opdef in registry.registered_ops().items()}
    for name, fn in _inplace.build().items():
        ns.setdefault(name, fn)
    return ns


# -- indexing ----------------------------------------------------------------
def _index_item(it, dev):
    if isinstance(it, Tensor):
        v = it._value
        if v.dim() == 0 and v.dtype != torch.bool:
            return int(v.item())
        return v.to(dev)
    if isinstance(it, np.ndarray) or (isinstance(it, list)
                                      and not isinstance(it, bool)):
        arr = np.asarray(it)
        return torch.from_numpy(arr.astype(np.int64) if arr.dtype.kind in
                                "iu" else arr).to(dev)
    return it


def _index(item, dev):
    if not isinstance(item, tuple):
        item = (item,)
    return tuple(_index_item(it, dev) for it in item)


def _getitem(self, item):
    idx = _index(item, self._value.device)
    return apply_op("getitem", lambda v: v[idx], (self,))


def _setitem(self, item, value):
    idx = _index(item, self._value.device)

    def fn(v, val):
        out = v.clone()
        out[idx] = val.to(out.dtype)
        return out
    val = value if isinstance(value, Tensor) else as_value(value)
    self._inplace_assign(apply_op("setitem", fn, (self, val)))


Tensor.__getitem__ = _getitem
Tensor.__setitem__ = _setitem


# -- Python operators ---------------------------------------------------------
def _binop(opfn, swap=False):
    def method(self, other):
        if swap:
            return opfn(other if isinstance(other, Tensor)
                        else Tensor(other, place=self.place), self)
        return opfn(self, other)
    return method


Tensor.__add__ = _binop(math.add)
Tensor.__radd__ = _binop(math.add, swap=True)
Tensor.__sub__ = _binop(math.subtract)
Tensor.__rsub__ = _binop(math.subtract, swap=True)
Tensor.__mul__ = _binop(math.multiply)
Tensor.__rmul__ = _binop(math.multiply, swap=True)
Tensor.__truediv__ = _binop(math.divide)
Tensor.__rtruediv__ = _binop(math.divide, swap=True)
Tensor.__floordiv__ = _binop(math.floor_divide)
Tensor.__rfloordiv__ = _binop(math.floor_divide, swap=True)
Tensor.__mod__ = _binop(math.mod)
Tensor.__rmod__ = _binop(math.mod, swap=True)
Tensor.__pow__ = _binop(math.pow)
Tensor.__rpow__ = _binop(math.pow, swap=True)
Tensor.__matmul__ = _binop(linalg.matmul)
Tensor.__rmatmul__ = _binop(linalg.matmul, swap=True)
Tensor.__neg__ = lambda self: math.neg(self)
Tensor.__abs__ = lambda self: math.abs(self)
Tensor.__invert__ = lambda self: math.logical_not(self) \
    if self.dtype == torch.bool else math.bitwise_not(self)
Tensor.__eq__ = lambda self, other: math.equal(self, other)
Tensor.__ne__ = lambda self, other: math.not_equal(self, other)
Tensor.__lt__ = _binop(math.less_than)
Tensor.__le__ = _binop(math.less_equal)
Tensor.__gt__ = _binop(math.greater_than)
Tensor.__ge__ = _binop(math.greater_equal)
Tensor.__and__ = _binop(math.bitwise_and)
Tensor.__or__ = _binop(math.bitwise_or)
Tensor.__xor__ = _binop(math.bitwise_xor)
Tensor.__lshift__ = _binop(math.bitwise_left_shift)
Tensor.__rshift__ = _binop(math.bitwise_right_shift)


def _inplace_binop(opfn):
    def method(self, other):
        return self._inplace_assign(opfn(self, other))
    return method


Tensor.__iadd__ = _inplace_binop(math.add)
Tensor.__isub__ = _inplace_binop(math.subtract)
Tensor.__imul__ = _inplace_binop(math.multiply)
Tensor.__itruediv__ = _inplace_binop(math.divide)

Tensor.T = property(lambda self: manipulation.transpose(self))
Tensor.mT = property(lambda self: manipulation.swapaxes(self, -1, -2))

registry.attach_tensor_methods(Tensor)
