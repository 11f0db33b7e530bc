"""Op registry (a port copy of ``paddle_tpu/ops/registry.py``).

An op is a named Python function over API tensors whose body is a PyTorch
function run through ``core.dispatch.apply_op``; registering the forward
implies the backward (torch's autograd), as registering a JAX function
does in the reference.  The registry drives the Tensor method table, the
AMP op lists and introspection (``registered_ops()``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

_OPS: Dict[str, "OpDef"] = {}


@dataclass
class OpDef:
    name: str
    fn: Callable                      # python-facing function (Tensor level)
    category: str = "misc"
    tensor_method: bool = False       # attach as Tensor.<name>
    method_name: Optional[str] = None
    inplace_alias: bool = False       # also expose <name>_ in-place variant
    doc: str = ""


def register_op(name: str, category: str = "misc",
                tensor_method: bool = False,
                method_name: Optional[str] = None,
                inplace_alias: bool = False):
    """Decorator registering a python-level op."""

    def deco(fn):
        _OPS[name] = OpDef(name, fn, category, tensor_method,
                           method_name or name, inplace_alias, fn.__doc__ or "")
        return fn

    return deco


def register(name: str, fn: Callable, **kw):
    _OPS[name] = OpDef(name, fn, kw.get("category", "misc"),
                       kw.get("tensor_method", False),
                       kw.get("method_name", name),
                       kw.get("inplace_alias", False), fn.__doc__ or "")
    return fn


def get_op(name: str) -> OpDef:
    return _OPS[name]


def registered_ops() -> Dict[str, OpDef]:
    return dict(_OPS)


def attach_tensor_methods(tensor_cls):
    """Attach registered ops as Tensor methods (the analog of the generated
    method table in paddle/fluid/pybind/eager_op_function.cc)."""
    for opdef in _OPS.values():
        if not opdef.tensor_method:
            continue
        name = opdef.method_name
        if name in tensor_cls.__dict__:
            continue
        setattr(tensor_cls, name, opdef.fn)
        if opdef.inplace_alias and name + "_" not in tensor_cls.__dict__:
            def make_inplace(f):
                def inplace(self, *a, **k):
                    return self._inplace_assign(f(self, *a, **k))
                return inplace
            setattr(tensor_cls, name + "_", make_inplace(opdef.fn))
