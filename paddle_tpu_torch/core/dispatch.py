"""Eager op dispatch (counterpart of ``paddle_tpu/core/dispatch.py``).

``apply_op`` is the one door every API op goes through.  It unwraps the
API tensors, applies the AMP cast of the active ``auto_cast`` scope
(:func:`amp_policy`, the reference's O1/O2 white/black-list rule), runs
the op's PyTorch function (torch's autograd records it), wraps the
outputs and, under ``FLAGS_check_nan_inf``, checks them.  One hook slot,
``_amp_debug_hook``, gives ``amp.debugging`` (the tensor checker and the
operator statistics) each op's name and outputs; while it is empty the
door costs one list read.  There is no tape of its own and no JIT or SOT
hook: those are later slices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from .flags import get_flag

_amp_state = {"enabled": False, "dtype": None, "level": "O1",
              "white": frozenset(), "black": frozenset()}

# amp.debugging's per-op hook ``hook(name, output_values)``; None while no
# debugging tool is on (``amp/debugging.py``)
_amp_debug_hook = [None]


def amp_policy(name: str, level: str, target, white, black):
    """The cast target of op ``name`` under the O1/O2 lists (reference:
    ``amp_policy``): black-listed ops run in float32, white-listed ones
    (every op at O2) in the AMP dtype, the rest as they come (None)."""
    base = name.split("::")[0]
    if base in black:
        return torch.float32
    if base in white or level == "O2":
        return target
    return None


def _amp_cast_dtype(name: str):
    st = _amp_state
    if not st["enabled"]:
        return None
    return amp_policy(name, st["level"], st["dtype"], st["white"],
                      st["black"])


def _amp_cast(v, cast_to):
    if cast_to is not None and isinstance(v, torch.Tensor) \
            and v.is_floating_point() and v.dtype != cast_to \
            and v.dtype != torch.float64:
        return v.to(cast_to)
    return v


def _check_nan_inf(name: str, vals):
    for v in vals:
        if isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex()):
            if not bool(torch.isfinite(v).all()):
                msg = "Operator %s output contains NaN/Inf" % name
                if get_flag("check_nan_inf_level") == 0:
                    raise FloatingPointError(msg)
                print("WARNING:", msg)


def apply_op(name: str, fn: Callable, tensor_args: Sequence,
             kwargs: Optional[Dict[str, Any]] = None,
             multi_output: bool = False):
    """Run ``fn(*values, **kwargs)`` over ``tensor_args`` (API tensors,
    raw ``torch.Tensor`` s or Python values passed through) and wrap the
    result.  Raw tensors are moved to the first API tensor's device (the
    operands ``ops._helpers.targ`` made from Python data)."""
    from .tensor import Tensor
    dev = None
    for a in tensor_args:
        if isinstance(a, Tensor):
            dev = a._value.device
            break
    vals = []
    for a in tensor_args:
        if isinstance(a, Tensor):
            vals.append(a._value)
        elif isinstance(a, torch.Tensor) and dev is not None \
                and a.device != dev:
            vals.append(a.to(dev))
        else:
            vals.append(a)
    cast_to = _amp_cast_dtype(name)
    if cast_to is not None:
        vals = [_amp_cast(v, cast_to) for v in vals]
    out = fn(*vals, **(kwargs or {}))
    flat = out if isinstance(out, (tuple, list)) else (out,)
    if get_flag("check_nan_inf"):
        _check_nan_inf(name, flat)
    dbg = _amp_debug_hook[0]
    if dbg is not None:
        dbg(name, flat)
    if isinstance(out, (tuple, list)):
        return tuple(Tensor._from_value(v) for v in out)
    t = Tensor._from_value(out)
    return (t,) if multi_output else t
