"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

New tensors land on the current device (``core.device.current_device``:
the card unless ``set_device("cpu")``); ``*_like`` ops on their input's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.device import current_device
from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from .registry import register_op
from ._helpers import as_value, inexact, promote, targ, wrap


def _dtype_or_default(dtype):
    return _dt.convert_dtype(dtype) if dtype is not None \
        else _dt.get_default_dtype()


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) if not isinstance(s, Tensor) else int(s.item())
                 for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, Tensor) else v


@register_op("zeros", category="creation")
def zeros(shape, dtype=None, name=None):
    return wrap(torch.zeros(_shape(shape), dtype=_dtype_or_default(dtype),
                            device=current_device()))


@register_op("ones", category="creation")
def ones(shape, dtype=None, name=None):
    return wrap(torch.ones(_shape(shape), dtype=_dtype_or_default(dtype),
                           device=current_device()))


def _fill_dtype(val, dtype):
    if dtype is not None:
        return _dt.convert_dtype(dtype)
    if isinstance(val, bool):
        return torch.bool
    if isinstance(val, int):
        return torch.int64
    return _dt.get_default_dtype()


@register_op("full", category="creation")
def full(shape, fill_value, dtype=None, name=None):
    val = _scalar(fill_value)
    return wrap(torch.full(_shape(shape), val,
                           dtype=_fill_dtype(val, dtype),
                           device=current_device()))


@register_op("zeros_like", category="creation", tensor_method=True)
def zeros_like(x, dtype=None, name=None):
    return wrap(torch.zeros_like(as_value(x).detach(),
                                 dtype=_dt.convert_dtype(dtype)))


@register_op("ones_like", category="creation", tensor_method=True)
def ones_like(x, dtype=None, name=None):
    return wrap(torch.ones_like(as_value(x).detach(),
                                dtype=_dt.convert_dtype(dtype)))


@register_op("full_like", category="creation", tensor_method=True)
def full_like(x, fill_value, dtype=None, name=None):
    return wrap(torch.full_like(as_value(x).detach(), _scalar(fill_value),
                                dtype=_dt.convert_dtype(dtype)))


@register_op("empty", category="creation")
def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@register_op("empty_like", category="creation")
def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


@register_op("arange", category="creation")
def arange(start=0, end=None, step=1, dtype=None, name=None):
    s, e, st = _scalar(start), _scalar(end), _scalar(step)
    if e is None:
        s, e = 0, s
    if dtype is None:
        dtype = torch.int64 if all(
            isinstance(v, (int, np.integer)) for v in (s, e, st)) \
            else _dt.get_default_dtype()
    d = _dt.convert_dtype(dtype)
    if d.is_floating_point:
        # the reference's values: start + i * step, computed in the dtype
        n = int(np.ceil((e - s) / st))
        return wrap(s + torch.arange(max(n, 0), dtype=d,
                                     device=current_device()) * st)
    return wrap(torch.arange(s, e, st, dtype=d, device=current_device()))


def _space_dtype(dtype, *ends):
    if dtype is not None:
        return _dt.convert_dtype(dtype)
    ts = [e.dtype for e in ends if isinstance(e, Tensor)]
    # Python ends are weak in the reference: its default float (x64)
    return _dt.to_inexact(_dt.result_type(*ts)) if ts else torch.float64


@register_op("linspace", category="creation")
def linspace(start, stop, num, dtype=None, name=None):
    d = _space_dtype(dtype, start, stop)
    out = torch.linspace(float(_scalar(start)), float(_scalar(stop)),
                         int(num), dtype=torch.float64,
                         device=current_device())
    return wrap(out.to(d) if d.is_floating_point else out.floor().to(d))


@register_op("logspace", category="creation")
def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    d = _space_dtype(dtype, start, stop)
    out = torch.logspace(float(_scalar(start)), float(_scalar(stop)),
                         int(num), base=base, dtype=torch.float64,
                         device=current_device())
    return wrap(out.to(d))


@register_op("eye", category="creation")
def eye(num_rows, num_columns=None, dtype=None, name=None):
    return wrap(torch.eye(num_rows, num_columns if num_columns is not None
                          else num_rows, dtype=_dtype_or_default(dtype),
                          device=current_device()))


@register_op("meshgrid", category="creation")
def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply_op("meshgrid", lambda *xs: tuple(
        torch.meshgrid(*promote(*xs), indexing="ij")), args))


@register_op("diag", category="creation", tensor_method=True)
def diag(x, offset=0, padding_value=0, name=None):
    def fn(v):
        if v.dim() == 1 and padding_value != 0:
            n = v.shape[0] + abs(offset)
            base = torch.full((n, n), padding_value, dtype=v.dtype,
                              device=v.device)
            return base + torch.diag(v, offset) - torch.diag(
                torch.full_like(v, padding_value), offset)
        return torch.diag(v, offset)
    return apply_op("diag", fn, (x,))


@register_op("diagflat", category="creation", tensor_method=True)
def diagflat(x, offset=0, name=None):
    return apply_op("diagflat", lambda v: torch.diagflat(v, offset), (x,))


@register_op("diag_embed", category="creation")
def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply_op("diag_embed",
                    lambda v: torch.diag_embed(v, offset, dim1, dim2), (x,))


@register_op("diagonal", category="creation", tensor_method=True)
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op("diagonal", lambda v: torch.diagonal(
        v, offset, axis1, axis2).clone(), (x,))


@register_op("tril", category="creation", tensor_method=True)
def tril(x, diagonal=0, name=None):
    return apply_op("tril", lambda v: torch.tril(v, diagonal), (x,))


@register_op("triu", category="creation", tensor_method=True)
def triu(x, diagonal=0, name=None):
    return apply_op("triu", lambda v: torch.triu(v, diagonal), (x,))


@register_op("tril_indices", category="creation")
def tril_indices(row, col, offset=0, dtype="int64", name=None):
    r, c = np.tril_indices(row, offset, col)
    return wrap(torch.tensor(np.stack([r, c]), dtype=_dt.convert_dtype(
        dtype), device=current_device()))


@register_op("triu_indices", category="creation")
def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = col if col is not None else row
    r, c = np.triu_indices(row, offset, col)
    return wrap(torch.tensor(np.stack([r, c]), dtype=_dt.convert_dtype(
        dtype), device=current_device()))


@register_op("assign", category="creation")
def assign(x, output=None, name=None):
    if output is not None:
        output.set_value(as_value(x))
        return output
    if isinstance(x, Tensor):
        return apply_op("assign", lambda v: v.clone(), (x,))
    return wrap(as_value(x).to(current_device()))


@register_op("numel", category="creation", tensor_method=False)
def numel(x, name=None):
    v = as_value(x)
    return wrap(torch.tensor(int(v.numel()), dtype=torch.int64,
                             device=v.device))


@register_op("one_hot", category="creation")
def one_hot(x, num_classes, name=None):
    def fn(v):
        v = v.to(torch.int64)
        hit = v.unsqueeze(-1) == torch.arange(num_classes, device=v.device)
        return hit.to(_dt.get_default_dtype())
    return apply_op("one_hot", fn, (x,))


@register_op("complex", category="creation")
def complex(real, imag, name=None):
    return apply_op("complex", lambda a, b: torch.complex(
        *promote(inexact(a), inexact(b))), (real, targ(imag)))


@register_op("as_complex", category="creation", tensor_method=True)
def as_complex(x, name=None):
    return apply_op("as_complex",
                    lambda v: torch.complex(v[..., 0], v[..., 1]), (x,))


@register_op("as_real", category="creation", tensor_method=True)
def as_real(x, name=None):
    return apply_op("as_real",
                    lambda v: torch.stack([v.real, v.imag], -1), (x,))


@register_op("clone", category="creation", tensor_method=True)
def clone(x, name=None):
    return apply_op("clone", lambda v: v.clone(), (x,))


@register_op("cast", category="creation")
def cast(x, dtype, name=None):
    d = _dt.convert_dtype(dtype)
    return apply_op("cast", lambda v: v.to(d), (x,))

