"""Reductions, scans and statistics (counterpart of
``paddle_tpu/ops/reduction.py``).  Output dtypes are the reference's:
an int sum or product is int64, a mean or variance of ints is computed
in the reference's inexact dtype, a cumulative sum keeps an int dtype."""
from __future__ import annotations


import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from .registry import register, register_op
from ._helpers import as_value, inexact, norm_dims, wrap


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        return tuple(int(v) for v in np.atleast_1d(axis.numpy()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _reduce(tfn, v, ax, keepdim):
    """``tfn(v, dim, keepdim)`` with the reference's meaning of ``ax``
    (None: every axis; a 0-d input reduces over nothing)."""
    if v.dim() == 0:
        return tfn(v.reshape(1), 0, False)
    return tfn(v, norm_dims(ax, v.dim()), keepdim)


def _is_int(v):
    return not (v.is_floating_point() or v.is_complex())


def _def_reduce(name, tfn, kind):
    """``kind``: "int64" (ints and bools sum into int64), "inexact"
    (ints computed in the reference's inexact dtype) or "keep"."""
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        ax = _norm_axis(axis)
        d = _dt.convert_dtype(dtype) if dtype else None

        def fn(v):
            if kind == "inexact":
                v = inexact(v)
            elif kind == "int64" and _is_int(v):
                v = v.to(torch.int64)
            out = _reduce(tfn, v, ax, keepdim)
            return out.to(d) if d is not None else out
        return apply_op(op.__op_name__, fn, (x,))

    op.__op_name__ = name
    op.__name__ = name
    register(name, op, category="reduction", tensor_method=True)
    return op


sum = _def_reduce("sum", lambda v, d, k: torch.sum(v, d, keepdim=k),
                  "int64")
mean = _def_reduce("mean", lambda v, d, k: torch.mean(v, d, keepdim=k),
                   "inexact")


def _prod(v, d, k):
    dims = [d] if isinstance(d, int) else sorted(
        (x % v.dim() for x in d), reverse=True)
    for x in dims:
        v = torch.prod(v, x, keepdim=True)
    return v if k else v.reshape([s for i, s in enumerate(v.shape)
                                  if i not in [x % v.dim() for x in dims]])


prod = _def_reduce("prod", _prod, "int64")
nansum = _def_reduce("nansum", lambda v, d, k: torch.nansum(v, d, keepdim=k),
                     "int64")
nanmean = _def_reduce("nanmean",
                      lambda v, d, k: torch.nanmean(v, d, keepdim=k),
                      "inexact")
amax = _def_reduce("amax", lambda v, d, k: torch.amax(v, d, keepdim=k),
                   "keep")
amin = _def_reduce("amin", lambda v, d, k: torch.amin(v, d, keepdim=k),
                   "keep")


def _def_minmax(name, tfn):
    def op(x, axis=None, keepdim=False, name=None):
        ax = _norm_axis(axis)
        return apply_op(op.__op_name__,
                        lambda v: _reduce(tfn, v, ax, keepdim), (x,))
    op.__op_name__ = name
    op.__name__ = name
    register(name, op, category="reduction", tensor_method=True)
    return op


max = _def_minmax("max", lambda v, d, k: torch.amax(v, d, keepdim=k))
min = _def_minmax("min", lambda v, d, k: torch.amin(v, d, keepdim=k))


def _logical_reduce(tfn):
    def f(v, d, k):
        v = v.to(torch.bool)
        if isinstance(d, tuple):
            for x in sorted((x % v.dim() for x in d), reverse=True):
                v = tfn(v, x, keepdim=True)
            return v if k else v.reshape([s for i, s in enumerate(v.shape)
                                          if i not in [x % v.dim()
                                                       for x in d]])
        return tfn(v, d, keepdim=k)
    return f


@register_op("all", category="reduction", tensor_method=True)
def all(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op("all", lambda v: _reduce(_logical_reduce(torch.all), v,
                                             ax, keepdim), (x,))


@register_op("any", category="reduction", tensor_method=True)
def any(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op("any", lambda v: _reduce(_logical_reduce(torch.any), v,
                                             ax, keepdim), (x,))


def _arg(tfn, v, axis, keepdim):
    if axis is None:
        out = tfn(v.reshape(-1), 0)
        return out.reshape([1] * v.dim()) if keepdim else out
    return tfn(v, axis, keepdim=keepdim)


@register_op("argmax", category="reduction", tensor_method=True)
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = _dt.convert_dtype(dtype)
    return apply_op("argmax", lambda v: _arg(torch.argmax, v, axis,
                                             keepdim).to(d), (x,))


@register_op("argmin", category="reduction", tensor_method=True)
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = _dt.convert_dtype(dtype)
    return apply_op("argmin", lambda v: _arg(torch.argmin, v, axis,
                                             keepdim).to(d), (x,))


def _scan(tfn, v, axis, d):
    keep = d or (torch.int64 if v.dtype == torch.bool else v.dtype)
    vv = v.reshape(-1) if axis is None else v
    out = tfn(vv, 0 if axis is None else axis)
    return out.to(keep)


@register_op("cumsum", category="reduction", tensor_method=True)
def cumsum(x, axis=None, dtype=None, name=None):
    d = _dt.convert_dtype(dtype) if dtype else None
    return apply_op("cumsum", lambda v: _scan(torch.cumsum, v, axis, d),
                    (x,))


@register_op("cumprod", category="reduction", tensor_method=True)
def cumprod(x, dim=None, dtype=None, name=None):
    d = _dt.convert_dtype(dtype) if dtype else None
    return apply_op("cumprod", lambda v: _scan(torch.cumprod, v, dim, d),
                    (x,))


def _cum_extreme(tfn, v, axis, dtype):
    """Running extreme and the index of its last occurrence so far (the
    reference's formula)."""
    vv = v.reshape(-1) if axis is None else v
    ax = (0 if axis is None else axis) % vv.dim()
    vals = tfn(vv, ax).values
    shape = [-1 if i == ax else 1 for i in range(vv.dim())]
    ar = torch.arange(vv.shape[ax], device=v.device).reshape(shape)
    idx = torch.where(vv == vals, ar, torch.zeros_like(ar))
    idx = torch.cummax(idx.expand(vv.shape), ax).values
    return vals, idx.to(_dt.convert_dtype(dtype))


@register_op("cummax", category="reduction", tensor_method=True)
def cummax(x, axis=None, dtype="int64", name=None):
    return apply_op("cummax", lambda v: _cum_extreme(torch.cummax, v, axis,
                                                     dtype), (x,))


@register_op("cummin", category="reduction", tensor_method=True)
def cummin(x, axis=None, dtype="int64", name=None):
    return apply_op("cummin", lambda v: _cum_extreme(torch.cummin, v, axis,
                                                     dtype), (x,))


@register_op("logsumexp", category="reduction", tensor_method=True)
def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op("logsumexp", lambda v: _reduce(
        lambda t, d, k: torch.logsumexp(t, d, keepdim=k), inexact(v), ax,
        keepdim), (x,))


@register_op("logcumsumexp", category="reduction", tensor_method=True)
def logcumsumexp(x, axis=None, dtype=None, name=None):
    def fn(v):
        vv = inexact(v).reshape(-1) if axis is None else inexact(v)
        return torch.logcumsumexp(vv, 0 if axis is None else axis)
    return apply_op("logcumsumexp", fn, (x,))


def _moment(tfn, ax, unbiased, keepdim):
    ddof = 1 if unbiased else 0

    def fn(v):
        v = inexact(v)
        if v.dim() == 0:
            v = v.reshape(1)
        return tfn(v, norm_dims(ax, v.dim()), correction=ddof,
                   keepdim=keepdim)
    return fn


@register_op("std", category="reduction", tensor_method=True)
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op("std", _moment(torch.std, _norm_axis(axis), unbiased,
                                   keepdim), (x,))


@register_op("var", category="reduction", tensor_method=True)
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op("var", _moment(torch.var, _norm_axis(axis), unbiased,
                                   keepdim), (x,))


def _flat_axis(v, axis, keepdim):
    """(tensor, axis, reshape-after) for ops that take one axis or
    None (flattened)."""
    if axis is None:
        return v.reshape(-1), 0, ([1] * v.dim() if keepdim else [])
    return v, axis % v.dim(), None


@register_op("median", category="reduction", tensor_method=True)
def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def fn(v):
        vv, ax, shape = _flat_axis(v, axis, keepdim and mode == "avg")
        n = vv.shape[ax]
        srt, arg = torch.sort(vv, dim=ax, stable=True)
        if mode == "avg":
            srt = inexact(srt)
            lo = srt.narrow(ax, (n - 1) // 2, 1)
            hi = srt.narrow(ax, n // 2, 1)
            out = (lo + hi) / 2
            if shape is not None:
                return out.reshape(shape)
            return out if keepdim else out.squeeze(ax)
        k = (n - 1) // 2
        vals = srt.narrow(ax, k, 1)
        idxs = arg.narrow(ax, k, 1)
        if not keepdim:
            vals, idxs = vals.squeeze(ax), idxs.squeeze(ax)
        return vals, idxs.to(torch.int64)
    return apply_op("median", fn, (x,))


def _nanq(v, q, axis, keepdim, method="linear"):
    vv, ax, shape = _flat_axis(inexact(v), axis, keepdim)
    qt = torch.as_tensor(q, dtype=vv.dtype, device=vv.device)
    out = torch.nanquantile(vv, qt, dim=ax, keepdim=shape is None and
                            keepdim, interpolation=method)
    if shape is not None and keepdim:
        out = out.reshape(tuple(out.shape[:qt.dim()]) + tuple(shape))
    return out


@register_op("nanmedian", category="reduction", tensor_method=True)
def nanmedian(x, axis=None, keepdim=False, name=None):
    return apply_op("nanmedian", lambda v: _nanq(v, 0.5, axis, keepdim),
                    (x,))


@register_op("quantile", category="reduction", tensor_method=True)
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    def fn(v):
        vv, ax, shape = _flat_axis(inexact(v), axis, keepdim)
        qt = torch.as_tensor(q, dtype=vv.dtype, device=vv.device)
        out = torch.quantile(vv, qt, dim=ax, keepdim=shape is None and
                             keepdim, interpolation=interpolation)
        if shape is not None and keepdim:
            out = out.reshape(tuple(out.shape[:qt.dim()]) + tuple(shape))
        return out
    return apply_op("quantile", fn, (x,))


@register_op("nanquantile", category="reduction", tensor_method=True)
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return apply_op("nanquantile", lambda v: _nanq(v, q, axis, keepdim),
                    (x,))


@register_op("kthvalue", category="reduction", tensor_method=True)
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(v):
        ax = axis % v.dim()
        srt, arg = torch.sort(v, dim=ax, stable=True)
        vals, idxs = srt.narrow(ax, k - 1, 1), arg.narrow(ax, k - 1, 1)
        if not keepdim:
            vals, idxs = vals.squeeze(ax), idxs.squeeze(ax)
        return vals, idxs.to(torch.int64)
    return apply_op("kthvalue", fn, (x,))


def _host(x) -> np.ndarray:
    v = as_value(x).detach()
    return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()


def _device_of(x):
    return as_value(x).device


@register_op("mode", category="reduction", tensor_method=True)
def mode(x, axis=-1, keepdim=False, name=None):
    v = _host(x)
    ax = axis % v.ndim
    moved = np.moveaxis(v, ax, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], v.dtype)
    idxs = np.empty(flat.shape[0], np.int64)
    for i, row in enumerate(flat):
        uniq, counts = np.unique(row, return_counts=True)
        best = uniq[np.argmax(counts)]
        vals[i] = best
        idxs[i] = np.where(row == best)[0][-1]
    vals, idxs = vals.reshape(moved.shape[:-1]), idxs.reshape(
        moved.shape[:-1])
    if keepdim:
        vals, idxs = np.expand_dims(vals, ax), np.expand_dims(idxs, ax)
    dev = _device_of(x)
    return (wrap(torch.from_numpy(vals).to(dev, as_value(x).dtype)),
            wrap(torch.from_numpy(idxs).to(dev)))


@register_op("count_nonzero", category="reduction", tensor_method=True)
def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)

    def fn(v):
        dims = norm_dims(ax, v.dim())
        out = torch.count_nonzero(v, dim=dims).to(torch.int64)
        if keepdim:
            for d in sorted(x % v.dim() for x in (
                    dims if isinstance(dims, tuple) else (dims,))):
                out = out.unsqueeze(d)
        return out
    return apply_op("count_nonzero", fn, (x,))


@register_op("histogram", category="reduction", tensor_method=True)
def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    v = _host(input)
    lo, hi = (min, max) if (min != 0 or max != 0) else (v.min(), v.max())
    w = _host(weight) if weight is not None else None
    hist, _ = np.histogram(v, bins=bins, range=(lo, hi), weights=w,
                           density=density)
    out = hist if density else hist.astype(np.int64)
    return wrap(torch.from_numpy(np.asarray(out)).to(_device_of(input)))


@register_op("histogramdd", category="reduction")
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    v = _host(x)
    w = _host(weights) if weights is not None else None
    hist, edges = np.histogramdd(v, bins=bins, range=ranges, density=density,
                                 weights=w)
    dev = _device_of(x)
    return (wrap(torch.from_numpy(hist).to(dev)),
            [wrap(torch.from_numpy(e).to(dev)) for e in edges])


@register_op("bincount", category="reduction", tensor_method=True)
def bincount(x, weights=None, minlength=0, name=None):
    v = _host(x)
    w = _host(weights) if weights is not None else None
    return wrap(torch.from_numpy(np.bincount(v, w, minlength)).to(
        _device_of(x)))


