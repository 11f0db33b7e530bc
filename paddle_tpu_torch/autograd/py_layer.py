"""User-defined autograd ops (counterpart of
``paddle_tpu/autograd/py_layer.py``).

A ``PyLayer`` subclass gives static ``forward(ctx, *args)`` and
``backward(ctx, *grads)`` over API tensors.  ``apply`` runs it as a
``torch.autograd.Function``: the forward without grad, the backward on
the output gradients, returning one gradient per tensor argument of the
forward (None for one that needs none).  Under ``create_graph`` the
backward's own ops are recorded, so a second order flows through it.
"""
from __future__ import annotations

from typing import Any, List

import torch

from ..core.tensor import Tensor


class PyLayerContext:
    def __init__(self):
        self._saved: List[Any] = []
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _Function(torch.autograd.Function):
    """The torch side of one ``PyLayer.apply`` call: ``spec`` says which
    forward argument is which flat tensor."""

    @staticmethod
    def forward(ctx, layer, pctx, spec, kwargs, *flat):
        args = [Tensor._from_value(flat[a]) if kind == "t" else a
                for kind, a in spec]
        outs = layer.forward(pctx, *args, **kwargs)
        single = isinstance(outs, Tensor)
        out_list = [outs] if single else list(outs)
        ctx.layer, ctx.pctx, ctx.n_in = layer, pctx, len(flat)
        ctx.single = single
        ctx.kinds = [isinstance(o, Tensor) for o in out_list]
        vals = tuple(o._value if isinstance(o, Tensor) else o
                     for o in out_list)
        return vals[0] if single else vals

    @staticmethod
    def backward(ctx, *grads):
        cots = [Tensor._from_value(g) for g, is_t in zip(grads, ctx.kinds)
                if is_t]
        res = ctx.layer.backward(ctx.pctx, *cots)
        if isinstance(res, Tensor) or res is None:
            res = (res,)
        res = list(res)[:ctx.n_in]
        res += [None] * (ctx.n_in - len(res))
        return (None, None, None, None) + tuple(
            r._value if isinstance(r, Tensor) else r for r in res)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        pctx = PyLayerContext()
        spec, flat = [], []
        for a in args:
            if isinstance(a, Tensor):
                spec.append(("t", len(flat)))
                flat.append(a._value)
            else:
                spec.append(("v", a))
        outs = _Function.apply(cls, pctx, spec, kwargs, *flat)
        if isinstance(outs, torch.Tensor):
            return Tensor._from_value(outs)
        return tuple(Tensor._from_value(o) if isinstance(o, torch.Tensor)
                     else o for o in outs)


class LegacyPyLayer(PyLayer):
    pass
