"""Activation functions (counterpart of
``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from ...ops import math as _m
from ...ops._helpers import inexact, promote, targ
from ...ops.random import generator_for
from ...ops.registry import register

tanh = _m.tanh
sigmoid = _m.sigmoid


def _act(name, tfn):
    def op(x, name=None):
        return apply_op(op.__op_name__, lambda v: tfn(inexact(v)), (x,))
    op.__op_name__ = name
    op.__name__ = name
    register(name, op, category="activation")
    return op


relu = _act("relu", torch.relu)
relu6 = _act("relu6", lambda v: torch.clamp(v, 0.0, 6.0))
silu = _act("silu", TF.silu)
softsign = _act("softsign", lambda v: v / (1 + torch.abs(v)))
log_sigmoid = _act("log_sigmoid", TF.logsigmoid)
tanhshrink = _act("tanhshrink", lambda v: v - torch.tanh(v))
mish = _act("mish", lambda v: v * torch.tanh(TF.softplus(v)))


def relu_(x, name=None):
    return x._inplace_assign(relu(x))


def gelu(x, approximate=False, name=None):
    mode = "tanh" if approximate else "none"
    return apply_op("gelu", lambda v: TF.gelu(v, approximate=mode), (x,))


def swish(x, name=None):
    return silu(x)


def _cast_to(v, dtype):
    if dtype is None:
        return v
    from ...core import dtypes as _dt
    return v.to(_dt.convert_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return apply_op("softmax", lambda v: torch.softmax(
        _cast_to(v, dtype), dim=axis), (x,))


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply_op("log_softmax", lambda v: torch.log_softmax(
        _cast_to(v, dtype), dim=axis), (x,))


def softplus(x, beta=1, threshold=20, name=None):
    def fn(v):
        scaled = beta * v
        return torch.where(scaled > threshold, v,
                           torch.logaddexp(scaled, torch.zeros_like(scaled))
                           / beta)
    return apply_op("softplus", fn, (x,))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_op("hardtanh", lambda v: torch.clamp(v, min, max), (x,))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_op("hardsigmoid", lambda v: torch.clamp(
        v * slope + offset, 0.0, 1.0), (x,))


def hardswish(x, name=None):
    return apply_op("hardswish", TF.hardswish, (x,))


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op("leaky_relu",
                    lambda v: torch.where(v >= 0, v, v * negative_slope),
                    (x,))


def elu(x, alpha=1.0, name=None):
    return apply_op("elu", lambda v: torch.where(
        v > 0, v, alpha * torch.expm1(torch.clamp(v, max=0.0))), (x,))


def celu(x, alpha=1.0, name=None):
    return apply_op("celu", lambda v: torch.where(
        v > 0, v, alpha * torch.expm1(torch.clamp(v, max=0.0) / alpha)),
        (x,))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op("selu", lambda v: scale * torch.where(
        v > 0, v, alpha * torch.expm1(torch.clamp(v, max=0.0))), (x,))


def softshrink(x, threshold=0.5, name=None):
    return apply_op("softshrink", lambda v: torch.where(
        v > threshold, v - threshold, torch.where(
            v < -threshold, v + threshold, torch.zeros_like(v))), (x,))


def hardshrink(x, threshold=0.5, name=None):
    return apply_op("hardshrink", lambda v: torch.where(
        torch.abs(v) > threshold, v, torch.zeros_like(v)), (x,))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_op("thresholded_relu", lambda v: torch.where(
        v > threshold, v, torch.full_like(v, value)), (x,))


def prelu(x, weight, data_format="NCHW", name=None):
    def fn(v, w):
        v, w = promote(v, w)
        if w.numel() > 1:
            shape = [1] * v.dim()
            ch = 1 if data_format.startswith("NC") else v.dim() - 1
            shape[ch] = w.numel()
            w = w.reshape(shape)
        return torch.where(v > 0, v, w * v)
    return apply_op("prelu", fn, (x, targ(weight)))


def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    return leaky_relu(x, (lower + upper) / 2.0)


def glu(x, axis=-1, name=None):
    def fn(v):
        a, b = torch.chunk(v, 2, dim=axis)
        return a * torch.sigmoid(b)
    return apply_op("glu", fn, (x,))


def swiglu(x, y=None, name=None):
    """``silu(x) * y``, or of the two halves of ``x`` (the Llama MLP
    gate)."""
    if y is not None:
        return apply_op("swiglu", lambda a, b: TF.silu(a) * b, (x, targ(y)))

    def fn(v):
        a, b = torch.chunk(v, 2, dim=-1)
        return TF.silu(a) * b
    return apply_op("swiglu", fn, (x,))


def maxout(x, groups, axis=1, name=None):
    def fn(v):
        ax = axis % v.dim()
        c = v.shape[ax]
        shape = tuple(v.shape[:ax]) + (c // groups, groups) + tuple(
            v.shape[ax + 1:])
        return torch.amax(v.reshape(shape), dim=ax + 1)
    return apply_op("maxout", fn, (x,))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` from
    the global generator; straight-through one-hot when ``hard``."""
    def fn(v):
        u = torch.rand(v.shape, generator=generator_for(v.device),
                       device=v.device, dtype=torch.float32)
        g = -torch.log(-torch.log(u.clamp_min(1e-20)).clamp_min(1e-20))
        soft = torch.softmax((v.float() + g) / temperature, dim=axis)
        if hard:
            idx = soft.argmax(dim=axis, keepdim=True)
            oh = torch.zeros_like(soft).scatter_(axis, idx, 1.0)
            soft = (oh - soft).detach() + soft
        return soft.to(v.dtype)
    return apply_op("gumbel_softmax", fn, (x,))
