"""Elementwise math ops (counterpart of ``paddle_tpu/ops/math.py``).

Each op is a PyTorch function behind ``apply_op``; the operands promote
on the reference's lattice first, and an op the reference computes in an
inexact type takes int inputs there (``to_inexact``), so the output dtype
is the reference's, not torch's.
"""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from .registry import register, register_op
from ._helpers import (as_value, def_binary, def_unary, inexact, promote,
                       targ)


def _keep_int(f):
    """``f`` for floats; an int tensor passes as a copy (ceil, floor,
    trunc and round of an int are the int)."""
    def g(v):
        return f(v) if v.is_floating_point() or v.is_complex() \
            else v.clone()
    return g


def _reciprocal(v):
    if v.is_floating_point() or v.is_complex():
        return torch.reciprocal(v)
    return torch.div(torch.ones_like(v), v, rounding_mode="trunc")


def _same(v):
    return v.conj() if v.is_complex() else v.clone()


def _imag(v):
    # zeros for a real input, with the reference's (zero) gradient edge
    return torch.imag(v) if v.is_complex() else v * 0


def _real(v):
    return torch.real(v) if v.is_complex() else v.clone()


# (torch function, takes an int input to the inexact dtype first)
_UNARY = {
    "abs": (torch.abs, False),
    "acos": (torch.acos, True),
    "asin": (torch.asin, True),
    "atan": (torch.atan, True),
    "acosh": (torch.acosh, True),
    "asinh": (torch.asinh, True),
    "atanh": (torch.atanh, True),
    "ceil": (_keep_int(torch.ceil), False),
    "floor": (_keep_int(torch.floor), False),
    "cos": (torch.cos, True),
    "cosh": (torch.cosh, True),
    "sin": (torch.sin, True),
    "sinh": (torch.sinh, True),
    "tan": (torch.tan, True),
    "tanh": (torch.tanh, True),
    "exp": (torch.exp, True),
    "expm1": (torch.expm1, True),
    "log": (torch.log, True),
    "log2": (torch.log2, True),
    "log10": (torch.log10, True),
    "log1p": (torch.log1p, True),
    "sqrt": (torch.sqrt, True),
    "rsqrt": (torch.rsqrt, True),
    "square": (torch.square, False),
    "reciprocal": (_reciprocal, False),
    "sign": (torch.sign, False),
    "erf": (torch.erf, True),
    "erfinv": (torch.erfinv, True),
    "sigmoid": (torch.sigmoid, True),
    "lgamma": (torch.lgamma, True),
    "digamma": (torch.digamma, True),
    "i0": (torch.i0, True),
    "i0e": (torch.special.i0e, True),
    "i1": (torch.special.i1, True),
    "i1e": (torch.special.i1e, True),
    "angle": (torch.angle, True),
    "conj": (_same, False),
    "trunc": (_keep_int(torch.trunc), False),
    "frac": (lambda v: v - _keep_int(torch.trunc)(v), False),
    "neg": (torch.neg, False),
    "deg2rad": (torch.deg2rad, True),
    "rad2deg": (torch.rad2deg, True),
}
for _n, (_f, _inx) in _UNARY.items():
    globals()[_n] = def_unary(_n, _f, to_inexact=_inx)

# predicates: bool outputs, no gradient
_UNARY_PRED = {
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
    "isneginf": torch.isneginf,
    "isposinf": torch.isposinf,
    "isreal": torch.isreal,
    "signbit": lambda v: torch.signbit(v) if not v.is_complex()
    else torch.signbit(v.real),
}
for _n, _f in _UNARY_PRED.items():
    globals()[_n] = def_unary(_n, _f, category="logic", inplace=False)


@register_op("round", category="math", tensor_method=True, inplace_alias=True)
def round(x, decimals=0, name=None):
    return apply_op("round", _keep_int(
        lambda v: torch.round(v, decimals=decimals)), (x,))


def _polygamma(x, n):
    return torch.special.polygamma(int(n), inexact(x))


def _ldexp(x, e):
    x = inexact(x)
    return x * torch.pow(2.0, e.to(x.dtype))


def _heaviside(x, y):
    return torch.where(x == 0, y, (x > 0).to(x.dtype))


def _floor_divide(a, b):
    if a.is_floating_point():
        # floor(a / b) as the reference's; its gradient is zero
        return torch.floor(a / b)
    return torch.floor_divide(a, b)


def _nextafter(a, b):
    return torch.nextafter(inexact(a), inexact(b))


# (torch function, inexact): the binary table
_BINARY = {
    "add": (torch.add, False),
    "subtract": (torch.sub, False),
    "multiply": (torch.mul, False),
    "divide": (torch.div, True),
    "floor_divide": (_floor_divide, False),
    "mod": (torch.remainder, False),
    "remainder": (torch.remainder, False),
    "floor_mod": (torch.remainder, False),
    "maximum": (torch.maximum, False),
    "minimum": (torch.minimum, False),
    "fmax": (torch.fmax, False),
    "fmin": (torch.fmin, False),
    "atan2": (torch.atan2, True),
    "logaddexp": (torch.logaddexp, True),
    "hypot": (torch.hypot, True),
    "copysign": (torch.copysign, True),
    "nextafter": (_nextafter, True),
    "heaviside": (_heaviside, False),
    "gcd": (torch.gcd, False),
    "lcm": (torch.lcm, False),
}
for _n, (_f, _inx) in _BINARY.items():
    globals()[_n] = def_binary(_n, _f, to_inexact=_inx)


def _unpromoted_binary(name, fn):
    """A binary op whose operands keep their own dtypes (``ldexp``'s
    exponent, ``polygamma``'s order)."""
    def op(x, y, name=None):
        return apply_op(op.__op_name__, fn, (targ(x), targ(y)))
    op.__op_name__ = name
    op.__name__ = op.__qualname__ = name
    register(name, op, category="math", tensor_method=True,
             inplace_alias=True)
    return op


ldexp = _unpromoted_binary("ldexp", _ldexp)
polygamma = _unpromoted_binary("polygamma", _polygamma)


def _logical(f):
    return lambda a, b: f(a, b)


_BINARY_PRED = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
    "less_than": torch.lt,
    "less_equal": torch.le,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "bitwise_left_shift": torch.bitwise_left_shift,
    "bitwise_right_shift": torch.bitwise_right_shift,
}
for _n, _f in _BINARY_PRED.items():
    globals()[_n] = def_binary(_n, _f, category="logic", inplace=False)

globals()["logical_not"] = def_unary("logical_not", torch.logical_not,
                                     category="logic", inplace=False)
globals()["bitwise_not"] = def_unary("bitwise_not", torch.bitwise_not,
                                     category="logic", inplace=False)


@register_op("pow", category="math", tensor_method=True, inplace_alias=True)
def pow(x, y, name=None):
    return apply_op("pow", lambda a, b: torch.pow(*promote(a, b)),
                    (x, targ(y)))


@register_op("scale", category="math", tensor_method=True, inplace_alias=True)
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    """``paddle.scale``: ``x * scale + bias`` (or ``(x + bias) * scale``)."""
    def fn(v, s, b):
        v, s, b = promote(v, s, b)
        return v * s + b if bias_after_scale else (v + b) * s
    return apply_op("scale", fn, (x, targ(scale), targ(bias)))


@register_op("clip", category="math", tensor_method=True, inplace_alias=True)
def clip(x, min=None, max=None, name=None):
    has_lo, has_hi = min is not None, max is not None

    def fn(v, *bounds):
        v, *bounds = promote(v, *bounds)
        if has_lo:
            v = torch.maximum(v, bounds[0])
        if has_hi:
            v = torch.minimum(v, bounds[-1])
        return v
    bounds = tuple(as_value(b) for b in (min, max) if b is not None)
    return apply_op("clip", fn, (x,) + bounds)


clamp = clip
register("clamp", clip, category="math", tensor_method=True,
         method_name="clamp")


@register_op("stanh", category="math", tensor_method=True)
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op("stanh",
                    lambda v: scale_b * torch.tanh(scale_a * inexact(v)),
                    (x,))


@register_op("multiplex", category="math")
def multiplex(inputs, index, name=None):
    def fn(idx, *xs):
        stacked = torch.stack(promote(*xs), dim=0)
        i = idx.reshape(-1).to(torch.int64).reshape(
            [1, -1] + [1] * (stacked.dim() - 2)).expand(
            (1,) + tuple(stacked.shape[1:]))
        return torch.gather(stacked, 0, i)[0]
    return apply_op("multiplex", fn, (targ(index), *inputs))


@register_op("add_n", category="math")
def add_n(inputs, name=None):
    """``paddle.add_n``: the sum of a list of tensors."""
    if isinstance(inputs, Tensor):
        inputs = [inputs]

    def fn(*xs):
        xs = promote(*xs)
        out = xs[0]
        for v in xs[1:]:
            out = out + v
        return out
    return apply_op("add_n", fn, tuple(inputs))


@register_op("nan_to_num", category="math", tensor_method=True,
             inplace_alias=True)
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op("nan_to_num",
                    lambda v: torch.nan_to_num(v, nan=nan, posinf=posinf,
                                               neginf=neginf), (x,))


@register_op("lerp", category="math", tensor_method=True, inplace_alias=True)
def lerp(x, y, weight, name=None):
    def fn(a, b, w):
        a, b, w = promote(a, b, w)
        return a + w * (b - a)
    return apply_op("lerp", fn, (x, targ(y), targ(weight)))


@register_op("logit", category="math", tensor_method=True)
def logit(x, eps=None, name=None):
    def fn(v):
        v = inexact(v)
        if eps is not None:
            v = torch.clamp(v, eps, 1.0 - eps)
        return torch.log(v / (1.0 - v))
    return apply_op("logit", fn, (x,))


@register_op("log_normalize", category="math")
def log_normalize(x, axis=-1, name=None):
    return apply_op("log_normalize",
                    lambda v: v - torch.logsumexp(v, dim=axis, keepdim=True),
                    (x,))


@register_op("real", category="math", tensor_method=True)
def real(x, name=None):
    return apply_op("real", _real, (x,))


@register_op("imag", category="math", tensor_method=True)
def imag(x, name=None):
    return apply_op("imag", _imag, (x,))


@register_op("diff", category="math", tensor_method=True)
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    args = [x] + [targ(t) for t in (prepend, append) if t is not None]

    def fn(v, *extra):
        i, pre, post = 0, None, None
        if prepend is not None:
            pre, i = extra[0], 1
        if append is not None:
            post = extra[i]
        v, pre, post = promote(v, pre, post)
        return torch.diff(v, n=n, dim=axis, prepend=pre, append=post)
    return apply_op("diff", fn, tuple(args))


@register_op("trapezoid", category="math")
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply_op("trapezoid",
                        lambda yy, xx: torch.trapezoid(
                            *promote(inexact(yy), xx), dim=axis),
                        (y, targ(x)))
    d = 1.0 if dx is None else dx
    return apply_op("trapezoid",
                    lambda yy: torch.trapezoid(inexact(yy), dx=d, dim=axis),
                    (y,))
