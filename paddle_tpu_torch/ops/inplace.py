"""The top-level in-place ops, ``paddle.<op>_`` (counterpart of
``paddle_tpu/ops/inplace.py``): compute, then rebind the Tensor
(``Tensor._inplace_assign``), as the reference does and as the Tensor
method variants the registry makes do."""
from __future__ import annotations

from typing import Callable, Dict

from . import registry

# ops the reference exposes with a top-level trailing-underscore variant
_INPLACE_NAMES = [
    "abs", "acos", "acosh", "addmm", "asin", "asinh", "atan", "atanh",
    "ceil", "clip", "cos", "cosh", "cumprod", "cumsum", "digamma",
    "divide", "equal", "erf", "erfinv", "exp", "expm1", "fill_diagonal",
    "flatten", "floor", "floor_divide", "frac", "gammaln", "gcd",
    "greater_equal", "greater_than", "hypot", "i0", "index_add",
    "index_put", "lcm", "ldexp", "lerp", "less_equal", "less_than",
    "lgamma", "log", "log10", "log1p", "log2", "logical_and",
    "logical_not", "logical_or", "logical_xor", "logit", "masked_fill",
    "multiply", "nan_to_num", "neg", "not_equal", "pow", "put_along_axis",
    "reciprocal", "remainder", "renorm", "round", "rsqrt", "scatter",
    "sigmoid", "sin", "sinh", "sqrt", "square", "squeeze", "subtract",
    "t", "tan", "tanh", "tril", "triu", "trunc", "unsqueeze", "where",
    "floor_mod", "mod", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "cast", "transpose", "reshape", "polygamma",
    "copysign", "bitwise_left_shift", "bitwise_right_shift",
    "masked_scatter",
]


def _make(fn: Callable) -> Callable:
    def inplace(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        return x._inplace_assign(out)

    inplace.__doc__ = (f"In-place variant of {fn.__name__} "
                       "(compute, then rebind).")
    inplace.__name__ = fn.__name__ + "_"
    return inplace


def build() -> Dict[str, Callable]:
    ops = registry.registered_ops()
    out = {}
    for name in _INPLACE_NAMES:
        opdef = ops.get(name)
        if opdef is not None:
            out[name + "_"] = _make(opdef.fn)
    return out
