"""The matmul family of the linear-algebra ops (counterpart of the first
part of ``paddle_tpu/ops/linalg.py``): matmul with ``transpose_x/y``,
mm, bmm, dot, mv, addmm, einsum and t.  The operands promote on the
reference's lattice first (bf16 with fp32 gives fp32).  The rest of
``linalg`` is a later slice."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from .registry import register, register_op
from ._helpers import promote, targ


@register_op("matmul", category="linalg", tensor_method=True)
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``paddle.matmul`` (one GEMM; under ``auto_cast`` it is on the white
    list)."""
    def fn(a, b):
        a, b = promote(a, b)
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op("matmul", fn, (x, targ(y)))


register("mm", matmul, category="linalg", tensor_method=True,
         method_name="mm")


@register_op("dot", category="linalg", tensor_method=True)
def dot(x, y, name=None):
    def fn(a, b):
        a, b = promote(a, b)
        return torch.sum(a * b, dim=-1)
    return apply_op("dot", fn, (x, targ(y)))


@register_op("bmm", category="linalg", tensor_method=True)
def bmm(x, y, name=None):
    return apply_op("bmm", lambda a, b: torch.matmul(*promote(a, b)),
                    (x, targ(y)))


@register_op("mv", category="linalg", tensor_method=True)
def mv(x, vec, name=None):
    return apply_op("mv", lambda a, b: torch.matmul(*promote(a, b)),
                    (x, targ(vec)))


@register_op("t", category="linalg", tensor_method=True)
def t(input, name=None):
    return apply_op("t", lambda v: v.clone() if v.dim() < 2
                    else v.transpose(0, 1), (input,))


@register_op("addmm", category="linalg", tensor_method=True)
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    def fn(i, a, b):
        i, a, b = promote(i, a, b)
        return beta * i + alpha * torch.matmul(a, b)
    return apply_op("addmm", fn, (input, targ(x), targ(y)))


@register_op("einsum", category="linalg")
def einsum(equation, *operands, name=None):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply_op("einsum",
                    lambda *vs: torch.einsum(equation, *promote(*vs)),
                    operands)
