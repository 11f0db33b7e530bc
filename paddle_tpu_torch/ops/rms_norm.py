"""Row-wise RMSNorm (counterpart of the rms_norm section of
``paddle_tpu/ops/pallas_kernels.py``).

Kernel: ``csrc/rms_norm.cu`` replaces ``_rms_kernel`` (launched by
``rms_norm_tpu``).  It computes ``x * rsqrt(mean(x^2) + eps) * w`` in fp32
and rounds once to ``x``'s dtype.  That is where this norm differs from
``nn.functional.rms_norm`` and the reference's layerwise ``_rms_norm``,
which round before the weight multiply: equal in fp32 and, at ``w = 1``,
in bf16 too; otherwise at most one bf16 ulp apart.  ``round_first=True``
selects the kernel's variant with the layerwise rounding point,
``round(x * rsqrt(mean(x^2) + eps)) * w`` rounded again, which the port's
layerwise step runs (the reference's ``_rms_norm`` has no kernel).

Bound on the H100: bytes (one read and one write of each element, a few
fp32 operations).  The design is one block per row with 16-byte vector
accesses and a warp-shuffle reduction; see the source's header.

The JAX package has no backward kernel for this norm, so
:class:`RMSNormKernel` computes the gradient in plain PyTorch, in fp32,
from the saved input and weight (with ``round_first``, through the
rounded normalised input, as ``jax.vjp`` of ``_rms_norm`` does).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                    round_first: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel (reference: ``_rms_kernel``):
    fp32 mean of squares over the last axis, ``x * rsqrt(ms + eps) * w`` in
    fp32, one cast to ``x``'s dtype.  ``round_first``: the layerwise
    variant (reference: ``paddle_tpu/jit/layerwise.py::_rms_norm``), the
    normalised ``x`` cast to its dtype before the weight multiply."""
    x32 = x.to(torch.float32)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    n = x32 * torch.rsqrt(ms + eps)
    if round_first:
        n = n.to(x.dtype).to(torch.float32)
    return (n * weight.to(torch.float32)).to(x.dtype)


def _entry():
    fn = _build.load("rms_norm").ptt_rms_norm
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def rms_norm_tpu(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                 block_rows: int = 512,
                 round_first: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any leading shape, viewed as
    rows x d) with ``weight`` [d] of ``x``'s dtype (float32 or bfloat16).
    ``block_rows`` is the reference's TPU row tiling, kept for its
    signature; it does not change the result and the kernel ignores it.
    ``round_first`` selects the layerwise rounding point (module
    docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  ``.launches`` counts the launches."""
    if x.device.type == "cpu":
        return _rms_norm_plain(x, weight, eps, round_first)
    if x.device.type != "cuda":
        raise ValueError("rms_norm_tpu: unsupported device %s" % x.device)
    d = x.shape[-1] if x.dim() else 0
    rows = x.numel() // d if d else 0
    if rows == 0 or weight.shape != (d,):
        raise ValueError("rms_norm_tpu: needs a non-empty x [..., d] and "
                         "weight [d]; got x %s weight %s"
                         % (tuple(x.shape), tuple(weight.shape)))
    if x.dtype not in _DTYPE_CODE or weight.dtype != x.dtype:
        raise ValueError("rms_norm_tpu: x and weight must share one dtype "
                         "of float32/bfloat16; got %s %s"
                         % (x.dtype, weight.dtype))
    for name, t in (("x", x), ("weight", weight)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("rms_norm_tpu: %s must be a contiguous tensor "
                             "on %s" % (name, x.device))
    out = torch.empty_like(x)
    code = _entry()(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
                    float(eps), _DTYPE_CODE[x.dtype], int(round_first),
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "rms_norm_tpu")
    rms_norm_tpu.launches += 1
    return out


rms_norm_tpu.launches = 0


def _rms_norm_vjp(x, weight, g, eps, round_first: bool = False):
    """The gradients of ``(x32 * rsqrt(mean(x32^2) + eps) * w32).to(dtype)``
    for the output gradient ``g``, in fp32, cast to ``x``'s and ``weight``'s
    dtypes: ``dx = r*(g*w) - x*r^3*mean(g*w*x)``, ``dw = sum(g*x*r)`` over
    the rows.  ``round_first`` follows the layerwise form's roundings:
    ``n = round(x*r)`` and ``g*w`` are rounded to the dtype (the
    products in the dtype), and ``dw = sum(round(g*n))``."""
    dt = x.dtype
    x32, w32, g32 = (t.to(torch.float32) for t in (x, weight, g))
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    gw = g32 * w32
    n = x32 * r
    if round_first:
        gw = gw.to(dt).to(torch.float32)
        n = (g32 * n.to(dt).to(torch.float32)).to(dt).to(torch.float32)
    else:
        n = g32 * n
    dx = r * gw - x32 * (r * r * r) * (gw * x32).mean(dim=-1, keepdim=True)
    dw = n.reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(dt), dw.to(weight.dtype)


class RMSNormKernel(torch.autograd.Function):
    """:func:`rms_norm_tpu` with a gradient: the forward launches the
    kernel (the plain version on the CPU), the backward is
    :func:`_rms_norm_vjp` from the saved ``x`` and ``weight``."""

    @staticmethod
    def forward(ctx, x, weight, eps: float, round_first: bool = False):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.round_first = eps, round_first
        return rms_norm_tpu(x, weight, eps, round_first=round_first)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _rms_norm_vjp(x, weight, g, ctx.eps, ctx.round_first)
        return dx, dw, None, None
