"""Symmetric-absmax quantization primitives (counterpart of the KV half of
``paddle_tpu/quantization/functional.py``).

One clamp convention everywhere: symmetric around zero with
``bnt = 2**(bits-1) - 1`` levels per side (int8 uses [-127, 127]),
round-half-even (``torch.round``, as ``jnp.round``), and a floor of
1e-30 on the scale so a zero tensor quantizes to zeros, never NaN.
``scale`` is always the absmax of the data (codes are
``x / scale * bnt``).  Every expression keeps the reference's fp32 order
of operations, so the codes and scales are bitwise equal to its.

The int8 KV pools (``ops.paged_attention``) quantize on write with
:func:`quantize_symmetric`, and the int8 attention kernels quantize each
query row and each probability row with :func:`quantize_rows_symmetric`
and fold the scales into their integer products with
:func:`fold_int8_scores`.  Weight PTQ (``quantize_param_tree``) is not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["symmetric_bound", "absmax_scale", "quantize_symmetric",
           "dequantize_symmetric", "quantize_rows_symmetric",
           "fold_int8_scores"]


def symmetric_bound(bits: int = 8) -> int:
    """Largest code magnitude: 127 for int8."""
    return (1 << (int(bits) - 1)) - 1


def absmax_scale(x: torch.Tensor, dim=None, keepdim: bool = False):
    """Absmax over ``dim`` (None = whole tensor) in fp32, with no floor."""
    a = x.to(torch.float32).abs()
    if dim is None:
        return a.amax()
    return a.amax(dim=dim, keepdim=keepdim)


def quantize_symmetric(x: torch.Tensor, scale, bits: int = 8):
    """Codes in [-bnt, bnt] as fp32 (cast at the storage site); ``scale``
    is the absmax and broadcasts against ``x``."""
    bnt = symmetric_bound(bits)
    s = torch.as_tensor(scale, dtype=torch.float32,
                        device=x.device).clamp_min(1e-30)
    return torch.clamp(torch.round(x.to(torch.float32) / s * bnt),
                       -bnt, bnt)


def dequantize_symmetric(q: torch.Tensor, scale, bits: int = 8):
    """Codes and their absmax scale back to fp32 values."""
    bnt = symmetric_bound(bits)
    s = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return q.to(torch.float32) * (s / bnt)


def quantize_rows_symmetric(x: torch.Tensor, bits: int = 8):
    """Per-row codes over the last axis: ``(codes int8 [..., d], scale
    fp32 [..., 1])``, the scale floored so an all-zero row gives zero
    codes.  The attention kernels' operand quantizer: one q row per query
    head, one probability row per page."""
    bnt = symmetric_bound(bits)
    xf = x.to(torch.float32)
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    codes = torch.clamp(torch.round(xf / s * bnt), -bnt, bnt)
    return codes.to(torch.int8), s


def fold_int8_scores(acc: torch.Tensor, q_scale, k_scale,
                     softmax_scale: float = 1.0, bits: int = 8):
    """Fold two absmax scales (and the softmax scale) into the integer
    product of two code matrices: ``acc * (q_scale * (k_scale * c))`` with
    ``c = float32(softmax_scale / bnt**2)``, as the reference computes it.
    ``acc`` holds exact integer sums (any float dtype or int32)."""
    bnt = symmetric_bound(bits)
    c = float(np.float32(float(softmax_scale) / (bnt * bnt)))
    k = torch.as_tensor(k_scale, dtype=torch.float32, device=acc.device)
    mult = torch.as_tensor(q_scale, dtype=torch.float32,
                           device=acc.device) * (k * c)
    return acc.to(torch.float32) * mult
