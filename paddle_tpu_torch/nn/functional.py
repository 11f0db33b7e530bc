"""Functional ops of the Llama path (counterparts of
``paddle_tpu/nn/functional`` and ``paddle_tpu/incubate/nn/functional``).

Each keeps the reference's order of operations, so fp32 results agree
with it to rounding and the eager model stays the oracle the serving
engine is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.kernels import _rope_rows, rope_tables_for_positions


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics for bf16/fp16 inputs, cast back to the
    input dtype before the weight multiply (reference:
    ``nn/functional/norm.py`` ``rms_norm``)."""
    compute = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    ms = compute.square().mean(dim=-1, keepdim=True)
    out = (compute * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``silu(x) * y`` — the Llama MLP gate (reference:
    ``nn/functional/activation.py`` ``swiglu``)."""
    return F.silu(x) * y


def fused_rotary_position_embedding(q: torch.Tensor, k: torch.Tensor,
                                    position_offset: int = 0,
                                    rotary_emb_base: float = 10000.0):
    """Neox RoPE on ``q``/``k`` [B, S, H, D] at positions
    ``position_offset + arange(S)`` (reference:
    ``incubate/nn/functional`` ``fused_rotary_position_embedding``, neox
    style, no explicit tables).  Same op order as the reference: rotate in
    fp32 as ``t*cos + rot*sin``, then cast back."""
    B, S, _, D = q.shape
    pos = torch.arange(position_offset, position_offset + S,
                       dtype=torch.int32, device=q.device)
    cos, sin = rope_tables_for_positions(pos, D, rotary_emb_base)

    def rope(t):
        rows = _rope_rows(t.reshape(B * S, -1, D),
                          cos.repeat(B, 1), sin.repeat(B, 1))
        return rows.reshape(t.shape).to(t.dtype)

    return rope(q), rope(k)


class _SoftmaxXent(torch.autograd.Function):
    """Per-row softmax cross-entropy for hard labels (reference:
    ``_fused_softmax_xent``): fp32 statistics, only the row lse saved, and
    the gradient ``(softmax - onehot) * g`` emitted in the logits' dtype
    (no fp32 [N, V] residual)."""

    @staticmethod
    def forward(ctx, logits, safe_idx, valid):
        xm = logits.amax(dim=-1).to(torch.float32)
        s = torch.exp(logits.to(torch.float32) - xm[:, None]).sum(dim=-1)
        lse = torch.log(s) + xm
        picked = logits.gather(1, safe_idx[:, None])[:, 0].to(torch.float32)
        ctx.save_for_backward(logits, safe_idx, valid, lse)
        return torch.where(valid, lse - picked, 0.0)

    @staticmethod
    def backward(ctx, g):
        logits, safe_idx, valid, lse = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - lse[:, None])
        p.scatter_add_(1, safe_idx[:, None],
                       torch.full_like(lse[:, None], -1.0))
        p *= (g * valid.to(torch.float32))[:, None]
        return p.to(logits.dtype), None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean softmax cross-entropy over the rows whose label is not
    ``ignore_index`` (reference: ``nn/functional/loss.py``
    ``cross_entropy``, hard labels, ``reduction="mean"``): ``logits``
    [N, V] in any float dtype, ``labels`` [N] int; the softmax runs in
    fp32, the loss is fp32 and the gradient is in the logits' dtype."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    loss = _SoftmaxXent.apply(logits, safe, valid)
    return loss.sum() / torch.clamp(valid.to(torch.float32).sum(), min=1.0)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor) -> torch.Tensor:
    """Causal attention, bottom-right aligned (a query row ``i`` of ``Sq``
    sees keys ``<= i + Sk - Sq``), inputs ``[B, S, H, D]`` (reference:
    ``nn/functional/common.py`` ``scaled_dot_product_attention``, its XLA
    path: scores scaled after the product, fp32 softmax, probabilities
    cast back to the input dtype)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (qt @ kt.transpose(-1, -2) * scale).float()
    sq, sk = logits.shape[-2], logits.shape[-1]
    causal = torch.ones(sq, sk, dtype=torch.bool,
                        device=q.device).tril(sk - sq)
    logits = logits.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return (probs @ vt).transpose(1, 2)
