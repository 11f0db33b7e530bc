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
