"""Symmetric-absmax quantization primitives (counterpart of
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
:func:`fold_int8_scores`.  The serving engine's weight PTQ
(``weight_quant="int8"``) quantizes the projection weights once with
:func:`quantize_param_tree` (per output channel), and the steps
dequantize them on use (``ops/dequant.py``, the expression of
:func:`dequantize_param_tree`).

Layout: the port's ``Linear`` weight is torch's ``[out, in]`` where the
reference's is ``[in, out]``, so the per-output-channel absmax runs over
dim 1 here and over axis 0 there; codes and scales are bitwise the
reference's, transposed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["symmetric_bound", "absmax_scale", "quantize_symmetric",
           "dequantize_symmetric", "quantize_rows_symmetric",
           "fold_int8_scores", "WEIGHT_SCALE_SUFFIX", "is_weight_scale_key",
           "ptq_quantizable", "quantize_param_tree", "dequantize_weight",
           "dequantize_param_tree", "tp_scale_reduce",
           "ensure_quant_specs"]

# the serving PTQ tree stores each quantized weight's per-channel absmax
# next to it under this suffixed key ("<param>::scale")
WEIGHT_SCALE_SUFFIX = "::scale"

# weight families eligible for serving PTQ: the 2-D projection matmuls.
# Embeddings stay fp (a lookup, and a tied lm_head samples from the fp
# table); norms and biases are 1-D.
_PTQ_FAMILIES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj", "lm_head")

# 3-D batched MoE expert banks [E, in, out] (the reference's layout in
# both packages): quantized per expert and output channel
_PTQ_EXPERT_FAMILIES = ("w_gate", "w_up", "w_down")


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


# ---------------------------------------------------------------------------
# serving PTQ: per-output-channel int8 weight tree
# ---------------------------------------------------------------------------
def is_weight_scale_key(key: str) -> bool:
    return key.endswith(WEIGHT_SCALE_SUFFIX)


def ptq_quantizable(key: str, value) -> bool:
    """2-D projection weights (``_PTQ_FAMILIES``) and 3-D batched expert
    banks (``_PTQ_EXPERT_FAMILIES``)."""
    if is_weight_scale_key(key):
        return False
    ndim = getattr(value, "ndim", 0)
    if key.endswith("weight") and ndim == 2:
        return any(f in key for f in _PTQ_FAMILIES)
    if ndim == 3:
        return any(key.endswith(f) for f in _PTQ_EXPERT_FAMILIES)
    return False


def quantize_param_tree(values: Dict[str, torch.Tensor],
                        bits: int = 8, scale_reduce=None
                        ) -> Dict[str, torch.Tensor]:
    """Per-output-channel absmax PTQ over a serving state dict.

    Linear weights are ``[out, in]``: each output channel (row) gets its
    own absmax scale (a dim-1 reduction -> an ``[out]`` fp32 vector
    stored at ``key + WEIGHT_SCALE_SUFFIX``), and the weight itself is
    replaced by its int8 codes.  An expert bank ``[E, in, out]`` gets one
    scale per expert and output channel, the absmax over its contraction
    dim, stored full-rank as ``[E, 1, out]`` (the reference's codes and
    scales, in the reference's layout).  Everything else passes through
    as it is.

    ``scale_reduce(key, scale)``, when given, returns the scale to use
    for ``key`` from this tensor's own absmax: a tp rank holding a
    row-sharded weight (o_proj, down) has only part of each channel's
    contraction dim, and reduces the max over the tp ranks there, so its
    codes are the slice of the one-card tree's."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in values.items():
        if not ptq_quantizable(k, v):
            out[k] = v
            continue
        # dim 1 is the contraction dim of both layouts
        scale = absmax_scale(v, dim=1, keepdim=True)   # [out, 1] / [E, 1, out]
        if scale_reduce is not None:
            scale = scale_reduce(k, scale)
        out[k] = quantize_symmetric(v, scale, bits).to(torch.int8)
        out[k + WEIGHT_SCALE_SUFFIX] = scale if v.ndim == 3 else scale[:, 0]
    return out


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, dtype,
                      bits: int = 8) -> torch.Tensor:
    """One weight's dequant: ``q.float() * (scale / bnt)`` per output
    channel in fp32, then the cast to ``dtype``: a row of a 2-D ``[out,
    in]`` weight (``scale [out]``), or a column of each expert of a bank
    ``[E, in, out]`` (``scale [E, 1, out]``, broadcast as stored).  The
    division is elementwise between tensors, so it rounds correctly on
    every device (CUDA would turn a division by a Python scalar into a
    multiplication by its reciprocal), as the reference's expression
    does."""
    s = scale.to(torch.float32)
    s = s / torch.full_like(s, float(symmetric_bound(bits)))
    if s.ndim == 1:
        s = s[:, None]
    return (q.to(torch.float32) * s).to(dtype)


def dequantize_param_tree(params: Dict[str, torch.Tensor], dtype,
                          bits: int = 8) -> Dict[str, torch.Tensor]:
    """The dequant-on-use expression over a whole PTQ tree: int8 weights
    times their scale vectors back to ``dtype``
    (:func:`dequantize_weight`), scale keys dropped, everything else
    passed through.  The engine never materializes this tree: its steps
    dequantize one layer at a time (``ops/dequant.py``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if is_weight_scale_key(k):
            continue
        s = params.get(k + WEIGHT_SCALE_SUFFIX)
        out[k] = v if s is None else dequantize_weight(v, s, dtype, bits)
    return out


# ---------------------------------------------------------------------------
# the PTQ tree under tp specs
# ---------------------------------------------------------------------------
def tp_scale_reduce(tp):
    """The ``scale_reduce`` of :func:`quantize_param_tree` for a rank of
    ``tp`` (a ``jit.spmd.TPContext``; None or tp = 1: no reduce): a
    row-sharded weight's per-channel absmax is the max over the tp ranks'
    parts of its contraction dim; a column-sharded weight's channels are
    whole on the rank, and an expert bank's experts too."""
    if tp is None or tp.tp_comm is None:
        return None
    comm = tp.tp_comm

    def reduce(key, scale):
        if "o_proj" in key or "down_proj" in key:
            return comm.all_reduce_max(scale.contiguous())
        return scale
    return reduce


def ensure_quant_specs(tp, qtree_keys) -> None:
    """Register the PTQ tree's keys in ``tp``'s spec table (reference:
    ``_ensure_quant_specs``): codes keep their weight's spec, a
    column-sharded weight's scale vector shards with its channels, a
    row-sharded one's is replicated, an expert bank's ``[E, 1, out]``
    scales shard over ep with their bank.  The codes and scales a rank
    holds are cut by these specs, so ``dequant_int8`` runs on the rank's
    shard.  A no-op without tp."""
    if tp is None:
        return
    from ..jit.spmd import llama_param_specs, mixtral_param_specs
    missing = [k for k in qtree_keys if k not in tp.specs]
    if missing:
        specs_fn = mixtral_param_specs if any(
            "block_sparse_moe" in k for k in qtree_keys) \
            else llama_param_specs
        tp.specs.update(specs_fn(missing, tp.layout))
