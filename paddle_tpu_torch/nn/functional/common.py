"""Common functional ops: linear, dropout, embedding, attention and the
rest of ``paddle_tpu/nn/functional/common.py``.

Attention takes the reference's routes, each for its own case, and hides
no error:

- ``FLAGS_use_pallas_kernels`` on, no dropout, no mask: the flash kernels
  (``ops/flash_attention.py::flash_attention``; on the card #1 forward and
  #2 or #3 backward as ``flash_bwd_auto`` picks, or an error; on the CPU
  their plain versions);
- the same with a mask: the masked ``_chunked_sdpa``;
- dropout in training, or the flag off: the einsum path.

The layout is the API's, [B, S, H, D].
"""
from __future__ import annotations

import math as _math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from ...core.flags import get_flag
from ...core.tensor import Tensor
from ...ops import manipulation as _manip
from ...ops import flash_attention as _fa
from ...ops._helpers import promote, targ, wrap
from ...ops.random import generator_for

pad = _manip.pad


def linear(x, weight, bias=None, name=None):
    """``y = x @ W (+ b)`` with ``W`` ``[in, out]``."""
    def fn(v, w, *b):
        v, w, *b = promote(v, w, *b)
        out = torch.matmul(v, w)
        return out + b[0] if b else out
    args = (x, targ(weight)) + ((targ(bias),) if bias is not None else ())
    return apply_op("linear", fn, args)


def _keep_mask(v, p, shape):
    u = torch.rand(shape, generator=generator_for(v.device),
                   device=v.device, dtype=torch.float32)
    return u < (1.0 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and p > 0.0 and not training:
            return apply_op("dropout_infer_scale",
                            lambda v: (v * (1.0 - p)).to(v.dtype), (x,))
        return x if isinstance(x, Tensor) else wrap(targ(x))

    def fn(v):
        shape = list(v.shape)
        if axis is not None:
            axes = [axis] if isinstance(axis, int) else list(axis)
            shape = [s if i in axes else 1 for i, s in enumerate(v.shape)]
        keep = _keep_mask(v, p, shape)
        if mode == "upscale_in_train":
            return torch.where(keep, v / (1.0 - p), 0.0).to(v.dtype)
        return torch.where(keep, v, 0.0).to(v.dtype)
    return apply_op("dropout", fn, (x,))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805

    def fn(v):
        keep = _keep_mask(v, p, v.shape)
        a = (1.0 / _math.sqrt((1 - p) * (1 + p * alpha_p ** 2))) \
            if p < 1 else 0.0
        b = -a * alpha_p * p
        return (a * torch.where(keep, v, alpha_p) + b).to(v.dtype)
    return apply_op("alpha_dropout", fn, (x,))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row lookup of ``weight`` [V, D] (a padding index gives zeros)."""
    def fn(idx, w):
        idx = idx.to(torch.int64)
        out = TF.embedding(idx, w)
        if padding_idx is not None:
            out = torch.where((idx == padding_idx)[..., None], 0.0, out)
        return out
    return apply_op("embedding", fn, (targ(x), weight))


def one_hot(x, num_classes, name=None):
    from ...ops.creation import one_hot as _oh
    return _oh(x, num_classes)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def fn(l, *pd):
        if pd:
            return (1 - epsilon) * l + epsilon * pd[0]
        return (1 - epsilon) * l + epsilon / l.shape[-1]
    args = (label,) + ((targ(prior_dist),) if prior_dist is not None else ())
    return apply_op("label_smooth", fn, args)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def fn(a, b):
        a, b = promote(a, b)
        dot = torch.sum(a * b, dim=axis)
        na = torch.sqrt(torch.sum(a * a, dim=axis))
        nb = torch.sqrt(torch.sum(b * b, dim=axis))
        return dot / torch.clamp(na * nb, min=eps)
    return apply_op("cosine_similarity", fn, (x1, targ(x2)))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def fn(v):
        n = torch.pow(torch.sum(torch.pow(torch.abs(v), p), dim=axis,
                                keepdim=True), 1.0 / p)
        return v / torch.clamp(n, min=epsilon)
    return apply_op("normalize", fn, (x,))


def bilinear(x1, x2, weight, bias=None, name=None):
    def fn(a, b, w, *bs):
        a, b, w, *bs = promote(a, b, w, *bs)
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + bs[0] if bs else out
    args = (x1, targ(x2), targ(weight)) + (
        (targ(bias),) if bias is not None else ())
    return apply_op("bilinear", fn, args)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _flash_route(query, key, value, attn_mask, is_causal):
    """The reference's ``flash_attention_tpu``: the flash kernels without
    a mask, the masked ``_chunked_sdpa`` with one."""
    def fn(q, k, v, *m):
        q, k, v = promote(q, k, v)
        if m:
            return _fa._chunked_sdpa(q, k, v, is_causal, mask=m[0])
        return _fa.flash_attention(q, k, v, is_causal)
    args = (query, targ(key), targ(value))
    if attn_mask is not None:
        args = args + (targ(attn_mask),)
    return apply_op("flash_attention_pallas", fn, args)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over the API layout [B, S, H, D] (the routes are in the
    module's docstring)."""
    use_dropout = dropout_p > 0.0 and training
    if get_flag("use_pallas_kernels") and not use_dropout:
        return _flash_route(query, key, value, attn_mask, is_causal)

    def fn(q, k, v, *m):
        q, k, v = promote(q, k, v)
        q_, k_, v_ = (t.transpose(1, 2) for t in (q, k, v))
        scale = 1.0 / _math.sqrt(q.shape[-1])
        logits = (torch.einsum("bhqd,bhkd->bhqk", q_, k_) * scale).to(
            torch.float32)
        if is_causal:
            sq, sk = logits.shape[-2], logits.shape[-1]
            causal = torch.ones(sq, sk, dtype=torch.bool,
                                device=q.device).tril(sk - sq)
            logits = logits.masked_fill(~causal, float("-inf"))
        if m:
            mask = m[0]
            if mask.dtype == torch.bool:
                logits = logits.masked_fill(~mask, float("-inf"))
            else:
                logits = logits + mask.to(torch.float32)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        if use_dropout:
            keep = _keep_mask(probs, dropout_p, probs.shape)
            probs = torch.where(keep, probs / (1.0 - dropout_p),
                                0.0).to(probs.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v_)
        return out.transpose(1, 2)

    args = (query, targ(key), targ(value)) + (
        (targ(attn_mask),) if attn_mask is not None else ())
    return apply_op("scaled_dot_product_attention", fn, args)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """``F.flash_attention``: ``(out, None)``, as the reference."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def _pair(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C*kh*kw, L]``."""
    k, s, p, d = (_pair(t, 2) for t in (kernel_sizes, strides, paddings,
                                         dilations))
    return apply_op("unfold", lambda v: TF.unfold(
        v, k, dilation=d, padding=p, stride=s), (x,))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    out, k, s, p, d = (_pair(t, 2) for t in (
        output_sizes, kernel_sizes, strides, paddings, dilations))
    return apply_op("fold", lambda v: TF.fold(
        v, out, k, dilation=d, padding=p, stride=s), (x,))


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def fn(v):
        if data_format == "NCHW":
            N, C, H, W = v.shape
            out = v.reshape(N, C // (r * r), r, r, H, W)
            return out.permute(0, 1, 4, 2, 5, 3).reshape(
                N, C // (r * r), H * r, W * r)
        N, H, W, C = v.shape
        out = v.reshape(N, H, W, r, r, C // (r * r))
        return out.permute(0, 1, 3, 2, 4, 5).reshape(
            N, H * r, W * r, C // (r * r))
    return apply_op("pixel_shuffle", fn, (x,))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def fn(v):
        if data_format == "NCHW":
            N, C, H, W = v.shape
            out = v.reshape(N, C, H // r, r, W // r, r)
            return out.permute(0, 1, 3, 5, 2, 4).reshape(
                N, C * r * r, H // r, W // r)
        N, H, W, C = v.shape
        out = v.reshape(N, H // r, r, W // r, r, C)
        return out.permute(0, 2, 4, 1, 3, 5).reshape(
            N, H // r, W // r, C * r * r)
    return apply_op("pixel_unshuffle", fn, (x,))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize: nearest (half-pixel centres, as the reference's
    ``jax.image``), linear/bilinear/trilinear (half-pixel, or
    corner-aligned with ``align_corners``), bicubic (:func:`_cubic_resize`)
    and area (adaptive average pooling)."""
    channel_last = not data_format.startswith("NC")

    def fn(v):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        nd = v.dim() - 2
        spatial = tuple(v.shape[2:])
        if size is not None:
            tgt = tuple(int(s) for s in (
                size if isinstance(size, (list, tuple)) else [size] * nd))
        else:
            sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
                else [scale_factor] * nd
            tgt = tuple(int(s * f) for s, f in zip(spatial, sf))
        if mode == "bicubic":
            out = _cubic_resize(v, tgt, align_corners).to(v.dtype)
        elif mode == "area":
            out = TF.adaptive_avg_pool1d(v, tgt) if nd == 1 else (
                TF.adaptive_avg_pool2d(v, tgt) if nd == 2
                else TF.adaptive_avg_pool3d(v, tgt))
        elif mode == "nearest":
            out = TF.interpolate(v, size=tgt, mode="nearest-exact")
        else:
            tmode = {1: "linear", 2: "bilinear", 3: "trilinear"}[nd]
            out = TF.interpolate(v.to(torch.float32), size=tgt, mode=tmode,
                                 align_corners=bool(align_corners),
                                 antialias=not align_corners and any(
                                     t < s for t, s in zip(tgt, spatial))
                                 and nd == 2).to(v.dtype)
        return torch.movedim(out, 1, -1) if channel_last else out
    return apply_op("interpolate", fn, (x,))


def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5 (torch's bicubic takes a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(in_size, out_size, inv_scale, translation, antialias,
                   device, dtype):
    """The ``[in, out]`` resampling matrix of one dim, as
    ``jax.image.compute_weight_mat`` builds it: the kernel at each output
    sample's distance to each input pixel (widened by the inverse scale
    when an antialiased resize shrinks), each column renormalised, and
    columns whose sample falls outside the input zeroed, in ``dtype``."""
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=dtype, device=device) + 0.5) \
        * inv_scale - translation * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(
        in_size, dtype=dtype, device=device)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(
        np.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    keep = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(keep[None, :], w, 0.0)


def _cubic_resize(v, tgt, align_corners):
    """Bicubic resize of ``v`` [N, C, *sp] to ``tgt``, the reference's
    way: ``jax.image.resize`` (half-pixel centres, antialiased when it
    shrinks, only the dims whose size changes), or with
    ``align_corners`` ``scale_and_translate`` at scale ``(out - 1) / (in -
    1)`` and translation ``(1 - scale) / 2``, no antialiasing, in fp32."""
    f32 = torch.float32
    spatial = tuple(v.shape[2:])
    if align_corners:
        v = v.to(f32)
    out = v
    for i, (n, o) in enumerate(zip(spatial, tgt)):
        if align_corners:
            # float32 scales, as the reference passes them
            scale = torch.tensor((o - 1) / (n - 1) if n > 1 else 1.0,
                                 dtype=f32, device=v.device)
            w = _cubic_weights(n, o, 1.0 / scale, 0.5 * (1.0 - scale),
                               False, v.device, f32)
        elif n == o:
            continue
        else:
            # Python-float scales: float64 under the reference's x64
            w = _cubic_weights(n, o, torch.tensor(
                n / o, dtype=torch.float64, device=v.device), 0.0, True,
                v.device, torch.float64)
        out = torch.movedim(torch.matmul(torch.movedim(out, 2 + i, -1),
                                         w.to(out.dtype)), -1, 2 + i)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Pad H and W with zeros; ``padding`` an int, ``[left, right, top,
    bottom]`` or a tensor."""
    if hasattr(padding, "numpy"):
        padding = padding.numpy().tolist()
    if isinstance(padding, (int, np.integer)):
        padding = [padding] * 4
    return pad(x, [int(p) for p in padding], mode="constant", value=0.0,
               data_format=data_format)
