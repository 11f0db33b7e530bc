"""Normalization ops (counterpart of
``paddle_tpu/nn/functional/norm.py``).  ``rms_norm`` is plain PyTorch, as
the reference's API function is plain jnp: the RMSNorm kernel (#4) runs
on the layerwise training path, not here."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from ...core.tensor import Tensor
from ...ops._helpers import promote, targ


def _var(v, dims, keepdim):
    m = v.mean(dim=dims, keepdim=True)
    out = ((v - m) ** 2).mean(dim=dims, keepdim=keepdim)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm.  With the running statistics (eval, or
    ``use_global_stats``) it is elementwise; in training without them it
    runs ``torch.nn.functional.batch_norm`` (cuDNN or torch's own kernel on
    the card), which normalises by the batch's mean and biased variance and
    updates the running statistics in place as the reference does,
    ``momentum * old + (1 - momentum) * batch`` with the unbiased batch
    variance — torch's rule at ``momentum' = 1 - momentum``."""
    channel_last = not data_format.startswith("NC")
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    # the buffers the op updates: held here, outside the op's operands,
    # so an AMP cast of the operands never redirects the update to a copy
    update = training and not use_stats and isinstance(
        running_mean, Tensor) and isinstance(running_var, Tensor) \
        and isinstance(x, Tensor)
    has_w, has_b = weight is not None, bias is not None

    def fn(v, mean, var, *wb):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        w = wb[0] if has_w else None
        b = wb[-1] if has_b else None
        if use_stats:
            # elementwise in the statistics too: they may carry gradients
            shape = [1] * v.dim()
            shape[1] = v.shape[1]
            out = (v - mean.reshape(shape)) * torch.rsqrt(
                var.reshape(shape) + epsilon)
            if w is not None:
                out = out * w.reshape(shape)
            if b is not None:
                out = out + b.reshape(shape)
        elif update:
            out = TF.batch_norm(v, running_mean._value, running_var._value,
                                w, b, True, 1.0 - momentum, epsilon)
        else:
            out = TF.batch_norm(v, None, None, w, b, True, 0.0, epsilon)
        return torch.movedim(out, 1, -1) if channel_last else out

    wb = tuple(targ(t) for t in (weight, bias) if t is not None)
    return apply_op("batch_norm", fn,
                    (x, targ(running_mean), targ(running_var)) + wb)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """``(x - mean) * rsqrt(var + eps) * w + b`` over the trailing
    ``normalized_shape`` axes, in the input's dtype (the reference's
    order of operations)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    nd = len(normalized_shape)
    has_w, has_b = weight is not None, bias is not None

    def fn(v, *wb):
        v, *wb = promote(v, *wb)
        axes = tuple(range(v.dim() - nd, v.dim()))
        m = v.mean(dim=axes, keepdim=True)
        var = ((v - m) ** 2).mean(dim=axes, keepdim=True)
        out = (v - m) * torch.rsqrt(var + epsilon)
        i = 0
        if has_w:
            out = out * wb[0]
            i = 1
        if has_b:
            out = out + wb[i]
        return out

    wb = tuple(targ(t) for t in (weight, bias) if t is not None)
    return apply_op("layer_norm", fn, (x,) + wb)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm with fp32 statistics for bf16/fp16 inputs, cast back before
    the weight multiply (the reference's order)."""
    def fn(v, *w):
        compute = v.to(torch.float32) if v.dtype in (
            torch.bfloat16, torch.float16) else v
        ms = torch.mean(torch.square(compute), dim=-1, keepdim=True)
        out = (compute * torch.rsqrt(ms + epsilon)).to(v.dtype)
        return out * w[0] if w else out

    wb = (targ(weight),) if weight is not None else ()
    return apply_op("rms_norm", fn, (x,) + wb)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    channel_last = not data_format.startswith("NC")
    has_stats = running_mean is not None
    has_w, has_b = weight is not None, bias is not None

    def fn(v, *extra):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        i = 0
        tail = [1] * (v.dim() - 2)
        if not use_input_stats:
            if not has_stats:
                raise ValueError(
                    "use_input_stats=False requires running_mean/var")
            m = extra[0].reshape([1, -1] + tail)
            var = extra[1].reshape([1, -1] + tail)
            i = 2
        else:
            i = 2 if has_stats else 0
            axes = tuple(range(2, v.dim()))
            m = v.mean(dim=axes, keepdim=True)
            var = _var(v, axes, True)
        out = (v - m) * torch.rsqrt(var + eps)
        shape = [1, v.shape[1]] + tail
        if has_w:
            out = out * extra[i].reshape(shape)
            i += 1
        if has_b:
            out = out + extra[i].reshape(shape)
        return torch.movedim(out, 1, -1) if channel_last else out

    operands = []
    if has_stats:
        operands += [targ(running_mean), targ(running_var)]
    operands += [targ(t) for t in (weight, bias) if t is not None]
    return apply_op("instance_norm", fn, (x, *operands))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = not data_format.startswith("NC")
    has_w, has_b = weight is not None, bias is not None

    def fn(v, *wb):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        N, C = v.shape[0], v.shape[1]
        g = v.reshape((N, num_groups, C // num_groups) + tuple(v.shape[2:]))
        axes = tuple(range(2, g.dim()))
        m = g.mean(dim=axes, keepdim=True)
        var = _var(g, axes, True)
        out = ((g - m) * torch.rsqrt(var + epsilon)).reshape(v.shape)
        shape = [1, C] + [1] * (v.dim() - 2)
        i = 0
        if has_w:
            out = out * wb[0].reshape(shape)
            i = 1
        if has_b:
            out = out + wb[i].reshape(shape)
        return torch.movedim(out, 1, -1) if channel_last else out

    wb = tuple(targ(t) for t in (weight, bias) if t is not None)
    return apply_op("group_norm", fn, (x,) + wb)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    def fn(v):
        sq = torch.square(v)
        half = size // 2
        ch = 1 if data_format.startswith("NC") else v.dim() - 1
        c = v.shape[ch]
        acc = torch.zeros_like(v)
        for offset in range(-half, size - half):
            lo, hi = max(0, -offset), min(c, c - offset)
            if hi <= lo:
                continue
            src = sq.narrow(ch, lo + offset, hi - lo)
            pads = [0, 0] * v.dim()
            # torch pads the last dim first
            j = 2 * (v.dim() - 1 - ch)
            pads[j], pads[j + 1] = lo, c - hi
            acc = acc + torch.nn.functional.pad(src, pads)
        return v / torch.pow(k + alpha * acc / size, beta)
    return apply_op("local_response_norm", fn, (x,))
