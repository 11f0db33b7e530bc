"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The reference runs each convolution as one ``lax.conv_general_dilated``;
the port runs ``torch.nn.functional.conv{1,2,3}d`` (cuDNN on the card).
Paddle's padding forms that torch's convolution does not take — "SAME"
and "VALID" (resolved as XLA resolves them), per-side lists — are applied
first with ``torch.nn.functional.pad`` (a negative side crops).
``NHWC``-style layouts move the channel axis to dim 1 and back.  Weights
keep paddle's layouts: ``[out, in/groups, *k]`` for a convolution,
``[in, out/groups, *k]`` for a transpose.

A transposed convolution is the reference's construction: the input
dilated by the stride (zeros between its elements), padded by ``k - 1 -
p`` (plus ``output_padding`` at the end) and convolved with the flipped
kernel, its groups in one grouped convolution.  As in the reference, a
string padding is refused there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from ...ops._helpers import targ

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


def _pair(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v) if len(v) == n else tuple(v) * n
    return (int(v),) * n


def _padding(padding, nd, data_format):
    """Paddle's padding spec as ``"SAME"``/``"VALID"`` or a list of
    ``(lo, hi)`` a spatial dim."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        if not all(isinstance(p, int) for p in padding):
            # the reference takes this length as the per-side form first
            raise ValueError(f"bad padding spec {padding}")
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    # the full per-dim [[0, 0], [0, 0], [lo, hi], ...] form
    if len(padding) == nd + 2:
        spatial = padding[2:] if data_format.startswith("NC") \
            else padding[1:-1]
        return [tuple(p) if isinstance(p, (list, tuple)) else (p, p)
                for p in spatial]
    raise ValueError(f"bad padding spec {padding}")


def resolve_pads(pad, in_sp, window, strides):
    """``(lo, hi)`` a dim: an explicit list as it is; "VALID" none;
    "SAME" as XLA's ``padtype_to_pads`` (output ``ceil(in / stride)``, the
    odd pixel at the end)."""
    if not isinstance(pad, str):
        return [tuple(p) for p in pad]
    if pad == "VALID":
        return [(0, 0)] * len(in_sp)
    out = []
    for n, k, s in zip(in_sp, window, strides):
        o = -(-n // s)
        total = max((o - 1) * s + k - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def pad_spatial(v, pads, value=0.0):
    """``v`` [N, C, *sp] padded by ``pads`` (a negative side crops)."""
    if all(p == (0, 0) for p in pads):
        return v
    flat = []
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    return TF.pad(v, flat, value=value)


def _conv(name, nd, x, weight, bias, stride, padding, dilation, groups,
          data_format):
    channel_last = not data_format.startswith("NC")
    strides = _pair(stride, nd)
    dil = _pair(dilation, nd)
    pad = _padding(padding, nd, data_format)
    conv = _CONV[nd]

    def fn(v, w, *b):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        k_eff = [(w.shape[2 + i] - 1) * dil[i] + 1 for i in range(nd)]
        pads = resolve_pads(pad, v.shape[2:], k_eff, strides)
        if all(lo == hi and lo >= 0 for lo, hi in pads):
            sym = tuple(lo for lo, _ in pads)
        else:
            v, sym = pad_spatial(v, pads), 0
        out = conv(v, w, b[0] if b else None, strides, sym, dil, groups)
        return torch.movedim(out, 1, -1) if channel_last else out

    args = (x, targ(weight)) + ((targ(bias),) if bias is not None else ())
    return apply_op(name, fn, args)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv("conv1d", 1, x, weight, bias, stride, padding, dilation,
                 groups, df)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv("conv2d", 2, x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv("conv3d", 3, x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def _dilate(v, strides):
    """``v`` [N, C, *sp] with ``stride - 1`` zeros between elements (XLA's
    ``lhs_dilation``)."""
    if all(s == 1 for s in strides):
        return v
    sp = v.shape[2:]
    out = v.new_zeros(tuple(v.shape[:2]) + tuple(
        (n - 1) * s + 1 for n, s in zip(sp, strides)))
    out[(slice(None), slice(None)) + tuple(
        slice(None, None, s) for s in strides)] = v
    return out


def _conv_transpose(name, nd, x, weight, bias, stride, padding,
                    output_padding, dilation, groups, data_format):
    channel_last = not data_format.startswith("NC")
    strides = _pair(stride, nd)
    dil = _pair(dilation, nd)
    pad = _padding(padding, nd, data_format)
    if isinstance(pad, str):
        raise ValueError(
            "string padding is not implemented for a transposed convolution "
            "(the reference's lax lowering refuses it): give it explicitly")
    opad = _pair(output_padding, nd)
    conv = _CONV[nd]

    def fn(v, w, *b):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        # the reference reads the kernel extent from a group's weight's
        # leading dims in a channel-last layout (its in/out channels), and
        # from dims 2.. otherwise; kept as it computes
        dims = (w.shape[0] // groups,) + tuple(w.shape[1:]) \
            if channel_last else tuple(w.shape[2:])
        kk = [(dims[i] - 1) * dil[i] + 1 for i in range(nd)]
        pads = [(kk[i] - 1 - pad[i][0], kk[i] - 1 - pad[i][1] + opad[i])
                for i in range(nd)]
        # [in, out/g, *k] -> [g, out/g, in/g, *k] -> [out, in/g, *k],
        # flipped: the transpose as a correlation
        cin, cout_g = w.shape[0], w.shape[1]
        wt = w.reshape((groups, cin // groups, cout_g) + tuple(w.shape[2:]))
        wt = wt.transpose(1, 2).reshape(
            (groups * cout_g, cin // groups) + tuple(w.shape[2:]))
        wt = torch.flip(wt, dims=tuple(range(2, 2 + nd)))
        vp = pad_spatial(_dilate(v, strides), pads)
        out = conv(vp, wt, None, 1, 0, dil, groups)
        if b:
            shape = [1] * out.dim()
            shape[1] = b[0].numel()
            out = out + b[0].reshape(shape)
        return torch.movedim(out, 1, -1) if channel_last else out

    args = (x, targ(weight)) + ((targ(bias),) if bias is not None else ())
    return apply_op(name, fn, args)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_transpose("conv1d_transpose", 1, x, weight, bias, stride,
                           padding, output_padding, dilation, groups, df)


def _resolve_output_padding(nd, x, weight, stride, padding, dilation,
                            output_size, output_padding, data_format):
    """The ``output_padding`` that gives ``output_size``:
    ``out = (in - 1) * s - 2 p + d (k - 1) + output_padding + 1``."""
    if output_size is None:
        return output_padding

    def tup(v):
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * nd

    st, pd, dl = tup(stride), tup(padding), tup(dilation)
    xs = list(x.shape)
    spatial = xs[2:2 + nd] if data_format.startswith("NC") \
        else xs[1:1 + nd]
    ks = list(weight.shape)[2:2 + nd]
    want = list(output_size)
    ops = []
    for i in range(nd):
        base = (spatial[i] - 1) * st[i] - 2 * pd[i] \
            + dl[i] * (ks[i] - 1) + 1
        op = int(want[i]) - base
        if not 0 <= op < max(st[i], dl[i]):
            raise ValueError(
                f"output_size[{i}]={want[i]} unreachable: base size "
                f"{base}, stride {st[i]}")
        ops.append(op)
    return tuple(ops)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    output_padding = _resolve_output_padding(
        2, x, weight, stride, padding, dilation, output_size,
        output_padding, data_format)
    return _conv_transpose("conv2d_transpose", 2, x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    output_padding = _resolve_output_padding(
        3, x, weight, stride, padding, dilation, output_size,
        output_padding, data_format)
    return _conv_transpose("conv3d_transpose", 3, x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           data_format)
