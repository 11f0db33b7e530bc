"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The reference pools with ``lax.reduce_window``; the port with torch's
pools (cuDNN or torch's own CUDA kernels on the card), over an input
padded as the reference pads it:

- max pools pad with ``-inf``, average pools with zeros; "SAME" and
  "VALID" resolve as XLA resolves them;
- ``ceil_mode`` adds the trailing padding that makes ``ceil((in + pads -
  k) / s) + 1`` windows, a last window that starts in the padding
  included (torch drops one);
- ``exclusive`` average pools divide a padded window's sum by its count
  of real elements (the inverse of torch's ``count_include_pad``), the
  rest by the window's size.

``return_mask`` gives the flat index of each window's first maximum into
the unpadded input (``h * W + w``), int32, the windows cut from an input
padded with the dtype's lowest finite value, as the reference's
``max_pool_with_index``.  Adaptive pools take torch's bins, which are the
reference's (``floor(j * in / out)`` to ``ceil((j + 1) * in / out)``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from ...ops._helpers import targ
from ...ops.random import generator_for
from .conv import _pair, _padding, pad_spatial, resolve_pads

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _ceil_pads(pads, in_sp, k, s):
    """``pads`` with the trailing padding ``ceil_mode`` adds."""
    out = []
    for (lo, hi), n, kk, ss in zip(pads, in_sp, k, s):
        total = n + lo + hi
        out_n = -(-(total - kk) // ss) + 1
        out.append((lo, hi + max(0, (out_n - 1) * ss + kk - total)))
    return out


def _window_sum(v, k, s):
    """Each window's sum (``v`` already padded)."""
    if len(k) == 1:
        return TF.avg_pool2d(v.unsqueeze(-2), (1,) + k, (1,) + s,
                             divisor_override=1).squeeze(-2)
    return _AVG[len(k)](v, k, s, divisor_override=1)


def _pool(name, nd, x, kernel_size, stride, padding, mode, data_format,
          ceil_mode=False, exclusive=True):
    channel_last = not data_format.startswith("NC")
    k = _pair(kernel_size, nd)
    s = _pair(stride if stride is not None else kernel_size, nd)
    pad = _padding(padding, nd, data_format)

    def fn(v):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        pads = resolve_pads(pad, v.shape[2:], k, s)
        if ceil_mode and not isinstance(pad, str):
            pads = _ceil_pads(pads, v.shape[2:], k, s)
        if mode == "max":
            if all(lo == hi and 0 <= lo <= kk // 2
                   for (lo, hi), kk in zip(pads, k)):
                out = _MAX[nd](v, k, s, tuple(lo for lo, _ in pads))
            else:
                out = _MAX[nd](pad_spatial(v, pads, float("-inf")), k, s)
        else:
            summed = _window_sum(pad_spatial(v, pads), k, s)
            padded = pad == "SAME" or any(p != (0, 0) for p in pads)
            if exclusive and padded:
                ones = pad_spatial(torch.ones_like(v), pads)
                out = summed / _window_sum(ones, k, s)
            else:
                out = summed / float(np.prod(k))
        return torch.movedim(out, 1, -1) if channel_last else out

    return apply_op(name, fn, (x,))


def _lowest(dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point \
        else torch.iinfo(dtype).min


def _max_pool_nd_with_mask(x, nd, kernel_size, stride, padding,
                           ceil_mode=False):
    """``(out, mask)``: the max of each window and the flat index of its
    first maximum into the unpadded input (the module's notes)."""
    k = _pair(kernel_size, nd)
    s = _pair(stride if stride is not None else kernel_size, nd)
    pad = _padding(padding, nd, "NC")
    if isinstance(pad, str):
        raise ValueError("return_mask requires explicit int padding")

    def fn(v):
        n, c = v.shape[0], v.shape[1]
        in_sp = tuple(v.shape[2:])
        pads = _ceil_pads(pad, in_sp, k, s) if ceil_mode \
            else [tuple(p) for p in pad]
        patches = pad_spatial(v, pads, _lowest(v.dtype))
        for i in range(nd):
            patches = patches.unfold(2 + i, k[i], s[i])
        out_sp = tuple(patches.shape[2:2 + nd])
        patches = patches.reshape((n, c) + out_sp + (-1,))
        out = patches.amax(-1)
        rem = patches.argmax(-1)
        flat = torch.zeros_like(rem)
        for i in range(nd):
            stride_i = int(np.prod(k[i + 1:]))
            d_i = torch.div(rem, stride_i, rounding_mode="floor")
            rem = rem % stride_i
            shape = [1] * (2 + nd)
            shape[2 + i] = out_sp[i]
            base = (torch.arange(out_sp[i], device=v.device) * s[i]
                    - pads[i][0]).reshape(shape)
            flat = flat * in_sp[i] + base + d_i
        return out, flat.to(torch.int32)

    return apply_op(f"max_pool{nd}d_with_mask", fn, (x,))


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    if return_mask:
        if df != "NCW":
            raise ValueError("return_mask requires NCL/NCW")
        return _max_pool_nd_with_mask(x, 1, kernel_size, stride, padding,
                                      ceil_mode)
    return _pool("max_pool1d", 1, x, kernel_size, stride, padding, "max", df,
                 ceil_mode=ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        if data_format != "NCHW":
            raise ValueError("return_mask requires NCHW")
        return _max_pool_nd_with_mask(x, 2, kernel_size, stride, padding,
                                      ceil_mode)
    return _pool("max_pool2d", 2, x, kernel_size, stride, padding, "max",
                 data_format, ceil_mode=ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        if data_format != "NCDHW":
            raise ValueError("return_mask requires NCDHW")
        return _max_pool_nd_with_mask(x, 3, kernel_size, stride, padding,
                                      ceil_mode)
    return _pool("max_pool3d", 3, x, kernel_size, stride, padding, "max",
                 data_format, ceil_mode=ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _pool("avg_pool1d", 1, x, kernel_size, stride, padding, "avg", df,
                 ceil_mode=ceil_mode, exclusive=exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool("avg_pool2d", 2, x, kernel_size, stride, padding, "avg",
                 data_format, ceil_mode=ceil_mode, exclusive=exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool("avg_pool3d", 3, x, kernel_size, stride, padding, "avg",
                 data_format, ceil_mode=ceil_mode, exclusive=exclusive)


_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _adaptive_pool(name, nd, x, output_size, mode, data_format):
    channel_last = not data_format.startswith("NC")
    # a None entry keeps that axis's input size
    if isinstance(output_size, (list, tuple)):
        out_sz = tuple(None if o is None else int(o) for o in output_size)
        if len(out_sz) != nd:
            out_sz = out_sz * nd
    else:
        out_sz = (int(output_size),) * nd
    pool = _ADAPTIVE[(mode, nd)]

    def fn(v):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        tgt = tuple(v.shape[2 + i] if o is None else o
                    for i, o in enumerate(out_sz))
        out = pool(v, tgt if nd > 1 else tgt[0])
        return torch.movedim(out, 1, -1) if channel_last else out

    return apply_op(name, fn, (x,))


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool("adaptive_avg_pool1d", 1, x, output_size, "avg",
                          "NCW")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool("adaptive_avg_pool2d", 2, x, output_size, "avg",
                          data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool("adaptive_avg_pool3d", 3, x, output_size, "avg",
                          data_format)


def _no_adaptive_mask(nd):
    raise NotImplementedError(
        "adaptive_max_pool%dd(return_mask=True) — use max_pool%dd with "
        "explicit kernel/stride for indices" % (nd, nd))


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _no_adaptive_mask(1)
    return _adaptive_pool("adaptive_max_pool1d", 1, x, output_size, "max",
                          "NCW")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _no_adaptive_mask(2)
    return _adaptive_pool("adaptive_max_pool2d", 2, x, output_size, "max",
                          "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _no_adaptive_mask(3)
    return _adaptive_pool("adaptive_max_pool3d", 3, x, output_size, "max",
                          "NCDHW")


def _max_unpool_nd(x, indices, nd, kernel_size, stride, padding,
                   output_size, op_name):
    """Scatter each value to its flat spatial index."""
    k = _pair(kernel_size, nd)
    s = _pair(stride if stride is not None else kernel_size, nd)
    p = _pair(padding, nd)

    def fn(v, idx):
        n, c = v.shape[0], v.shape[1]
        in_sp = v.shape[2:]
        if output_size is None:
            out_sp = tuple((in_sp[i] - 1) * s[i] - 2 * p[i] + k[i]
                           for i in range(nd))
        else:
            out_sp = tuple(int(t) for t in output_size[-nd:])
        idx = idx.reshape(n, c, -1).to(torch.int64)
        vals = v.reshape(n, c, -1)
        # two windows may share a maximum: as XLA's scatter, one update
        # wins the position and only it gets the gradient (here the
        # last, the same on every device)
        ids = torch.arange(idx.shape[-1], device=v.device).expand_as(idx)
        win = torch.full((n, c, int(np.prod(out_sp))), -1,
                         dtype=torch.int64, device=v.device).scatter_reduce(
            2, idx, ids, "amax")
        vals = torch.where(torch.gather(win, 2, idx) == ids, vals, 0.0)
        flat = v.new_zeros(win.shape).scatter_add(2, idx, vals)
        return flat.reshape((n, c) + out_sp)

    return apply_op(op_name, fn, (x, targ(indices)))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    if data_format != "NCL":
        raise ValueError("max_unpool1d supports NCL only")
    return _max_unpool_nd(x, indices, 1, kernel_size, stride, padding,
                          output_size, "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """``indices`` are the flat ``h * W + w`` positions
    ``max_pool2d(..., return_mask=True)`` gives."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d supports NCHW only")
    return _max_unpool_nd(x, indices, 2, kernel_size, stride, padding,
                          output_size, "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    if data_format != "NCDHW":
        raise ValueError("max_unpool3d supports NCDHW only")
    return _max_unpool_nd(x, indices, 3, kernel_size, stride, padding,
                          output_size, "max_unpool3d")


def _fractional_edges(in_sz, out_sz, pool_sz, u):
    """Each output cell's ``[start, end)`` in the input: the reference's
    FractionalStartIndex/EndIndex with FractionalRationalU."""
    alpha = float(in_sz - pool_sz) / max(
        out_sz - (1 if pool_sz > 0 else 0), 1)
    if pool_sz > 0:
        uu = u
    else:
        alpha = float(in_sz) / out_sz
        base = in_sz // out_sz
        u_max1 = (base + 2) / alpha - 1
        u_max2 = (in_sz + 1 - base) / alpha - (out_sz - 1)
        uu = u * min(u_max1, u_max2)
    edges = []
    for i in range(out_sz):
        start = int((i + uu) * alpha) - int(uu * alpha)
        end = start + pool_sz if pool_sz > 0 \
            else int((i + 1 + uu) * alpha) - int(uu * alpha)
        edges.append((max(start, 0), min(end, in_sz)))
    return edges


def _draw_u(x) -> float:
    """One uniform draw in [0, 1) from the framework generator of ``x``'s
    device (a fractional pool's region offset; the seed's contract of
    ``ops/random.py``)."""
    dev = x._value.device if hasattr(x, "_value") else torch.device("cpu")
    return float(torch.rand((), generator=generator_for(dev),
                            device=dev))


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Fractional max pooling (Graham 2015): pseudo-random region edges
    from one ``u`` in (0, 1), or a fixed kernel; the regions gathered in
    one padded gather over host-built flat indices."""
    out_sz = _pair(output_size, 2)
    k = _pair(kernel_size, 2) if kernel_size is not None else (0, 0)
    u = float(random_u) if random_u is not None else _draw_u(x)

    def fn(v):
        n, c, h, w = v.shape
        h_edges = _fractional_edges(h, out_sz[0], k[0], u)
        w_edges = _fractional_edges(w, out_sz[1], k[1], u)
        maxlen = max((he - hs) * (we - ws)
                     for hs, he in h_edges for ws, we in w_edges)
        idx = np.zeros((out_sz[0], out_sz[1], maxlen), np.int64)
        valid = np.zeros((out_sz[0], out_sz[1], maxlen), bool)
        for i, (hs, he) in enumerate(h_edges):
            for j, (ws, we) in enumerate(w_edges):
                cell = (np.arange(hs, he)[:, None] * w
                        + np.arange(ws, we)[None, :]).ravel()
                idx[i, j, :cell.size] = cell
                valid[i, j, :cell.size] = True
        gi = torch.from_numpy(idx.reshape(-1)).to(v.device)
        gv = torch.from_numpy(valid.reshape(1, 1, -1)).to(v.device)
        flat = v.reshape(n, c, h * w)
        g = torch.where(gv, flat[:, :, gi], _lowest(v.dtype)).reshape(
            n, c, out_sz[0], out_sz[1], maxlen)
        out = g.amax(-1)
        if return_mask:
            a = g.argmax(-1, keepdim=True)
            gidx = torch.from_numpy(idx).to(v.device).expand(
                (n, c) + idx.shape)
            return out, torch.gather(gidx, -1, a)[..., 0].to(torch.int32)
        return out

    return apply_op("fractional_max_pool2d", fn, (x,))
