"""Vision ops (counterpart of ``paddle_tpu/nn/functional/vision.py``):
``affine_grid``, ``grid_sample``, ``channel_shuffle`` and
``temporal_shift``, as the reference composes them: the grid from its
own normalised coordinates, ``grid_sample`` as a gather at each of the
``2^nd`` corners (the reference's ``_unnormalize`` and ``_reflect``),
weighted in fp32.  torch's ``grid_sample`` rounds and reflects
differently, so it is not used."""
from __future__ import annotations

import itertools

import torch

from ...core.dispatch import apply_op
from ...ops._helpers import targ


def _grid_coords(n, align_corners, dtype, device):
    """Normalised sample positions in [-1, 1] along one spatial dim."""
    if align_corners:
        return torch.linspace(-1.0, 1.0, n, dtype=dtype, device=device)
    step = 2.0 / n
    return torch.arange(n, dtype=dtype, device=device) * step \
        + (step / 2 - 1.0)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """A sampling grid from batched 2x3 (or 3x4) affine matrices;
    ``out_shape`` = [N, C, H, W] (or [N, C, D, H, W])."""
    if hasattr(out_shape, "numpy"):
        out_shape = [int(s) for s in out_shape.numpy().tolist()]
    out_shape = [int(s) for s in out_shape]

    def fn(th):
        dt, dev = th.dtype, th.device
        if len(out_shape) == 4:
            _, _, h, w = out_shape
            gy, gx = torch.meshgrid(_grid_coords(h, align_corners, dt, dev),
                                    _grid_coords(w, align_corners, dt, dev),
                                    indexing="ij")
            base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
            return torch.einsum("hwk,nak->nhwa", base, th)
        _, _, d, h, w = out_shape
        gz, gy, gx = torch.meshgrid(_grid_coords(d, align_corners, dt, dev),
                                    _grid_coords(h, align_corners, dt, dev),
                                    _grid_coords(w, align_corners, dt, dev),
                                    indexing="ij")
        base = torch.stack([gx, gy, gz, torch.ones_like(gx)], dim=-1)
        return torch.einsum("dhwk,nak->ndhwa", base, th)

    return apply_op("affine_grid", fn, (theta,))


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _reflect(x, lo, hi):
    """``x`` reflected into [lo, hi] with period ``2 (hi - lo)``."""
    span = hi - lo
    x = torch.remainder(torch.abs(x - lo), 2 * span)
    return lo + torch.where(x > span, 2 * span - x, x)


def _resolve_coord(coord, size, padding_mode, align_corners):
    """Normalised [-1, 1] coordinates in pixel space under the padding
    mode."""
    px = _unnormalize(coord, size, align_corners)
    if padding_mode == "reflection":
        if align_corners:
            px = _reflect(px, 0.0, float(size - 1)) if size > 1 \
                else torch.zeros_like(px)
        else:
            px = _reflect(px, -0.5, size - 0.5)
            px = torch.clamp(px, 0, size - 1)
    elif padding_mode == "border":
        px = torch.clamp(px, 0, size - 1)
    return px


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` at normalised ``grid`` locations: 4-D x [N, C, H, W]
    with grid [N, Ho, Wo, 2] or 5-D x [N, C, D, H, W] with grid
    [N, Do, Ho, Wo, 3]; the grid's last dim orders coordinates
    fastest-varying first (x = width, y = height, z = depth)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported grid_sample mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")

    def fn(v, g):
        nd = v.dim() - 2
        sizes = v.shape[2:]
        gf = g.to(torch.float32)
        coords = [gf[..., nd - 1 - i] for i in range(nd)]
        pix = [_resolve_coord(c, sizes[i], padding_mode, align_corners)
               for i, c in enumerate(coords)]
        vt = torch.movedim(v, 1, -1)                  # [N, *sp, C]
        n = v.shape[0]
        bidx = torch.arange(n, device=v.device).reshape(
            (n,) + (1,) * (g.dim() - 2))

        def gather(idx_nd, valid):
            clipped = [torch.clamp(ix, 0, sizes[i] - 1)
                       for i, ix in enumerate(idx_nd)]
            out = vt[(bidx.expand(idx_nd[0].shape),) + tuple(clipped)]
            if padding_mode == "zeros":
                out = out * valid[..., None].to(out.dtype)
            return out

        def in_bounds(idx):
            valid = torch.ones(idx[0].shape, dtype=torch.bool,
                               device=v.device)
            if padding_mode == "zeros":
                for i, ix in enumerate(idx):
                    valid &= (ix >= 0) & (ix < sizes[i])
            return valid

        if mode == "nearest":
            idx = [torch.round(p).to(torch.int64) for p in pix]
            out = gather(idx, in_bounds(idx))
        else:
            lo = [torch.floor(p) for p in pix]
            out = 0.0
            for corner in itertools.product((0, 1), repeat=nd):
                idx = [(lo[i] + corner[i]).to(torch.int64)
                       for i in range(nd)]
                wgt = 1.0
                for i in range(nd):
                    frac = pix[i] - lo[i]
                    wgt = wgt * (frac if corner[i] else 1.0 - frac)
                out = out + gather(idx, in_bounds(idx)) \
                    * wgt[..., None].to(torch.float32)
        return torch.movedim(out, -1, 1).to(v.dtype)

    return apply_op("grid_sample", fn, (x, targ(grid)))


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")

    def fn(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            return v.reshape(n, groups, c // groups, h, w) \
                .transpose(1, 2).reshape(n, c, h, w)
        n, h, w, c = v.shape
        return v.reshape(n, h, w, groups, c // groups) \
            .transpose(3, 4).reshape(n, h, w, c)

    return apply_op("channel_shuffle", fn, (x,))


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """Shift a fraction of channels one step along the segment axis: the
    first ``C * ratio`` channels back (t - 1), the next ``C * ratio``
    forward (t + 1), the rest stay."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")

    def fn(v):
        if data_format == "NHWC":
            v = torch.movedim(v, -1, 1)
        nt, c, h, w = v.shape
        v5 = v.reshape(nt // seg_num, seg_num, c, h, w)
        c1 = int(c * shift_ratio)
        c2 = int(c * 2 * shift_ratio)
        zeros = torch.zeros_like(v5[:, :1])
        back = torch.cat([v5[:, 1:], zeros], dim=1)[:, :, :c1]
        fwd = torch.cat([zeros, v5[:, :-1]], dim=1)[:, :, c1:c2]
        out = torch.cat([back, fwd, v5[:, :, c2:]], dim=2).reshape(
            nt, c, h, w)
        return torch.movedim(out, 1, -1) if data_format == "NHWC" else out

    return apply_op("temporal_shift", fn, (x,))
