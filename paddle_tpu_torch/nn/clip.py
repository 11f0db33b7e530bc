"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Each clip maps a list of ``(param, grad)`` API-tensor pairs to clipped
pairs, as the reference's; an optimizer given ``grad_clip=`` applies it
to every gradient before its update.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor


def _wrap(v):
    return Tensor._from_value(v)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else _wrap(
            torch.clamp(g._value, self.min, self.max)))
            for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            v = g._value
            norm = torch.sqrt(torch.sum(torch.square(v.to(torch.float32))))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, _wrap((v * scale).to(v.dtype))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm over every gradient in fp32."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads) -> torch.Tensor:
        sq = [torch.sum(torch.square(g._value.to(torch.float32)))
              for g in grads]
        return torch.sqrt(torch.stack(sq).sum())

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        gnorm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        return [(p, g if g is None else _wrap(
            (g._value * scale).to(g._value.dtype)))
            for p, g in params_grads]
