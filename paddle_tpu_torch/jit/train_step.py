"""The training step (counterpart of ``paddle_tpu/jit/train_step.py``,
its single-device ``_build``).

    step = TrainStep(model, criterion, optimizer, clip_norm=1.0)
    loss = step(input_ids, labels)

One call runs the forward and the loss (fp32), the backward, the global
gradient-norm clip (``scale = clip / max(||g||, clip)`` with the norm in
fp32, each gradient scaled in fp32 and cast back to its own dtype), the
optimizer's in-place update of every parameter, and clears the gradients.
The reference traces all of it into one XLA module; the port runs it
eagerly (a CUDA-graph capture of the step is later work).  The sharded
forms (``mesh=``, ``sharding=``) are not ported and raise.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..optimizer import Optimizer


class TrainStep:
    """Model + criterion + optimizer as one step on one device."""

    def __init__(self, model: nn.Module, criterion: Callable,
                 optimizer: Optimizer, clip_norm: Optional[float] = None,
                 mesh=None, sharding=None):
        if mesh is not None or sharding is not None:
            raise NotImplementedError(
                "TrainStep: the sharded step (mesh=/sharding=) is not "
                "ported; the port trains on one device")
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.clip_norm = clip_norm

    @property
    def global_step(self) -> int:
        return self.optimizer._global_step

    @torch.no_grad()
    def _clip(self, grads) -> None:
        sq = [g.to(torch.float32).square().sum() for g in grads]
        gnorm = torch.sqrt(torch.stack(sq).sum())
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        for g in grads:
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.to(torch.float32) * scale)

    def __call__(self, *batch) -> torch.Tensor:
        """``batch`` = model inputs then labels; returns the fp32 loss
        (detached) of this step."""
        *inputs, labels = batch
        loss = self.criterion(self.model(*inputs), labels).to(torch.float32)
        loss.backward()
        if self.clip_norm is not None:
            grads = [p.grad for _, p in self.optimizer.params
                     if p.grad is not None]
            if grads:
                self._clip(grads)
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()
