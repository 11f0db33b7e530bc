"""Pipeline parallelism over a ``pipe`` mesh axis (counterpart of
``paddle_tpu/distributed/pipelining.py``).

The reference compiles GPipe into one XLA module: every stage is a shard
of the ``pipe`` axis, activations move with ``ppermute``, the last stage
collects the outputs and a ``psum`` replicates them, and the backward is
the scan reversed.  The port drives the same schedule from the host, one
process a stage rank (``ProcessMesh``): :func:`spmd_pipeline` runs every
micro-batch forward in order (a stage receives its input from the
previous stage and sends its output to the next through the port's
point-to-point path, ``collective.send`` / ``recv``; on gloo a CUDA
tensor goes through pinned host buffers), broadcasts the last stage's
outputs to every stage (the psum), then in the backward takes the
micro-batches in reverse, the cotangents travelling the other way, and
broadcasts the first stage's input gradients to every stage (the psum's
transpose: the inputs are replicated over ``pipe``).  ``remat`` maps to
recompute: the forward keeps only each micro-batch's stage input and the
backward runs the stage again with autograd on.  With one stage it is
the serial loop.

``STATS`` ops: ``pipe_fwd`` / ``pipe_bwd`` (a stage's sends of
activations / cotangents, the bytes it sent), ``pipe_fwd_recv`` /
``pipe_bwd_recv``, and ``pipe_out`` / ``pipe_dx`` (the two broadcasts).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import collective as C

__all__ = ["stack_stage_params", "spmd_pipeline", "stage_index_of"]


def stack_stage_params(per_stage: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Stack per-stage dicts (same keys) into one dict whose tensors have
    a leading ``n_stages`` dim."""
    keys = per_stage[0].keys()
    return {k: torch.stack([s[k] for s in per_stage], 0) for k in keys}


class _Schedule:
    """One pipelined call's state: the stage's saved inputs (and graphs
    without remat) between the forward and the backward."""

    def __init__(self, stage_fn, params, comm, remat):
        self.fn, self.params, self.comm, self.remat = (stage_fn, params,
                                                       comm, remat)
        self.saved: List = []

    def _peer(self, delta: int) -> int:
        return self.comm.ranks[self.comm.index + delta]

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        c = self.comm
        s, last = c.index, c.size - 1
        outs = torch.empty_like(xs)
        for m in range(xs.shape[0]):
            x = xs[m] if s == 0 else C.recv(
                xs.shape[1:], xs.dtype, xs.device, self._peer(-1), c.group,
                op="pipe_fwd_recv")
            x_in = x.detach().requires_grad_(True)
            if self.remat:
                with torch.no_grad():
                    y = self.fn(self.params, x_in)
                self.saved.append(x_in)
            else:
                with torch.enable_grad():
                    y = self.fn(self.params, x_in)
                self.saved.append((x_in, y))
            if s < last:
                C.send(y, self._peer(1), c.group, op="pipe_fwd")
            else:
                outs[m] = y.detach()
        # the psum: the last stage's outputs on every stage
        return C.broadcast(outs, src=c.ranks[last], group=c.group,
                           op="pipe_out")

    def backward(self, dys: torch.Tensor) -> torch.Tensor:
        c = self.comm
        s, last = c.index, c.size - 1
        dxs = torch.zeros_like(dys)
        for m in reversed(range(dys.shape[0])):
            dy = dys[m] if s == last else C.recv(
                dys.shape[1:], dys.dtype, dys.device, self._peer(1),
                c.group, op="pipe_bwd_recv")
            if self.remat:
                x_in = self.saved[m].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self.fn(self.params, x_in)
            else:
                x_in, y = self.saved[m]
            torch.autograd.backward(y, dy)
            self.saved[m] = None
            if s > 0:
                C.send(x_in.grad, self._peer(-1), c.group, op="pipe_bwd")
            else:
                dxs[m] = x_in.grad
        # the inputs are replicated over the stages: their gradient too
        return C.broadcast(dxs, src=c.ranks[0], group=c.group, op="pipe_dx")


class _Pipeline(torch.autograd.Function):
    """Autograd around a :class:`_Schedule`; the stage's parameters are
    inputs only so that the output requires grad — their gradients
    accumulate in ``.grad`` inside the schedule's backward."""

    @staticmethod
    def forward(ctx, xs, sched, *params):
        ctx.sched = sched
        return sched.forward(xs)

    @staticmethod
    def backward(ctx, dys):
        dxs = ctx.sched.backward(dys.contiguous())
        return (dxs, None) + (None,) * len(ctx.sched.param_list)


def spmd_pipeline(stage_fn: Callable, stage_params, xs: torch.Tensor, *,
                  mesh, axis_name: str = "pipe",
                  remat: bool = False) -> torch.Tensor:
    """Differentiable GPipe over the ``axis_name`` ranks of ``mesh``.

    Args:
      stage_fn: ``(stage_params, x) -> y`` — this stage's computation on
        one micro-batch; ``y.shape == x.shape``.
      stage_params: this rank's stage's parameters (a dict of tensors;
        with autograd on, their gradients accumulate in ``.grad``).
      xs: ``[n_micro, ...]`` micro-batches, the same on every stage (only
        the first stage reads them).
    Returns:
      ``[n_micro, ...]`` outputs of the last stage, on every stage.
    """
    comm = mesh.bind().get(axis_name) if axis_name in mesh.dim_names \
        else None
    if comm is None or comm.size == 1:
        f = stage_fn
        if remat:
            def f(p, x):
                return checkpoint(stage_fn, p, x, use_reentrant=False)
        return torch.stack([f(stage_params, xs[i])
                            for i in range(xs.shape[0])])
    sched = _Schedule(stage_fn, stage_params, comm, remat)
    params = [p for p in stage_params.values()
              if isinstance(p, torch.Tensor) and p.requires_grad]
    sched.param_list = params
    return _Pipeline.apply(xs, sched, *params)


def stage_index_of(layer_idx: int, n_layers: int, n_stages: int,
                   n_chunks: int = 1) -> int:
    """Which pipeline stage owns ``layer_idx`` under (interleaved) uniform
    partitioning: the layer list splits into ``n_stages * n_chunks``
    segments; segment j lives on stage ``j % n_stages`` (chunk ``j //
    n_stages``)."""
    n_seg = n_stages * n_chunks
    bounds = np.linspace(0, n_layers, n_seg + 1).astype(int)
    seg = int(np.searchsorted(bounds[1:], layer_idx, side="right"))
    return seg % n_stages
