"""Eager autograd on ``torch.autograd`` (counterpart of
``paddle_tpu/autograd/tape.py``).

The reference records a tape of ``GradNode`` s over JAX VJPs and runs it
with its own engine (``run_backward``, ``grad``).  The port keeps no
second tape: an API ``Tensor`` holds one ``torch.Tensor`` and every op
runs on torch's autograd, so ``backward`` is ``torch.autograd.backward``
and ``grad`` is ``torch.autograd.grad`` (with ``create_graph`` for higher
orders).  The grad switch is torch's.  The reference's rules are kept:
a tensor that stops gradient is not differentiated (``grad`` gives None
for it with ``allow_unused``, and raises without), ``backward`` of a
tensor with no history seeds only its own ``.grad``, and a non-scalar
output needs an explicit seed.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _seed(t, g):
    from ..core.tensor import Tensor
    if g is None:
        if t._value.numel() != 1:
            raise RuntimeError("grad can be implicitly created only for "
                               "scalar outputs")
        return torch.ones_like(t._value)
    v = g._value if isinstance(g, Tensor) else torch.as_tensor(
        g, device=t._value.device)
    return v.to(t._value.dtype)


def run_backward(tensors: Sequence, grad_tensors: Optional[Sequence] = None,
                 retain_graph: bool = False) -> None:
    """Reverse accumulation from ``tensors`` into the leaves' ``.grad``
    (reference: ``run_backward``); tensors that stop gradient are
    skipped."""
    tensors = _as_list(tensors)
    grads = [None] * len(tensors) if grad_tensors is None \
        else _as_list(grad_tensors)
    if len(grads) != len(tensors):
        raise ValueError("grad_tensors must match tensors")
    outs, seeds = [], []
    for t, g in zip(tensors, grads):
        if t._value.requires_grad:
            outs.append(t._value)
            seeds.append(_seed(t, g))
    if outs:
        torch.autograd.backward(outs, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """Gradients of ``outputs`` with respect to ``inputs`` without
    touching any ``.grad`` (reference: ``grad``).  With ``create_graph``
    the results carry their own history (double grad)."""
    from ..core.tensor import Tensor
    single_in = isinstance(inputs, Tensor)
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    seeds = [None] * len(outputs) if grad_outputs is None \
        else _as_list(grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    live_out = [(o, g) for o, g in zip(outputs, seeds)
                if o._value.requires_grad]
    live_in = [i for i, t in enumerate(inputs) if t._value.requires_grad]
    got = [None] * len(inputs)
    if live_out and live_in:
        res = torch.autograd.grad(
            [o._value for o, _ in live_out],
            [inputs[i]._value for i in live_in],
            [_seed(o, g) for o, g in live_out],
            retain_graph=bool(retain_graph), create_graph=create_graph,
            allow_unused=True)
        for i, r in zip(live_in, res):
            got[i] = r
    if not allow_unused and any(r is None for r in got):
        raise RuntimeError(
            "One of the differentiated tensors appears unused in the "
            "graph; pass allow_unused=True to return None for it.")
    out = [None if r is None else Tensor._from_value(r) for r in got]
    return out[0] if single_in else out
