"""The online-softmax ``(m, l, acc)`` update (counterpart of
``paddle_tpu/ops/online_softmax.py::online_softmax_update``).

The int8 attention plain versions go through it page by page, in the
order the Pallas kernels' page loops do.  ``merge_partials`` (context
parallelism) is not ported yet.
"""
from __future__ import annotations

import torch


def online_softmax_update(carry, s: torch.Tensor, ok: torch.Tensor,
                          pv_of_p):
    """One accumulation step over a masked score tile.

    ``carry``: ``(m [g, 1], l [g, 1], acc [g, d])`` fp32 (start with
    ``m = -inf``, ``l = 0``, ``acc = 0``; any leading batch axes
    broadcast).  ``s``: ``[g, t]`` fp32 scores with masked lanes already
    ``-inf``; ``ok``: the ``[g, t]`` mask, re-applied after the exp so an
    all-masked row's ``exp(-inf - -inf)`` never reaches the sums.
    ``pv_of_p`` computes the ``[g, d]`` product of the probability tile
    with V.  Returns the new ``(m, l, acc)``, the reference's expressions
    in its order."""
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, torch.exp(s - m_new), torch.zeros((), device=s.device))
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + pv_of_p(p)
    return m_new, l_new, acc_new
