"""The online-softmax carry math (counterpart of
``paddle_tpu/ops/online_softmax.py``).

- :func:`online_softmax_update`: the ``(m, l, acc)`` update; the int8
  attention plain versions go through it page by page, in the order the
  Pallas kernels' page loops do;
- :func:`merge_partials`: the same math over already normalized partials
  ``(m, l, o)``, which context-parallel serving computes one slot stripe
  a rank;
- :func:`cross_chip_merge`: the merge across the cp ranks — the three
  rows packed into ONE fp32 buffer, one all_gather over the cp group,
  then :func:`merge_partials` over the gathered rank dim.

Everything is fp32 in and out.
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


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   axis: int = 0) -> torch.Tensor:
    """Merge normalized partials along ``axis`` (reference:
    ``merge_partials``, its expressions): ``m``/``l`` the per-partial row
    max and normalizer, ``o`` the same shape plus a feature dim, each
    normalized by its own ``l``.  An empty partial (``m = -inf, l = 0``)
    drops out exactly, and an all-empty row merges to 0, not NaN."""
    m_star = m.amax(dim=axis, keepdim=True)
    m_safe = torch.where(torch.isfinite(m_star), m_star,
                         torch.zeros((), device=m.device))
    w = l * torch.exp(m - m_safe)
    denom = w.sum(dim=axis)
    num = (w[..., None] * o).sum(dim=axis)
    return num / denom.clamp_min(1e-30)[..., None]


def cross_chip_merge(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     comm) -> torch.Tensor:
    """Merge this rank's stripe partials with the other cp ranks'
    (reference: ``cross_chip_merge``): ``o`` [T, H, D], ``m``/``l`` [T, H]
    fp32 travel as one ``[T, H, D + 2]`` buffer in ONE all_gather over
    ``comm`` (the cp axis's ``AxisComm``); returns the merged [T, H, D],
    the same on every rank."""
    pack = torch.cat([o, m[..., None], l[..., None]], dim=-1)
    g = comm.all_gather(pack[None], 0, "cp_merge")   # [cp, T, H, D + 2]
    D = o.shape[-1]
    return merge_partials(g[..., D], g[..., D + 1], g[..., :D], axis=0)
