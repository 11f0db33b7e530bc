"""MoE gating and expert dispatch (counterpart of
``paddle_tpu/ops/moe_gate.py``).

The one top-k gate and dispatch of the port.  Callers:

- ``models/mixtral.py``'s eager block: GShard capacity buffers with
  drops, and the load-balancing aux term (computed by the caller from the
  raw assignment);
- ``jit/serving_step.py``: :func:`moe_ffn` is the dropless MoE FFN of the
  serving steps, on one device or over an ep mesh axis;
- the training steps over ranks: :func:`routed_moe_ffn` routes a token
  set that spans ranks (:class:`RoutingGroup`, made current by
  :func:`routing_over`) as the reference routes its global batch, with an
  expert-parallel dispatch over all_to_alls under ``shard_mixtral``.

Every rounding point is the reference's: router logits in fp32, the
softmax in fp32, the dispatch an fp32 scatter-add cast back to the input
dtype (exact: one source a slot, or zeros), SiLU in fp32 cast to the
dtype before the product with ``u``, and the combine an fp32 sum over the
k assignments with their renormalized weights before the cast.

Layouts: the router weight is the port's ``Linear`` weight ``[E, D]``
(the reference's is ``[D, E]``); the expert banks keep the reference's
``[E, D, M]`` (``w_gate``, ``w_up``) and ``[E, M, D]`` (``w_down``).

:func:`moe_ffn` computes each expert over its assigned rows only (a
stable sort by expert, one matrix product per expert and bank), where the
reference fills ``[E, N k, D]`` buffers and multiplies all of them: a
row's result depends on no other row, so both give the same rows, and
the port multiplies ``N k`` rows where the reference multiplies ``E N k``.
The expert products are plain ``torch.matmul`` calls, as the reference's
are XLA einsums outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

__all__ = ["topk_gate", "assignment_slots", "dispatch_to_buffers",
           "grouped_expert_swiglu", "combine_from_buffers", "moe_ffn",
           "RoutingGroup", "routing_over", "current_routing",
           "global_slots", "route_capacity", "aux_share", "routed_moe_ffn"]


def topk_gate(logits: torch.Tensor, k: int, renormalize: bool = True):
    """Softmax + top-k routing from raw router logits ``[N, E]``.

    Returns ``(top_w f32 [N, k], top_i int32 [N, k], probs f32 [N, E])``.
    Ties go to the lower expert index first, as ``jax.lax.top_k`` orders
    them (a stable descending sort: ``torch.topk`` promises no order for
    ties on CUDA).  ``renormalize=True`` rescales the selected weights to
    sum to 1 (Mixtral's convention)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :k], top_i[..., :k]
    if renormalize:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_w, top_i.to(torch.int32), probs


def assignment_slots(top_i: torch.Tensor, num_experts: int):
    """Per-assignment capacity slot: the running count per expert over the
    flattened ``[N k]`` assignment order (a one-hot cumsum).

    Returns ``(slot int32 [N, k], oh f32 [N, k, E])``; ``oh`` is handed
    back for the aux loss."""
    oh = F.one_hot(top_i.long(), num_experts).to(torch.float32)
    pos = oh.reshape(-1, num_experts).cumsum(0).reshape(oh.shape) - 1.0
    slot = (pos * oh).sum(dim=-1).to(torch.int32)
    return slot, oh


def dispatch_to_buffers(x: torch.Tensor, top_i: torch.Tensor,
                        slot: torch.Tensor, keep, num_experts: int,
                        capacity: int) -> torch.Tensor:
    """Scatter tokens into ``[E, C, D]`` expert buffers (fp32 scatter-add,
    cast back to ``x.dtype``).  ``keep=None`` is dropless; otherwise the
    rows of dropped assignments scatter zeros."""
    n, k = top_i.shape
    vf = x.to(torch.float32)
    if keep is None:
        src = vf[:, None, :].expand(n, k, vf.shape[1])
    else:
        src = vf[:, None, :] * keep[..., None].to(torch.float32)
    src = src.reshape(n * k, -1)
    slot_c = slot.clamp(0, capacity - 1).reshape(-1).long()
    zeros = torch.zeros(num_experts, capacity, vf.shape[1],
                        dtype=torch.float32, device=x.device)
    buf = zeros.index_put((top_i.reshape(-1).long(), slot_c), src,
                          accumulate=True)
    return buf.to(x.dtype)


def grouped_expert_swiglu(disp: torch.Tensor, wg: torch.Tensor,
                          wu: torch.Tensor, wd: torch.Tensor
                          ) -> torch.Tensor:
    """Batched expert SwiGLU over the whole bank: ``disp [E, C, D]``,
    ``wg/wu [E, D, M]``, ``wd [E, M, D]`` -> ``[E, C, D]`` (or one
    expert's: ``[C, D]`` rows with its ``[D, M]``/``[M, D]`` weights).
    SiLU in fp32, cast to the dtype before the product with ``u``."""
    h = F.silu(torch.matmul(disp, wg).to(torch.float32)).to(disp.dtype)
    return torch.matmul(h * torch.matmul(disp, wu), wd)


def combine_from_buffers(eo: torch.Tensor, top_i: torch.Tensor,
                         slot: torch.Tensor, top_w: torch.Tensor,
                         keep=None) -> torch.Tensor:
    """Gather each assignment's expert output and sum over k with the
    routing weights.  Returns fp32 ``[N, D]`` (the caller casts); ``keep``
    masks dropped assignments."""
    n, k = top_i.shape
    slot_c = slot.clamp(0, eo.shape[1] - 1).reshape(-1).long()
    picked = eo[top_i.reshape(-1).long(), slot_c].reshape(n, k, -1)
    w_eff = top_w if keep is None else top_w * keep.to(top_w.dtype)
    return (picked.to(torch.float32)
            * w_eff.to(torch.float32)[..., None]).sum(dim=1)


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, wg: torch.Tensor,
            wu: torch.Tensor, wd: torch.Tensor, *, top_k: int,
            ep_axis=None, ep_degree: int = 1) -> torch.Tensor:
    """Dropless MoE FFN over a flat token block ``x [N, D]``.

    ``gate_w [E, D]`` (the router's ``Linear`` weight, replicated);
    ``wg/wu [El, D, M]``, ``wd [El, M, D]``: this rank's experts (any
    strides: the int8 serving path passes transposed views of its
    dequantized ``[E, out, in]`` banks; the whole bank, ``El = E``, on one
    device).  No assignment is ever dropped.

    One device (``ep_degree <= 1``): each expert multiplies only the rows
    assigned to it: the assignments are sorted by expert (stably, so the
    order within an expert is the assignment order), which needs the
    per-expert counts on the host, one device-to-host copy of ``E``
    integers a call.

    Expert parallelism (``ep_axis``: this rank's
    ``distributed.process_mesh.AxisComm`` of the ep axis, ``ep_degree``
    its size; the reference's branch): rank ``r`` gates its token stripe
    ``x[r Tl:(r+1) Tl]``, scatters it into a dropless send buffer ``[E,
    Tl k, D]``, one all_to_all ships each expert's slices to the rank that
    owns it, the local experts run over ``[El, ep Tl k, D]``, a second
    all_to_all ships the outputs home, the weighted combine runs there and
    one all_gather rebuilds the replicated ``[N, D]``.  ``ep`` must divide
    ``N`` and ``E`` (the engine validates both)."""
    n, d = x.shape
    if ep_axis is not None and ep_degree > 1:
        from ..distributed.process_mesh import AxisComm
        if not isinstance(ep_axis, AxisComm):
            raise TypeError(
                "moe_ffn's ep_axis is this rank's AxisComm of the ep mesh "
                "axis (jit.spmd.TPContext.ep_comm); got %r" % (ep_axis,))
        return _moe_ffn_ep(x, gate_w, wg, wu, wd, top_k, ep_axis, ep_degree)
    logits = x.to(torch.float32) @ gate_w.to(torch.float32).t()
    top_w, top_i, _ = topk_gate(logits, top_k)
    flat = top_i.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=wg.shape[0]).tolist()
    rows = x[order // top_k]
    out = torch.empty_like(rows)
    start = 0
    for e, c in enumerate(counts):
        if c:
            out[start:start + c] = grouped_expert_swiglu(
                rows[start:start + c], wg[e], wu[e], wd[e])
            start += c
    eo = torch.empty_like(out)
    eo[order] = out
    picked = eo.view(n, top_k, d).to(torch.float32)
    return (picked * top_w[..., None]).sum(dim=1).to(x.dtype)


def _moe_ffn_ep(x, gate_w, wg, wu, wd, top_k, comm, ep):
    """:func:`moe_ffn`'s expert-parallel branch (reference buffers and
    collectives, see there)."""
    n, d = x.shape
    e_local = wg.shape[0]
    e_total = e_local * ep
    tl = n // ep                        # token stripe per rank
    cl = tl * top_k                     # dropless send capacity
    x_r = x[comm.index * tl:(comm.index + 1) * tl]
    logits = x_r.to(torch.float32) @ gate_w.to(torch.float32).t()
    top_w, top_i, _ = topk_gate(logits, top_k)
    slot, _ = assignment_slots(top_i, e_total)
    disp = dispatch_to_buffers(x_r, top_i, slot, None, e_total, cl)
    # dispatch: recv[g] = rank g's rows for this rank's experts
    recv = comm.all_to_all(disp)                        # [E, cl, d]
    work = recv.view(ep, e_local, cl, d).transpose(0, 1).reshape(
        e_local, ep * cl, d)
    eo = torch.stack([grouped_expert_swiglu(work[e], wg[e], wu[e], wd[e])
                      for e in range(e_local)])
    back = eo.view(e_local, ep, cl, d).transpose(0, 1).reshape(
        e_total, cl, d)
    # combine: the outputs travel home, aligned with (top_i, slot)
    back = comm.all_to_all(back)
    out_r = combine_from_buffers(back, top_i, slot, top_w).to(x.dtype)
    return comm.all_gather(out_r, 0)


# ---------------------------------------------------------------------------
# routing over a token set that spans ranks (training)
# ---------------------------------------------------------------------------
class RoutingGroup:
    """The token set a MoE block routes over when it spans ranks: the
    reference routes a GSPMD-global batch (sequence parallelism, a hybrid
    group's data ranks, ``shard_mixtral``) as one set, so the capacity,
    the slot order and the aux term's ``f_e`` and ``P_e`` are those of
    the whole set, not of a rank's slice.

    - ``gather(t)``: every rank's ``t`` stacked along a new dim 0, in the
      group's order (small tensors: the per-row expert counts);
    - ``row_block``, ``seq_block``: where this rank's rows sit in the
      global ``[B, S]`` token order (row block ``row_block`` of the batch,
      sequence block ``seq_block`` of each row); every rank holds the same
      number of rows and of positions a row;
    - ``scale``: what the training step divides the sum of the ranks'
      gradients by (the data degree for a mean, 1 for a sum), so each
      rank's aux term is its tokens' share of the global term times
      ``scale``."""

    def __init__(self, gather: Callable[[torch.Tensor], torch.Tensor],
                 row_block: int, seq_block: int, scale: float):
        self.gather = gather
        self.row_block = int(row_block)
        self.seq_block = int(seq_block)
        self.scale = float(scale)


_ROUTING: List[RoutingGroup] = []


@contextlib.contextmanager
def routing_over(group: Optional[RoutingGroup]):
    """Route every MoE block run inside the ``with`` over ``group`` (None:
    each forward routes its own tokens)."""
    _ROUTING.append(group)
    try:
        yield
    finally:
        _ROUTING.pop()


def current_routing() -> Optional[RoutingGroup]:
    return _ROUTING[-1] if _ROUTING else None


def global_slots(oh: torch.Tensor, n_rows: int, group: RoutingGroup):
    """Each assignment's capacity slot in the whole token set's order.

    ``oh`` [N, k, E] is this rank's one-hot assignment (``N = n_rows *
    S`` tokens, rows major).  The ranks' per-row counts are gathered once;
    an assignment's slot is the count of assignments to its expert by the
    tokens before it in the global order (rows, then sequence blocks
    within a row, then positions, then the k choices): an exclusive scan
    over the ranks.  Returns ``(slot int32 [N, k], totals f32 [E],
    n_global)``: the set's assignment count per expert and its token
    count."""
    N, k, E = oh.shape
    per_row = oh.reshape(n_rows, (N // n_rows) * k, E)
    counts = per_row.sum(dim=1)                                # [Bl, E]
    where = torch.tensor([group.row_block, group.seq_block],
                         dtype=torch.float32, device=oh.device)
    mine = torch.cat([counts, where.expand(n_rows, 2)], dim=1)
    every = group.gather(mine)                                 # [n, Bl, E+2]
    n = every.shape[0]
    local_rows = torch.arange(n_rows, device=oh.device,
                              dtype=torch.float32)
    rows = every[..., E] * n_rows + local_rows                 # [n, Bl]
    seqs = every[..., E + 1]
    my_rows = group.row_block * n_rows + local_rows            # [Bl]
    before = (rows[None] < my_rows[:, None, None]) | (
        (rows[None] == my_rows[:, None, None])
        & (seqs[None] < group.seq_block))                      # [Bl, n, Bl]
    base = (before[..., None].to(torch.float32)
            * every[None, ..., :E]).sum(dim=(1, 2))            # [Bl, E]
    pos = per_row.cumsum(dim=1) - 1.0 + base[:, None, :]
    slot = (pos * per_row).sum(dim=-1).reshape(N, k).to(torch.int32)
    return slot, every[..., :E].sum(dim=(0, 1)), n * N


def route_capacity(capacity_factor: float, n_tokens: int, top_k: int,
                   num_experts: int) -> int:
    """The capacity of each expert's buffer for ``n_tokens`` routed
    tokens: ``max(1, int(factor * n_tokens * k / E))``."""
    return max(1, int(capacity_factor * n_tokens * top_k / num_experts))


def aux_share(totals: torch.Tensor, probs: torch.Tensor, n_global: int,
              scale: float) -> torch.Tensor:
    """This rank's share of the load-balancing term ``E * sum_e f_e *
    P_e`` of the whole token set: ``f_e`` from the set's counts
    (``totals / n_global``, no gradient), ``P_e`` the set's mean router
    probability, of which this rank's ``probs`` [N, E] give their sum;
    times ``scale`` (:class:`RoutingGroup`)."""
    E = probs.shape[-1]
    frac = totals / n_global
    return scale * E * (frac * probs.sum(dim=0) / n_global).sum()


def routed_moe_ffn(x: torch.Tensor, n_rows: int, gate_w: torch.Tensor,
                   wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
                   top_k: int, num_experts: int, capacity_factor: float,
                   group: RoutingGroup, ep_axis=None):
    """The capacity MoE FFN over a token set that spans ranks, with
    autograd: this rank's tokens ``x [N, D]`` (``n_rows`` rows of the
    batch), routed as part of ``group`` (:func:`global_slots`: the global
    capacity ``route_capacity(N_global)``, global slot order, drops where
    a global slot is past the capacity).

    A rank sends each expert at most ``Cs = min(capacity, N)`` kept
    assignments (an expert takes a token once), packed in its own order
    into a send buffer ``[E, Cs, D]``.  With ``ep_axis`` (this rank's
    ``AxisComm`` of the expert-parallel axis; ``wg/wu/wd`` this rank's
    ``E/ep`` experts) one all_to_all ships each expert's rows to its
    owner, the owner runs them through its experts as ``[E/ep, ep Cs,
    D]``, and a second all_to_all ships the outputs home (each all_to_all's
    adjoint is the same all_to_all, so the backward moves as much); the
    payload is ``E * Cs * D`` elements a call and rank.  Without it the
    whole bank runs here.

    Returns ``(out [N, D] in x's dtype, aux share (:func:`aux_share`),
    dropped assignments over the whole set (a tensor))``."""
    N, D = x.shape
    E, k = num_experts, top_k
    logits = x.to(torch.float32) @ gate_w.to(torch.float32).t()
    top_w, top_i, probs = topk_gate(logits, k)
    oh = F.one_hot(top_i.long(), E).to(torch.float32)          # [N, k, E]
    slot, totals, n_global = global_slots(oh, n_rows, group)
    capacity = route_capacity(capacity_factor, n_global, k, E)
    keep = slot < capacity
    # this rank's kept assignments, packed per expert in its own order
    kept = (oh * keep[..., None].to(torch.float32)).reshape(N * k, E)
    local = ((kept.cumsum(dim=0) - 1.0) * kept).sum(dim=-1) \
        .reshape(N, k).to(torch.int32)
    cs = min(capacity, N)
    disp = dispatch_to_buffers(x, top_i, local, keep, E, cs)   # [E, Cs, D]
    if ep_axis is not None and ep_axis.size > 1:
        from ..distributed.collective import all_to_all_diff
        ep = ep_axis.size
        el = E // ep
        recv = all_to_all_diff(disp, ep_axis.group, "moe_all_to_all")
        work = recv.view(ep, el, cs, D).transpose(0, 1).reshape(
            el, ep * cs, D)
        eo = grouped_expert_swiglu(work, wg, wu, wd)
        back = eo.view(el, ep, cs, D).transpose(0, 1).reshape(E, cs, D)
        back = all_to_all_diff(back, ep_axis.group, "moe_all_to_all")
    else:
        back = grouped_expert_swiglu(disp, wg, wu, wd)
    out = combine_from_buffers(back, top_i, local, top_w, keep).to(x.dtype)
    dropped = (totals - capacity).clamp(min=0).sum()
    return out, aux_share(totals, probs, n_global, group.scale), dropped
