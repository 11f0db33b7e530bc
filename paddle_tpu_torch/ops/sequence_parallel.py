"""Sequence-parallel attention over a mesh axis of ranks (counterpart of
the ring and Ulysses section of ``paddle_tpu/ops/pallas_kernels.py``):
each rank holds its slice ``[B, S_local, H, D]`` of q, k and v, rank
``i`` the positions ``i * S_local ..``.

- :func:`ring_attention` (reference: ``_ring_flash`` and
  ``ring_attention``): k and v travel around the ring one rank a hop.  At
  hop ``i`` a rank holds the k/v of rank ``src = (idx - i) mod n`` and
  runs the flash forward with lse on it (``flash_fwd``, no rope): hop 0
  is the diagonal block, causal; under causal masking a later hop is a
  full block when ``src < idx`` and is skipped otherwise (**no launch**:
  it would add a zero output at lse ``-inf``).  The hop results combine
  by a running logaddexp in fp32; the output returns in q's dtype.  The
  backward runs ``flash_bwd_auto`` a hop against the **total** output and
  lse (so each block's recomputed p is the global softmax probability):
  dq accumulates in fp32 at home, and the fp32 dk/dv accumulators travel
  around the ring with their shard and arrive home after n hops.  k and
  v travel as one packed buffer, dk and dv too: one ``shift`` a hop each.
  The forward's last hop and the backward's last hop send no k/v (the
  reference rotates them home unused).
- :func:`ulysses_attention` (reference: ``ulysses_attention``): an
  all_to_all trades the sequence slice for a head slice (every rank then
  holds the whole sequence at ``H/n`` heads), the flash kernels run there
  (``flash_attention``), and a second all_to_all restores the sequence
  slice.

The per-hop functions are the kernel wrappers: on the card they launch
the kernels or raise; on CPU tensors they run their plain versions, and
at head dims over 128 the same code calls the plain versions directly
(the reference's ring falls back to its einsum ring there).
:func:`sdpa_ring` and :func:`sdpa_ulysses` take a mesh (or a hybrid
group's mesh) and the axis name, as the reference's do.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import flash_attention as fa

__all__ = ["RingFlashAttention", "ring_attention", "ulysses_attention",
           "sdpa_ring", "sdpa_ulysses", "ring_hops", "ring_bytes"]


def ring_hops(index: int, n: int, causal: bool):
    """The blocks rank ``index`` of an ``n``-rank ring runs, in hop order:
    ``(hop, src, block causal)`` (a masked hop is absent)."""
    out = []
    for i in range(n):
        src = (index - i) % n
        if not causal:
            out.append((i, src, False))
        elif i == 0:
            out.append((i, src, True))
        elif src < index:
            out.append((i, src, False))
    return out


def _fwd(q, k, v, causal: bool):
    if fa._kernel_ok(q):
        return fa.flash_fwd(q, k, v, causal)
    return fa._flash_fwd_plain(q, k, v, causal)


def _bwd(q, k, v, out, lse, g, causal: bool):
    if fa._kernel_ok(q):
        return fa.flash_bwd_auto(q, k, v, out, lse, g, causal)
    form = "fused" if fa.fused_bwd_taken(k.shape[1]) else "two_kernel"
    return fa._flash_bwd_plain(q, k, v, out, lse, g, causal, form=form)


def _lse_rows(lse: torch.Tensor) -> torch.Tensor:
    """[B, H, S] -> [B, S, H, 1], to weigh rows of [B, S, H, D]."""
    return lse.transpose(1, 2).unsqueeze(-1)


class RingFlashAttention(torch.autograd.Function):
    """Ring attention over ``comm`` (an ``AxisComm``): see the module
    notes."""

    @staticmethod
    def forward(ctx, q, k, v, comm, causal: bool):
        n, idx = comm.size, comm.index
        B, S, H, D = q.shape
        acc = torch.zeros(B, S, H, D, dtype=torch.float32, device=q.device)
        lse_run = torch.full((B, H, S), float("-inf"), dtype=torch.float32,
                             device=q.device)
        kv = torch.stack([k, v])
        runs = {hop: c for hop, _, c in ring_hops(idx, n, causal)}
        for i in range(n):
            if i in runs:
                o_i, lse_i = _fwd(q, kv[0], kv[1], runs[i])
                new = torch.logaddexp(lse_run, lse_i)
                w_old = torch.where(torch.isfinite(lse_run),
                                    torch.exp(lse_run - new), 0.0)
                w_new = torch.where(torch.isfinite(lse_i),
                                    torch.exp(lse_i - new), 0.0)
                acc = acc * _lse_rows(w_old) \
                    + o_i.to(torch.float32) * _lse_rows(w_new)
                lse_run = new
            if i < n - 1:
                kv = comm.shift(kv, op="ring_kv")
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_run)
        ctx.comm, ctx.causal = comm, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        comm, causal = ctx.comm, ctx.causal
        n, idx = comm.size, comm.index
        g = g.to(out.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        runs = {hop: c for hop, _, c in ring_hops(idx, n, causal)}
        for i in range(n):
            if i in runs:
                dq_i, dk_i, dv_i = _bwd(q, kv[0], kv[1], out, lse, g,
                                        runs[i])
                dq += dq_i.to(torch.float32)
                dkv[0] += dk_i.to(torch.float32)
                dkv[1] += dv_i.to(torch.float32)
            dkv = comm.shift(dkv, op="ring_dkv")
            if i < n - 1:
                kv = comm.shift(kv, op="ring_kv")
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_attention(q, k, v, comm, is_causal: bool = False) -> torch.Tensor:
    """Ring attention of this rank's ``[B, S_local, H, D]`` slices over
    ``comm``'s ranks (k and v head-repeated for GQA)."""
    return RingFlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), comm, is_causal)


def _seq_to_heads(x: torch.Tensor, comm) -> torch.Tensor:
    """[B, S_local, H, D] -> [B, S, H/n, D]: head chunk ``g`` to rank
    ``g``, the sequence slices concatenated in rank order."""
    n = comm.size
    B, S, H, D = x.shape
    parts = x.reshape(B, S, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = comm.all_to_all(parts.contiguous())       # [n(src), B, S, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * S, H // n, D)


def _heads_to_seq(x: torch.Tensor, comm) -> torch.Tensor:
    """[B, S, H/n, D] -> [B, S_local, H, D]: sequence chunk ``g`` to rank
    ``g``, the head slices concatenated in rank order."""
    n = comm.size
    B, S, h, D = x.shape
    parts = x.reshape(B, n, S // n, h, D).permute(1, 0, 2, 3, 4)
    got = comm.all_to_all(parts.contiguous())    # [n(src), B, S/n, h, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * h, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _seq_to_heads(x, comm)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.comm), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _heads_to_seq(x, comm)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.comm), None


def ulysses_attention(q, k, v, comm, is_causal: bool = False
                      ) -> torch.Tensor:
    """Ulysses attention of this rank's ``[B, S_local, H, D]`` slices over
    ``comm``'s ranks: the heads must divide by the axis size."""
    n = comm.size
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs heads ({H}) divisible by the "
                         f"axis size ({n})")
    qf, kf, vf = (_SeqToHeads.apply(t.contiguous(), comm)
                  for t in (q, k, v))
    out = fa.flash_attention(qf, kf, vf, is_causal)
    return _HeadsToSeq.apply(out.to(q.dtype).contiguous(), comm)


def _axis_comm(mesh, axis_name: str):
    """``mesh``'s ``AxisComm`` on ``axis_name`` (a ProcessMesh, or a
    hybrid group's; binding its groups on first use)."""
    return getattr(mesh, "mesh", mesh).bind()[axis_name]


def sdpa_ring(query, key, value, mesh, axis_name: str = "sep",
              is_causal: bool = False) -> torch.Tensor:
    """Sequence-parallel attention by the ring over ``mesh``'s
    ``axis_name`` (reference: ``sdpa_ring``); q/k/v this rank's
    ``[B, S_local, H, D]``."""
    return ring_attention(query, key, value, _axis_comm(mesh, axis_name),
                          is_causal)


def sdpa_ulysses(query, key, value, mesh, axis_name: str = "sep",
                 is_causal: bool = False) -> torch.Tensor:
    """Sequence-parallel attention by Ulysses' all_to_all over ``mesh``'s
    ``axis_name`` (reference: ``sdpa_ulysses``)."""
    return ulysses_attention(query, key, value,
                             _axis_comm(mesh, axis_name), is_causal)


def ring_bytes(shape: Tuple[int, ...], itemsize: int, n: int,
               backward: bool) -> dict:
    """The payload one rank of an ``n``-rank ring hands ``shift`` for one
    call on ``[B, S_local, H, D]`` slices: the packed k/v of ``n - 1``
    hops, and in the backward also the fp32 dk/dv of ``n`` hops."""
    numel = 1
    for d in shape:
        numel *= d
    out = {"ring_kv": (n - 1) * 2 * numel * itemsize}
    if backward:
        out["ring_dkv"] = n * 2 * numel * 4
    return out
