"""The collectives of the sharded serving and training steps, through one
module.

Two kinds of process group carry them (``process_mesh.init_world`` and
``ProcessMesh.bind``):

- the **control** group, the world's default group, always gloo on host
  tensors: rank 0's broadcast of each step's packed int32 array;
- a **data** group per mesh axis, whose backend is an explicit argument
  of the mesh: ``"nccl"`` when every rank has its own card, ``"gloo"``
  when ranks share one card or run on the CPU.  Nothing picks or switches
  a backend on its own, and a collective that fails raises.

gloo takes CUDA tensors for every collective used here (all_reduce,
all_gather, all_to_all_single, broadcast; checked in fp32, bf16 and int8
on an H100 with PyTorch 2.11), copying through the host inside the
backend, so nothing is staged in this module.  bf16 sums are taken in
fp32 (``all_reduce``): the result rounds once, the same on every rank.
The data-movement collectives carry bf16 as its bit patterns.

The training steps add two: :func:`reduce_scatter` (a rank's row of the
sum of a ``[size, cols]`` matrix; the reference's ``psum_scatter``) and
:func:`shift` (send to the next rank of the axis, receive from the
previous one; the reference's ``ppermute`` over ``(i, i + 1 mod n)``).
``bf16`` is summed in fp32 here too, where XLA's scatter sums in the
operand's dtype.  gloo takes CUDA tensors for ``reduce_scatter_tensor``
(fp32 and fp16, PyTorch 2.11 on an H100), but not for point-to-point
sends: a send of a CUDA tensor closes the connection.  So ``shift`` of a
CUDA tensor on a gloo group goes through reused pinned host buffers (copy
out, send and receive on the host, copy back, all inside the op's
seconds); over nccl nothing is staged.

Point-to-point transfers: :func:`send` and :func:`recv` (a pipeline
stage's activations and cotangents, blocking, in schedule order) and
:func:`exchange` (a batch of sends and receives posted together, the
live reshape's moves).  On a gloo group a CUDA tensor goes through pinned
host buffers, as in ``shift``.

``STATS`` counts calls, wall seconds and payload bytes (each call's input
on this rank; a receive counts what it received) per collective in this
process; the bytes the engines report follow the reference's static
accounting (``jit/spmd.TPContext.collective_bytes``), not what a backend
moves.  Every call runs under the comm watchdog
(``comm_watchdog.comm_task``, off unless ``FLAGS_comm_task_timeout_s``
is set).
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .comm_watchdog import comm_task

__all__ = ["STATS", "reset_stats", "stats", "all_reduce", "all_reduce_max",
           "all_gather", "all_gather_rows", "all_to_all", "broadcast",
           "reduce_scatter", "shift", "send", "recv", "exchange"]

STATS: Dict[str, Dict[str, float]] = {"calls": {}, "seconds": {},
                                      "bytes": {}}


def reset_stats() -> None:
    for d in STATS.values():
        d.clear()


def stats() -> Dict[str, Dict[str, float]]:
    """A copy of ``STATS``."""
    return {k: dict(v) for k, v in STATS.items()}


def _count(op: str, seconds: float, t: torch.Tensor = None) -> None:
    STATS["calls"][op] = STATS["calls"].get(op, 0) + 1
    STATS["seconds"][op] = STATS["seconds"].get(op, 0.0) + seconds
    if t is not None:
        STATS["bytes"][op] = (STATS["bytes"].get(op, 0)
                              + t.numel() * t.element_size())


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _watch(op: str, group) -> comm_task:
    """The watchdog's task for one call on ``group`` (its ranks asked only
    when the watchdog is on)."""
    return comm_task(op, lambda: dist.get_process_group_ranks(group)
                     if group is not None else None)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group``; returns the sum (``t`` itself, summed in
    place, unless bf16: that is summed in fp32 and rounded once)."""
    t0 = time.perf_counter()
    work = t.to(torch.float32) if t.dtype == torch.bfloat16 else t
    with _watch("all_reduce", group):
        dist.all_reduce(work, op=dist.ReduceOp.SUM, group=group)
    out = work.to(t.dtype) if work is not t else t
    _sync(out)
    _count("all_reduce", time.perf_counter() - t0, t)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``t`` over ``group``, in place; returns ``t``."""
    t0 = time.perf_counter()
    with _watch("all_reduce", group):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    _sync(t)
    _count("all_reduce", time.perf_counter() - t0, t)
    return t


def _wire(t: torch.Tensor) -> torch.Tensor:
    """Data-movement collectives carry bf16 as its 16-bit patterns, in
    the fp16 dtype gloo moves (gloo takes no int16)."""
    return t.view(torch.float16) if t.dtype == torch.bfloat16 else t


def all_gather(t: torch.Tensor, dim: int, group, size: int,
               op: str = "all_gather") -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in rank order (the
    tiled all-gather); ``op`` names the call in ``STATS``."""
    t0 = time.perf_counter()
    src = _wire(t.contiguous())
    parts = [torch.empty_like(src) for _ in range(size)]
    with _watch(op, group):
        dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if t.dtype == torch.bfloat16:
        out = out.view(torch.bfloat16)
    _sync(out)
    _count(op, time.perf_counter() - t0, t)
    return out


def all_gather_rows(out: torch.Tensor, t: torch.Tensor, group,
                    op: str = "all_gather") -> torch.Tensor:
    """Gather every rank's 1-D ``t`` into the rows of ``out`` [size, n]
    (row ``g`` from rank ``g`` of ``group``), in place: no buffer is
    allocated.  ``op`` names the call in ``STATS``."""
    t0 = time.perf_counter()
    dst = _wire(out)
    with _watch(op, group):
        dist.all_gather(list(dst.unbind(0)), _wire(t.contiguous()),
                        group=group)
    _sync(out)
    _count(op, time.perf_counter() - t0, t)
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Split ``t`` along dim 0 into equal chunks, chunk ``g`` to rank
    ``g`` of ``group``; returns the received chunks stacked along dim 0
    in rank order (the tiled all_to_all with split and concat axis 0)."""
    t0 = time.perf_counter()
    src = _wire(t.contiguous())
    out = torch.empty_like(src)
    with _watch("all_to_all", group):
        dist.all_to_all_single(out, src, group=group)
    if t.dtype == torch.bfloat16:
        out = out.view(torch.bfloat16)
    _sync(out)
    _count("all_to_all", time.perf_counter() - t0, t)
    return out


def broadcast(t: torch.Tensor, src: int = 0, group=None,
              op: str = "broadcast") -> torch.Tensor:
    """Broadcast ``t`` from global rank ``src`` over ``group`` (default:
    the control group, the world's default gloo group, on host tensors),
    in place; bf16 travels as its bit patterns."""
    t0 = time.perf_counter()
    with _watch(op, group):
        dist.broadcast(_wire(t), src=src, group=group)
    _sync(t)
    _count(op, time.perf_counter() - t0, t)
    return t


# pinned host buffers for CUDA tensors on gloo, by (tag, shape, dtype)
_HOST: Dict[tuple, torch.Tensor] = {}


def _host_buffer(tag: str, like: torch.Tensor) -> torch.Tensor:
    key = (tag, tuple(like.shape), like.dtype)
    buf = _HOST.get(key)
    if buf is None:
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        _HOST[key] = buf
    return buf


def _staged(t: torch.Tensor, group) -> bool:
    """gloo closes the connection on a point-to-point CUDA tensor."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def reduce_scatter(flat: torch.Tensor, group, op: str = "reduce_scatter"
                   ) -> torch.Tensor:
    """``flat`` [size, cols] summed over ``group``; returns row ``r`` of
    the sum on the group's rank ``r`` (a new tensor of ``cols``).  bf16
    is summed in fp32 and rounded once, as :func:`all_reduce` does."""
    if flat.shape[0] != dist.get_world_size(group):
        raise ValueError("reduce_scatter: %d rows for a group of %d"
                         % (flat.shape[0], dist.get_world_size(group)))
    t0 = time.perf_counter()
    work = flat.to(torch.float32) if flat.dtype == torch.bfloat16 \
        else flat.contiguous()
    out = torch.empty(work.shape[1:], dtype=work.dtype, device=work.device)
    with _watch(op, group):
        dist.reduce_scatter_tensor(out.view(-1), work.view(-1),
                                   op=dist.ReduceOp.SUM, group=group)
    if flat.dtype == torch.bfloat16:
        out = out.to(torch.bfloat16)
    _sync(out)
    _count(op, time.perf_counter() - t0, flat)
    return out


def shift(t: torch.Tensor, group, ranks, index: int,
          op: str = "shift") -> torch.Tensor:
    """Send ``t`` to the next rank of ``group`` and return what the
    previous one sent (rank ``i`` receives rank ``i - 1``'s, mod the
    size): the reference's ``ppermute`` over ``perm = [(i, (i + 1) %
    n)]``.  ``ranks`` are the group's global ranks in order and
    ``index`` this rank's place in them."""
    t0 = time.perf_counter()
    n = len(ranks)
    src = _wire(t.contiguous())
    if n == 1:
        out = src.clone()
    else:
        nxt, prv = ranks[(index + 1) % n], ranks[(index - 1) % n]
        staged = _staged(src, group)
        send = _host_buffer("shift_out", src) if staged else src
        recv = (_host_buffer("shift_in", src) if staged
                else torch.empty_like(src))
        if staged:
            send.copy_(src)
        ops = [dist.P2POp(dist.isend, send, nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        with _watch(op, group):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = recv.to(src.device, copy=True) if staged else recv
    if t.dtype == torch.bfloat16:
        out = out.view(torch.bfloat16)
    _sync(out)
    _count(op, time.perf_counter() - t0, t)
    return out


def send(t: torch.Tensor, dst: int, group, op: str = "send") -> None:
    """Send ``t`` to global rank ``dst`` of ``group``; returns once the
    peer took it (blocking: a pipeline's sends run in schedule order)."""
    t0 = time.perf_counter()
    src = _wire(t.detach().contiguous())
    if _staged(src, group):
        buf = _host_buffer(op, src)
        buf.copy_(src)
        src = buf
    with _watch(op, group):
        dist.send(src, dst=dst, group=group)
    _count(op, time.perf_counter() - t0, t)


def recv(shape, dtype: torch.dtype, device, src: int, group,
         op: str = "recv") -> torch.Tensor:
    """Receive a ``shape`` / ``dtype`` tensor from global rank ``src`` of
    ``group``, onto ``device``; counted under ``op`` with the bytes it
    received."""
    t0 = time.perf_counter()
    out = torch.empty(shape, dtype=dtype, device=device)
    wire = _wire(out)
    buf = _host_buffer(op, wire) if _staged(wire, group) else wire
    with _watch(op, group):
        dist.recv(buf, src=src, group=group)
    if buf is not wire:
        wire.copy_(buf)
    _sync(out)
    _count(op, time.perf_counter() - t0, out)
    return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group,
             op: str = "exchange") -> int:
    """Post every ``(tensor, global dst rank)`` send and every ``(out,
    global src rank)`` receive of this rank together, then wait for all
    of them (every rank posts its part of one exchange).  A receive lands
    in its (contiguous) ``out`` in place.  Counted under ``op`` with the
    bytes this rank sent.  Returns the bytes of the host buffers it
    staged (a CUDA tensor on gloo goes through the host; else 0)."""
    t0 = time.perf_counter()
    ops: List[dist.P2POp] = []
    copies = []
    sent = staged = 0
    for t, dst in sends:
        w = _wire(t.contiguous())
        if _staged(w, group):
            w = w.to("cpu")
            staged += w.numel() * w.element_size()
        ops.append(dist.P2POp(dist.isend, w, dst, group))
        sent += t.numel() * t.element_size()
    for out, src in recvs:
        w = _wire(out)
        if _staged(w, group):
            host = torch.empty(w.shape, dtype=w.dtype)
            staged += host.numel() * host.element_size()
            copies.append((w, host))
            w = host
        ops.append(dist.P2POp(dist.irecv, w, src, group))
    if ops:
        with _watch(op, group):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    for w, host in copies:
        w.copy_(host)
    if recvs:
        _sync(recvs[0][0])
    STATS["calls"][op] = STATS["calls"].get(op, 0) + 1
    STATS["seconds"][op] = (STATS["seconds"].get(op, 0.0)
                            + time.perf_counter() - t0)
    STATS["bytes"][op] = STATS["bytes"].get(op, 0) + sent
    return staged
