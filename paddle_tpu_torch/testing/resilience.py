"""Rank programs for training that survives and moves: the checkpoint and
live-reshape case and the pipeline case of ``testing.sharded.
train_cases`` (``"kind": "checkpoint"`` / ``"pipeline"``), for the CPU
tests and ``chip_smoke.py``.

A **checkpoint** case (every rank of the world):

1. builds the source step (``mesh``: ``{"dp": n}`` ZeRO with ``stage``,
   ``{"fsdp", "tp"[, "dp"]}`` 2-D) and trains ``steps`` steps, or, with
   ``from_reference`` (a reference checkpoint directory), loads that one
   instead (``parity.train_state_from_paddle_tpu``);
2. saves it asynchronously (``CheckpointManager`` under ``dir``; the
   stall of ``save``'s return and the write seconds of
   ``checkpoint_save_duration_seconds`` are recorded), then trains
   ``continue`` more steps on the source mesh while the write is in
   flight (with ``live`` and no ``continue``, the reshape and the live
   arm run while it is); with ``inplace_gate`` every box the rank saved
   is then compared bitwise with a clone taken before those steps;
3. restores the checkpoint onto each mesh of ``restore`` (``{name:
   mesh}``; None = the one-rank step on rank 0) and trains ``continue``
   steps there (the uninterrupted run's batches);
4. with ``live`` (a mesh): saves the source step again (synchronously,
   when it moved on), ``jit.redistribute.live_reshape`` s it onto
   ``live`` and trains ``after`` steps (the live arm), then builds a
   fresh step there, restores the checkpoint and trains the same steps
   (the restart arm); every rank reports whether each of its parameters
   and state leaves are bitwise equal between the arms, the plan, its
   sent bytes, the allocator's peak over the reshape beyond what it held
   before (measured: the CUDA allocator, or the CPU profiler's
   allocation timeline), the new slices it keeps, and the most host
   bytes one leaf's exchange staged, also as a share of that leaf.

A **redistribute** case moves the rows of ``x`` (row-sharded over the
world's ranks, ``P("dp")``) and the replicated ``b`` onto the first
``dst`` ranks (``redistribute_tree`` with a registry of its own); a
**state_dict** case saves ``x`` placed fsdp x tp over four ranks, ``y``
split over all four and a whole ``w`` with ``save_state_dict`` (async)
under ``dir``, then loads ``x`` as rows over the first two ranks and
``y``, ``w`` whole with ``load_state_dict`` (with ``fault_rank``, that
rank's data write fails instead, ``async`` or not, and every rank reports
the error it raised); a **spmd_pipeline** case runs
``distributed.pipelining.spmd_pipeline`` over the world's ranks as stages
(rank ``s`` holds ``stages[s]``; loss ``sum(y ** 2)``), both for the CPU
tests.

An **outside** case builds a step on each mesh of ``meshes`` (a pipeline
step on a ``pipe`` mesh, else a ``TrainStep``), each smaller than the
world, and reports per rank the ``ValueError`` it raised (None where it
built): a rank outside the mesh must refuse it.

A **pipeline** case runs ``models.llama_pipeline.LlamaPipelineTrainStep``
over ``mesh`` (``{"data", "pipe", "sharding", "model"}`` sizes, laid out
in that order) with ``micro`` micro-batches and ``remat``; ``grad_norms``
records every owned parameter's gradient as the rank updates with it.

Each returns, from rank 0, its losses by arm and every rank's flash
launches and walls by arm, collective stats and the facts named above.
"""
from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["checkpoint_case", "outside_case", "pipeline_case",
           "redistribute_case", "spmd_pipeline_case", "state_dict_case",
           "train_mesh", "PIPE_AXES"]

PIPE_AXES = ("data", "pipe", "sharding", "model")


def train_mesh(m, backend):
    """The mesh of ``m``: ``{"dp": n}`` a 1-D dp mesh, ``{"fsdp", "tp",
    "dp"}`` ``spmd.mesh_2d``, ``{"pipe", ...}`` the pipeline's mesh, None
    none."""
    from ..distributed.process_mesh import ProcessMesh
    from ..jit.spmd import mesh_2d
    if not m:
        return None
    if "pipe" in m:
        names = [a for a in PIPE_AXES if a in m]
        return ProcessMesh([m[a] for a in names], names, backend=backend)
    if "fsdp" in m:
        return mesh_2d(m["fsdp"], m.get("tp", 1), replica=m.get("dp", 1),
                       backend=backend)
    return ProcessMesh([m["dp"]], ["dp"], backend=backend)


def _sync(device):
    if device is None:
        torch.cuda.synchronize()


def _hist_sum(name: str) -> float:
    from ..observability import default_registry
    h = default_registry().get(name)
    return 0.0 if h is None else h.sum


def _global_bytes(values) -> int:
    """Σ each value's whole bytes (``Placed`` values at their whole
    shape)."""
    total = 0
    for v in values.values():
        t = getattr(v, "local", v)
        shape = v.shape if hasattr(v, "local") else tuple(t.shape)
        total += int(np.prod(shape, dtype=np.int64)) * t.element_size()
    return total


def _alloc_peak(fn, device):
    """``(fn(), the most bytes the allocator held during it beyond what
    it held before)``: the CUDA caching allocator's peak on the card
    (``device`` None), on the CPU the allocation timeline that the
    profiler records (every allocation and free, op by op)."""
    if device is None:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base
    from torch import profiler
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU],
                          profile_memory=True) as prof:
        out = fn()
    held = peak = 0
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        held += e.self_cpu_memory_usage
        peak = max(peak, held)
    return out, peak


def _new_slice_bytes(plan, rank: int) -> int:
    """Σ the destination slices ``rank`` holds after an apply and did not
    adopt: the new state it keeps."""
    from ..jit.redistribute import box_nelems
    total = 0
    for leaf in plan.leaves:
        src, dst = plan.maps[leaf.key]
        if rank in dst and dst[rank] != src.get(rank):
            total += box_nelems(dst[rank]) * leaf.itemsize
    return total


def checkpoint_case(rank, case, spec, device, backend):
    from ..distributed import collective
    from ..distributed.checkpoint import CheckpointManager
    from ..jit.redistribute import Placed, live_reshape, spec_box
    from ..jit.spmd import ShardingConfig
    from ..jit.train_step import TrainStep
    from ..models.llama import LlamaPretrainingCriterion
    from .sharded import (_batches, _flash_launches, _optimizer,
                          _train_model)

    def make(m):
        mesh = train_mesh(m, backend)
        if mesh is not None:
            mesh.make_groups()               # collective over the world
            if not mesh.holds(rank):
                return None
        elif rank != 0:
            return None
        model = _train_model(spec, case.get("config"), device)
        opt = _optimizer(model, case.get("optimizer"))
        kw = {}
        if mesh is not None:
            kw = dict(mesh=mesh, sharding=ShardingConfig(
                stage=case.get("stage", 2),
                bucket_mb=case.get("bucket_mb", 25.0),
                axis="fsdp" if "fsdp" in m else "dp"))
        return TrainStep(model, LlamaPretrainingCriterion(), opt,
                         clip_norm=case.get("clip"), **kw)

    batches = None
    losses: Dict[str, object] = {}
    mine: Dict[str, object] = {"rank": rank, "launches": {}, "walls": {}}
    w0 = 0.0

    def finish_write(mgr, w0):
        """Join the first save's write (once): its seconds and the steps
        then valid."""
        if "write_s" in mine:
            return
        mgr.wait()
        mine["write_s"] = _hist_sum("checkpoint_save_duration_seconds") - w0
        mine["valid_steps"] = [s for s, _ in mgr.all_valid()]

    def run(step, first, count, arm):
        nonlocal batches
        if batches is None:
            batches = _batches(case, step.model.config.vocab_size, device)
        l0 = _flash_launches()
        _sync(device)
        t0 = time.perf_counter()
        out = [step(*batches[(first + i) % len(batches)]).item()
               for i in range(count)]
        _sync(device)
        mine["walls"][arm] = time.perf_counter() - t0
        l1 = _flash_launches()
        mine["launches"][arm] = {k: l1[k] - l0[k] for k in l1}
        return out

    k = case.get("steps", 1)
    c = case.get("continue", 0)
    n = case.get("after", 1)
    step = None
    if case.get("from_reference"):
        from .parity import train_state_from_paddle_tpu
        state = train_state_from_paddle_tpu(
            CheckpointManager(case["from_reference"]).load())
        k = int(state.meta["global_step"])
        mgr = None
    else:
        step = make(case["mesh"])
        losses["before"] = run(step, 0, k, "before")
        vals = step.ckpt_values()
        if rank == 0:
            losses["global_bytes"] = _global_bytes(vals)
        clones = {}
        if case.get("inplace_gate"):
            clones = {key: v.local.clone() if isinstance(v, Placed)
                      else v.clone() for key, v in vals.items()}
        mgr = CheckpointManager(case["dir"], keep_last_k=case.get("keep", 3))
        w0 = _hist_sum("checkpoint_save_duration_seconds")
        _sync(device)
        t0 = time.perf_counter()
        mgr.save(k, vals, {"global_step": k})
        mine["save_stall_s"] = time.perf_counter() - t0
        del vals
        mine["snapshot_bytes"] = mgr.last_snapshot_bytes
        losses["continued"] = run(step, k, c, "continued")
        state = None
        if clones or case.get("restore"):
            finish_write(mgr, w0)
            state = mgr.load(k)
        if clones:
            same = True
            mesh = step._mesh if step._mode in ("1d", "2d") else None
            for key, v in step.ckpt_values().items():
                t = v.local if isinstance(v, Placed) else v
                placed = v.spec if isinstance(v, Placed) else ()
                sizes = mesh.axis_sizes() if mesh is not None else {}
                coords = mesh.coords(rank) if mesh is not None else {}
                box = spec_box(v.shape if isinstance(v, Placed)
                               else tuple(t.shape), placed, sizes, coords)
                got = state.box_tensor(key, box)
                same &= bool(torch.equal(got, clones[key].cpu()))
            mine["snapshot_bitwise"] = same
            del clones
    restored = {}
    for name, m in (case.get("restore") or {}).items():
        twin = make(m)
        if twin is not None:
            twin.load_train_state(state)
            restored[name] = run(twin, k, c, "restore_" + name)
        del twin
        dist.barrier()
    losses["restored"] = restored
    live = case.get("live")
    if live is not None:
        if c:
            finish_write(mgr, w0)
            mgr.save(k + c, step.ckpt_values(), {"global_step": k + c},
                     sync=True)
        collective.reset_stats()
        dst_mesh = train_mesh(live, backend)
        _sync(device)
        t0 = time.perf_counter()
        (new, plan), peak = _alloc_peak(
            lambda: live_reshape(step, dst_mesh), device)
        mine["reshape_s"] = time.perf_counter() - t0
        mine["plan"] = dict(plan.summary(),
                            sent_bytes=plan.rank_sent_bytes,
                            wire_bytes=collective.stats()["bytes"].get(
                                "redistribute", 0),
                            alloc_peak_bytes=peak,
                            new_bytes=_new_slice_bytes(plan, rank),
                            host_staging_bytes=max(
                                plan.rank_host_staged_bytes.values()),
                            host_staging_share=max(
                                plan.rank_host_staged_bytes[leaf.key]
                                / leaf.nbytes for leaf in plan.leaves))
        if rank == 0:
            losses["plan_leaves"] = [
                (leaf.key, leaf.shape, leaf.itemsize) + plan.maps[leaf.key]
                + (leaf.moved_bytes, leaf.adopted_bytes,
                   leaf.full_gather_equiv_bytes, leaf.max_dst_shard_bytes)
                for leaf in plan.leaves]
        del step
        if new is not None:
            # the write of step k goes on meanwhile
            losses["live"] = run(new, k + c, n, "live")
        restart = make(live)              # needs no checkpoint yet
        finish_write(mgr, w0)
        t0 = time.perf_counter()
        if new is not None:
            state = mgr.load(k + c)
            restart.load_train_state(state)
            _sync(device)
            mine["restore_s"] = time.perf_counter() - t0
            mine["payloads_read"] = sorted(os.path.basename(f)
                                           for f in state.read)
            losses["restart"] = run(restart, k + c, n, "restart")
            a = new.ckpt_values()
            b = restart.ckpt_values()
            mine["bitwise"] = all(
                torch.equal(getattr(a[key], "local", a[key]),
                            getattr(b[key], "local", b[key])) for key in a)
        del new, restart
    if mgr is not None:
        finish_write(mgr, w0)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if device is None:
        torch.cuda.empty_cache()
    return {"losses": losses, "ranks": ranks}


def pipeline_case(rank, case, spec, device, backend):
    from ..distributed import collective
    from ..models.llama_pipeline import LlamaPipelineTrainStep
    from .sharded import (_batches, _flash_launches, _numpy, _optimizer,
                          _record_grads, _train_model)
    mesh = train_mesh(case["mesh"], backend)
    model = _train_model(spec, case.get("config"), device)
    opt = _optimizer(model, case.get("optimizer"))
    if device is None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    step = LlamaPipelineTrainStep(model, opt, mesh,
                                  n_microbatches=case["micro"],
                                  clip_norm=case.get("clip"),
                                  remat=case.get("remat", False))
    batches = _batches(case, model.config.vocab_size, device)
    collective.reset_stats()
    l0 = _flash_launches()
    grads = []
    undo = _record_grads(step, grads) if case.get("grad_norms") else None
    _sync(device)
    t0 = time.perf_counter()
    losses = []
    for i in range(case.get("steps", 1)):
        grads.append({})
        losses.append(step(*batches[i % len(batches)]))
    _sync(device)
    wall = time.perf_counter() - t0
    if undo is not None:
        undo()
    l1 = _flash_launches()
    mine = {"rank": rank, "stage": step.stage, "wall": wall,
            "launches": {k: l1[k] - l0[k] for k in l1},
            "collectives": collective.stats(),
            "specs": {k: tuple(v) for k, v in step._specs.items()},
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in step._stored.values()),
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if device is None else 0)}
    if case.get("grad_norms"):
        mine["grad_sq"] = [{k: v for k, v in g.items() if k is not None}
                           for g in grads]
    if case.get("return_params"):
        mine["params"] = {k: _numpy(t) for k, t in step._stored.items()}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    del step, model, opt
    if device is None:
        torch.cuda.empty_cache()
    return {"losses": [x.item() for x in losses], "ranks": ranks}


def redistribute_case(rank, case, device, backend):
    from ..distributed.process_mesh import ProcessMesh
    from ..jit.redistribute import Placed, redistribute_tree
    from ..jit.spmd import P
    from ..observability.metrics import MetricsRegistry
    from .sharded import _numpy
    world = dist.get_world_size()
    src = ProcessMesh([world], ["dp"], backend=backend)
    dst = ProcessMesh([case["dst"]], ["dp"], backend=backend)
    src.bind()
    dst.make_groups()
    x = torch.from_numpy(np.asarray(case["x"], np.float32))
    rows = x.shape[0] // world
    arrays = {"x": Placed(x[rank * rows:(rank + 1) * rows].clone(),
                          P("dp"), src),
              "b": Placed(torch.from_numpy(np.asarray(case["b"],
                                                      np.float32)),
                          P(), src)}
    reg = MetricsRegistry()
    moved, plan = redistribute_tree(
        arrays, {"x": (P("dp"), dst), "b": (P(), dst)}, registry=reg)
    m = reg.get("redistribute_bytes_total")
    mine = {"rank": rank,
            "x": None if moved["x"] is None else _numpy(moved["x"]),
            "b": None if moved["b"] is None else _numpy(moved["b"]),
            "b_adopted": moved["b"] is arrays["b"].local,
            "summary": plan.summary(), "sent": plan.rank_sent_bytes,
            "metric": {kind: m.labels(kind=kind).value
                       for kind in ("moved", "full_gather_equiv")}}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks}


def spmd_pipeline_case(rank, case, device, backend):
    from ..distributed.pipelining import spmd_pipeline
    from ..distributed.process_mesh import ProcessMesh
    mesh = ProcessMesh([dist.get_world_size()], ["pipe"], backend=backend)
    stage = {k: torch.from_numpy(np.asarray(v, np.float32)).requires_grad_()
             for k, v in case["stages"][rank].items()}
    xs = torch.from_numpy(np.asarray(case["xs"], np.float32))

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    ys = spmd_pipeline(stage_fn, stage, xs, mesh=mesh, axis_name="pipe",
                       remat=case.get("remat", False))
    loss = (ys ** 2).sum()
    loss.backward()
    mine = {"rank": rank, "loss": loss.item(),
            "grads": {k: v.grad.numpy().copy() for k, v in stage.items()}}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"ranks": ranks}


def state_dict_case(rank, case, device, backend):
    from ..distributed.checkpoint import load_state_dict, save_state_dict
    from ..distributed.process_mesh import ProcessMesh
    from ..jit.redistribute import Placed, spec_box
    from ..jit.spmd import P
    src = ProcessMesh([2, 2], ["fsdp", "tp"], backend=backend)
    dst = ProcessMesh([2], ["dp"], backend=backend)
    src.bind()
    dst.make_groups()
    x = torch.from_numpy(np.asarray(case["x"], np.float32))
    y = torch.from_numpy(np.asarray(case["y"], np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(np.asarray(case["w"], np.float32))

    def mine(t, spec, mesh):
        box = spec_box(tuple(t.shape), spec, mesh.axis_sizes(),
                       mesh.coords(rank) if mesh.holds(rank)
                       else mesh.coords(0))
        for dim, (lo, hi) in enumerate(box):
            t = t.narrow(dim, lo, hi - lo)
        return t.clone()
    values = {
        "x": Placed(mine(x, P("tp", "fsdp"), src), P("tp", "fsdp"), src),
        "y": Placed(mine(y, P(("fsdp", "tp")), src), P(("fsdp", "tp")), src),
        "w": w}
    ranks = [None] * dist.get_world_size()
    if "fault_rank" in case:
        from . import faults
        if rank == case["fault_rank"]:
            faults.configure("ioerror:ckpt.write")
        try:
            handle = save_state_dict(values, case["dir"],
                                     async_save=case["async"])
            if handle is not None:
                handle.join()
            err = None
        except Exception as e:                        # noqa: BLE001
            err = "%s: %s" % (type(e).__name__, e)
        finally:
            faults.reset()
        dist.all_gather_object(ranks, {"rank": rank, "error": err})
        return {"ranks": ranks}
    handle = save_state_dict(values, case["dir"], async_save=True)
    handle.join()
    rows = torch.zeros_like(mine(x, P("dp"), dst))
    got = {"x": Placed(rows, P("dp"), dst), "y": torch.zeros_like(y),
           "w": torch.zeros_like(w)}
    load_state_dict(got, case["dir"])
    out = {"rank": rank, "x": rows.numpy().copy(),
           "y": got["y"].to(torch.float32).numpy(), "w": got["w"].numpy()}
    dist.all_gather_object(ranks, out)
    return {"ranks": ranks}


def outside_case(rank, case, spec, device, backend):
    from ..jit.spmd import ShardingConfig
    from ..jit.train_step import TrainStep
    from ..models.llama import LlamaPretrainingCriterion
    from ..models.llama_pipeline import LlamaPipelineTrainStep
    from .sharded import _optimizer, _train_model
    errors = {}
    for name, m in case["meshes"].items():
        mesh = train_mesh(m, backend)
        model = _train_model(spec, case.get("config"), device)
        opt = _optimizer(model, case.get("optimizer"))
        try:
            if "pipe" in m:
                LlamaPipelineTrainStep(model, opt, mesh, n_microbatches=2)
            else:
                TrainStep(model, LlamaPretrainingCriterion(), opt,
                          mesh=mesh, sharding=ShardingConfig(stage=2))
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {"rank": rank, "errors": errors})
    return {"ranks": ranks}
