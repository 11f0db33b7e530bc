"""Rank programs that serve workloads through sharded engines, for the CPU
tests and ``chip_smoke.py`` (run on every rank by
``distributed.launch.run_world``).

:func:`serve_cases` takes one argument dict:

- ``device``: ``"cpu"`` or None (the card; ranks share ``cuda:0``);
- ``backend``: the data groups' backend (``"gloo"`` or ``"nccl"``);
- ``models``: name -> ``{"family": "llama"|"qwen2"|"mixtral", "config":
  {...}, "state": path of an ``.npz`` of the reference's numpy state, or
  None for the seeded init (``"seed"``, default 0, drawn on the device as
  the one-card model draws it)}``;
- ``cases``: a list of ``{"name", "model", "mesh": {"tp": n, "ep": m,
  "cp": c, "fsdp": f, "dp": r} or None, "engine": engine keyword
  arguments, "ops": the workload}``.  A case without a mesh runs on rank
  0 alone (the one-device twin).  The workload is a list of ``["add",
  prompt, max_new_tokens, {keywords}]``, ``["step"]`` and ``["run"]``.
  ``"drop_copy_replay": True`` keeps rank 0 from broadcasting its
  copy-on-write page copies (the fault the replay prevents);
  ``"return_params": True`` adds each rank's stored parameters and
  ``"return_pools": True`` its layer pools (numpy, tiny models only).  A
  case ``{"name", "mesh", "helpers": {...}}`` runs ``spmd``'s step
  helpers instead (:func:`_helpers`).

Each case returns, from rank 0: the tokens of each added request in
order, the engine's facts (degrees, per-rank pool bytes, free pages,
prefix hits, refcounts, control broadcasts, top-budget collective bytes,
the fsdp gather's bytes a dispatch) and the deltas of the named metric
families; from every rank: its pool, expert and stored parameter bytes,
its kernel launch counts over the case, its collective calls, its peak
device memory and the case's wall seconds.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["serve_cases", "METRICS"]

# the metric families a case reports (deltas over the case)
METRICS = {
    "serving_tp_collective_bytes_total": ("psum", "all_gather"),
    "serving_quant_collective_bytes_total": ("all_gather",),
    "serving_ep_collective_bytes_total": ("all_to_all", "all_gather"),
    "serving_cp_collective_bytes_total": ("all_gather",),
    "spmd_allgather_bytes_total": ("serving_params",),
    "serving_moe_dispatch_tokens_total": ("routed", "dropped"),
}
_LABEL = {"serving_moe_dispatch_tokens_total": "fate",
          "spmd_allgather_bytes_total": "site"}
MESH_AXES = ("fsdp", "tp", "dp", "cp", "ep")


def _metric_values() -> Dict[str, float]:
    from ..observability import default_registry
    r = default_registry()
    out = {}
    for name, values in METRICS.items():
        m = r.get(name)
        for v in values:
            out["%s{%s}" % (name, v)] = (
                0.0 if m is None
                else m.labels(**{_LABEL.get(name, "op"): v}).value)
    for name in ("serving_tp_degree", "serving_ep_degree",
                 "serving_cp_degree"):
        m = r.get(name)
        out[name] = None if m is None else m.value
    m = r.get("serving_mesh_shape")
    for axis in MESH_AXES:
        out["serving_mesh_shape{%s}" % axis] = (
            None if m is None else m.labels(axis=axis).value)
    return out


def _model_cls(family: str):
    from .. import models
    return {"llama": (models.LlamaForCausalLM, models.LlamaConfig),
            "qwen2": (models.Qwen2ForCausalLM, models.Qwen2Config),
            "mixtral": (models.MixtralForCausalLM,
                        models.MixtralConfig)}[family]


def build_model(spec, mesh, device):
    """The model a case serves: this rank's shard under ``mesh``, the
    whole model without one (from the reference's state, or from the
    seed)."""
    from ..core.device import resolve_device
    from ..jit.spmd import shard_model
    from .parity import load_paddle_tpu_weights, shard_from_paddle_tpu
    cls, cfg_cls = _model_cls(spec["family"])
    cfg = cfg_cls(**spec["config"])
    dev = resolve_device(device)
    if spec.get("state") is not None:
        with np.load(spec["state"]) as z:
            np_state = {k: z[k] for k in z.files}
        if mesh is not None:
            return shard_from_paddle_tpu(cls, cfg, mesh, np_state,
                                         device=dev)
        model = cls(cfg, device=dev)
        load_paddle_tpu_weights(model, np_state)
        return model.eval()
    gen = torch.Generator(dev).manual_seed(int(spec.get("seed", 0)))
    if mesh is not None:
        return shard_model(cls, cfg, mesh, device=dev, generator=gen)
    return cls(cfg, device=dev, generator=gen).eval()


def mesh_of(spec, backend):
    """The mesh a case's ``{"tp", "ep", "cp", "fsdp", "dp"}`` names:
    ``mesh_2d`` with an fsdp or dp axis, ``cp_mesh`` with cp, ``ep_mesh``
    with ep, else ``tp_mesh``."""
    from ..jit.spmd import cp_mesh, ep_mesh, mesh_2d, tp_mesh
    if not spec:
        return None
    tp = spec.get("tp", 1)
    if "fsdp" in spec or "dp" in spec:
        return mesh_2d(spec.get("fsdp", 1), tp, replica=spec.get("dp", 1),
                       backend=backend)
    if "cp" in spec:
        return cp_mesh(spec["cp"], tp=tp, backend=backend)
    if spec.get("ep", 1) > 1:
        return ep_mesh(spec["ep"], tp=tp, backend=backend)
    return tp_mesh(tp, backend=backend)


def _launches() -> Dict[str, int]:
    """Every serving kernel's launch counts in this process."""
    from ..ops import dequant, kernels, paged_attention as pa
    out = {}
    for name, f, attrs in (
            ("ragged", pa.ragged_paged_attention,
             ("launches", "int8_launches", "generic_launches",
              "generic_int8_launches")),
            ("decode", pa.paged_attention,
             ("launches", "int8_launches", "generic_launches",
              "generic_int8_launches")),
            ("epilogue", kernels.rope_qkv_epilogue,
             ("launches", "amax_launches")),
            ("dequant_int8", dequant.dequant_int8, ("launches",))):
        for a in attrs:
            key = name if a == "launches" else \
                name + "_" + a[:-len("_launches")]
            out[key] = getattr(f, a)
    return out


def _run_ops(eng, ops):
    rids = []
    for op in ops:
        if op[0] == "add":
            kw = dict(op[3]) if len(op) > 3 else {}
            rid = eng.add_request(np.asarray(op[1], np.int64), int(op[2]),
                                  **kw)
            rids += rid if isinstance(rid, list) else [rid]
        elif op[0] == "step":
            eng.step()
        elif op[0] == "run":
            eng.run_to_completion()
        else:
            raise ValueError("unknown workload op %r" % (op,))
    return rids


def _engine_facts(eng) -> Dict:
    c0 = eng.caches[0]
    pc = eng.prefix_cache
    facts = {
        "tp_degree": eng.tp_degree, "ep_degree": eng.ep_degree,
        "cp_degree": eng.cp_degree, "fsdp_degree": eng.fsdp_degree,
        "dp_degree": eng.dp_degree, "tp_is_none": eng.tp is None,
        "fsdp_gather_bytes": eng._fsdp_gather_bytes,
        "weight_quant_bytes": eng.weight_quant_bytes,
        "fsdp_received_bytes": (
            (eng.tp.fsdp_params.gathered_bytes()
             if eng.tp is not None and eng.tp.fsdp_params else 0)
            + (eng.weight_qtree.gathered_bytes()
               if eng.weight_qtree is not None else 0)),
        "pool_bytes": c0.per_chip_pool_bytes(),
        "free": len(c0._free), "num_blocks": c0.num_blocks,
        "prefix_hits": {rid: r.prefix_hit_tokens
                        for rid, r in eng.finished.items()},
        "control_broadcasts": getattr(eng, "control_broadcasts", 0),
        "mixed_compiles": (eng.mixed.total_compiles
                           if eng.mixed is not None else None),
        "decode_compiles": eng.decode_step.compile_count,
        "prefill_compiles": (eng.prefill_step.total_compiles
                             if eng.prefill_step is not None else None),
    }
    if pc is not None:
        cached = pc.cached_blocks()
        facts["cached"] = len(cached)
        facts["cached_refcounts_one"] = all(c0.refcount(b) == 1
                                            for b in cached)
    if eng.tp is not None:
        top = (eng.mixed.collective_bytes(eng.token_budgets[-1])
               if eng.mixed is not None
               else eng.decode_step.collective_bytes(eng.max_batch_size))
        facts["collective_bytes_top"] = top
        facts["specs"] = {k: tuple(v) for k, v in eng.tp.specs.items()}
    return facts


def _expert_bytes(model) -> int:
    return sum(p.numel() * p.element_size()
               for n, p in model.named_parameters()
               if n.endswith(("w_gate", "w_up", "w_down")))


def _param_bytes(model) -> int:
    """Bytes of the parameters the rank stores."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def serve_cases(rank: int, world: int, args: Dict):
    from ..distributed import collective
    device = args.get("device")
    backend = args.get("backend", "gloo")
    if device is None:
        torch.cuda.set_device(0)
    out = []
    for case in args["cases"]:
        mesh = mesh_of(case.get("mesh"), backend)
        if "helpers" in case:
            res = _helpers(mesh, case["helpers"], device)
            out.append(res if rank == 0 else None)
            continue
        if mesh is None and rank != 0:
            dist.barrier()
            out.append(None)
            continue
        spec = args["models"][case["model"]]
        model = build_model(spec, mesh, device)
        from ..inference.serving import ContinuousBatchingEngine
        kw = dict(case.get("engine", {}))
        if device is not None:
            kw["device"] = device
        if device is None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        m0 = _metric_values()
        l0 = _launches()
        collective.reset_stats()
        eng = ContinuousBatchingEngine(model, mesh=mesh, **kw)
        t0 = time.perf_counter()
        if eng.tp is not None and rank != 0:
            eng.run_worker()
            res = {}
        else:
            if case.get("drop_copy_replay"):
                _drop_copy_replay(eng)
            ops = _count_device_ops(eng)
            rids = _run_ops(eng, case["ops"])
            eng.shutdown_workers()
            res = {"tokens": [eng.result(r) for r in rids],
                   "facts": dict(_engine_facts(eng), device_ops=ops)}
        if device is None:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        l1 = _launches()
        m1 = _metric_values()
        mine = {"rank": rank,
                "pool_bytes": eng.caches[0].per_chip_pool_bytes(),
                "expert_bytes": _expert_bytes(model),
                "param_bytes": _param_bytes(model),
                "launches": {k: l1[k] - l0[k] for k in l1},
                "wall": wall,
                "collectives": collective.stats(),
                "peak_bytes": (torch.cuda.max_memory_allocated()
                               if device is None else 0)}
        if mesh is not None:
            mine["axes"] = {n: (c.size, c.index)
                            for n, c in mesh.bind().items()}
        if case.get("return_params"):
            mine["params"] = {n: _numpy(p)
                              for n, p in model.named_parameters()}
        if case.get("return_pools"):
            mine["pools"] = [(_numpy(c.key_cache), _numpy(c.value_cache))
                             for c in eng.caches]
        res["metrics"] = {k: (m1[k] - m0[k] if m0[k] is not None
                              and m1[k] is not None
                              and k.endswith("}") and "mesh" not in k
                              else m1[k]) for k in m1}
        if mesh is not None:
            ranks = [None] * world
            dist.all_gather_object(ranks, mine)
        else:
            ranks = [mine]
            dist.barrier()
        res["ranks"] = ranks
        out.append(res if rank == 0 else None)
        del eng, model
        if device is None:
            torch.cuda.empty_cache()
    return out


def _count_device_ops(eng) -> Dict[str, int]:
    """Count rank 0's device operations as the engine runs them: the
    steps (each mixed step, prefill chunk and decode step) and the
    copy-on-write page copies."""
    counts = {"steps": 0, "copies": 0}

    def counted(fn, key):
        def run(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return run
    for name in ("_exec_mixed", "_exec_prefill", "_exec_decode"):
        setattr(eng, name, counted(getattr(eng, name), "steps"))
    eng._copy_block = counted(eng._copy_block, "copies")
    return counts


def _drop_copy_replay(eng) -> None:
    """The fault the replay prevents: rank 0 copies its shared page on
    copy-on-write but does not tell the other ranks."""
    from ..jit.serving_step import copy_block

    def local_only(src, dst):
        copy_block(eng.caches, src, dst)
    eng._copy_block = local_only


def _helpers(mesh, h, device):
    """``spmd``'s step helpers on this rank's shards: the vocab-parallel
    embedding of ``h["tokens"]`` over the rows of ``h["table"]``, and the
    exact and int8 all-gathers of ``h["logits"]``'s vocab columns."""
    from ..jit.spmd import tp_embed, tp_gather_logits, tp_gather_logits_q8
    comm = mesh.bind()["tp"]
    dev = "cuda" if device is None else device
    table = torch.from_numpy(np.asarray(h["table"])).to(dev)
    vs = table.shape[0] // comm.size
    tok = torch.from_numpy(np.asarray(h["tokens"])).to(dev)
    logits = torch.from_numpy(np.asarray(h["logits"])).to(dev)
    vl = logits.shape[-1] // comm.size
    mine = logits[..., comm.index * vl:(comm.index + 1) * vl]
    return {"embed": tp_embed(table[comm.index * vs:(comm.index + 1) * vs],
                              tok, comm).cpu().numpy(),
            "gather": tp_gather_logits(mine, comm).cpu().numpy(),
            "q8": tp_gather_logits_q8(mine, comm).cpu().numpy()}
