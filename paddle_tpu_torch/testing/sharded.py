"""Rank programs that serve workloads through sharded engines
(:func:`serve_cases`) and train through sharded steps
(:func:`train_cases`), for the CPU tests and ``chip_smoke.py`` (run on
every rank by ``distributed.launch.run_world``).

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

import math
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["serve_cases", "train_cases", "grad_norms", "METRICS"]

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
    """A copy (a CPU fp32 tensor's ``numpy()`` would share its memory)."""
    return t.detach().to("cpu", torch.float32).numpy().copy()


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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _flash_launches() -> Dict[str, int]:
    from ..ops import flash_attention as fa
    return {k: getattr(fa, k).launches
            for k in ("flash_fwd", "flash_bwd_fused", "flash_bwd_two_kernel")}


def _train_model(spec, overrides, device):
    """A whole model on every rank, from the reference's state or the
    seed (drawn on the device as the one-card model draws it)."""
    from ..core.device import resolve_device
    from .parity import load_paddle_tpu_weights
    cls, cfg_cls = _model_cls(spec["family"])
    cfg = cfg_cls(**dict(spec["config"], **(overrides or {})))
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(int(spec.get("seed", 0)))
    model = cls(cfg, device=dev, generator=gen)
    if spec.get("state") is not None:
        with np.load(spec["state"]) as z:
            load_paddle_tpu_weights(model, {k: z[k] for k in z.files})
    return model.train()


def _optimizer(model, o):
    from .. import optimizer as optim
    o = dict(o or {})
    name = o.pop("name", "adamw")
    cls = {"adamw": optim.AdamW, "adam": optim.Adam,
           "adafactor": optim.Adafactor}[name]
    return cls(parameters=model.named_parameters(), **o)


def _batches(case, vocab: int, device):
    """The global batches of a case, identical on every rank: ``batches``
    (a list of ``(ids, labels)`` arrays, cycled) or ``random`` (``{"shape",
    "seed", "count"}``: ``count`` batches, default 1, each ids = labels
    drawn from ``[1, vocab)`` in turn, cycled)."""
    dev = "cuda" if device is None else device
    if "batches" in case:
        return [tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in b)
                for b in case["batches"]]
    r = case["random"]
    rng = np.random.RandomState(r["seed"])
    out = []
    for _ in range(r.get("count", 1)):
        ids = torch.from_numpy(rng.randint(1, vocab, r["shape"])).to(dev)
        out.append((ids, ids))
    return out


def _meshes(case, backend):
    """The case's mesh (``mesh``: the ``dp``/``fsdp``/``tp`` degrees) or
    hybrid group (``hybrid``: ``dp``/``sep``), made current."""
    from ..distributed.process_mesh import ProcessMesh
    from ..distributed.topology import create_hybrid_group
    from ..jit.spmd import mesh_2d
    m = case.get("mesh")
    if case.get("hybrid"):
        h = case["hybrid"]
        return None, create_hybrid_group(dp=h.get("dp", 1),
                                         sep=h.get("sep", 1),
                                         backend=backend)
    if not m:
        return None, None
    if "fsdp" in m:
        return mesh_2d(m["fsdp"], m.get("tp", 1), replica=m.get("dp", 1),
                       backend=backend), None
    return ProcessMesh([m["dp"]], ["dp"], backend=backend), None


def _state_numpy(step) -> Dict[str, np.ndarray]:
    return {k: _numpy(v) for k, v in step.opt_state_arrays().items()}


def _record_grads(step, steps):
    """Record, a step at a time into ``steps`` (the caller appends a dict
    before each step), every parameter's gradient as this rank hands it
    to the update: ``{name: [sum of squares before the clip, numel]}``,
    the clip's scale taken back out.  Wraps the step's ``_scale`` and its
    optimizer's ``_update_rule`` on these instances only; returns the
    function that takes the wrappers off."""
    opt = step.optimizer
    names = {id(opt.state(k)): k for k, _ in step._params}
    inner_scale, inner_rule = step._scale, opt._update_rule

    def scale(grads, total_sq):
        norm = math.sqrt(float(total_sq))
        steps[-1][None] = (step.clip_norm / max(norm, step.clip_norm)) ** 2
        return inner_scale(grads, total_sq)

    def rule(p, g, state, lr):
        sq = g.to(torch.float64).square().sum().item()
        steps[-1][names[id(state)]] = [sq / steps[-1].get(None, 1.0),
                                       g.numel()]
        return inner_rule(p, g, state, lr)
    step._scale, opt._update_rule = scale, rule

    def undo():
        del step._scale, opt._update_rule
    return undo


def grad_norms(ranks, shapes) -> list:
    """Each step's gradient norm a parameter, before the clip, from the
    ``grad_sq`` of every rank of a case (:func:`_record_grads`) and the
    parameters' whole ``shapes``: a slice of ``1/part`` of a parameter is
    held by ``n/part`` of the ``n`` ranks that hold the parameter at all
    (a pipeline stage's ranks hold its layers alone), so each rank's
    squares count ``part/n``."""
    out = []
    for i in range(len(ranks[0]["grad_sq"])):
        keys = sorted({k for r in ranks for k in r["grad_sq"][i]})
        step = {}
        for k in keys:
            held = [r["grad_sq"][i][k] for r in ranks if k in r["grad_sq"][i]]
            step[k] = math.sqrt(sum(sq * math.prod(shapes[k]) / (numel *
                                                                len(held))
                                    for sq, numel in held))
        out.append(step)
    return out


def _train_case(rank, case, spec, device, backend):
    from ..distributed import collective
    from ..distributed.topology import set_hybrid_communicate_group
    from ..jit.spmd import ShardingConfig
    from ..jit.train_step import TrainStep
    from ..models.llama import LlamaPretrainingCriterion
    mesh, hcg = _meshes(case, backend)
    if mesh is None and hcg is None and rank != 0:
        return None
    model = _train_model(spec, case.get("config"), device)
    opt = _optimizer(model, case.get("optimizer"))
    kw = {}
    if mesh is not None:
        kw = dict(mesh=mesh, sharding=ShardingConfig(
            stage=case.get("stage", 1),
            bucket_mb=case.get("bucket_mb", 25.0),
            axis="fsdp" if "fsdp" in case["mesh"] else "dp"))
    if device is None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    step = TrainStep(model, LlamaPretrainingCriterion(), opt,
                     clip_norm=case.get("clip"), **kw)
    batches = _batches(case, model.config.vocab_size, device)
    if case.get("bad_batch"):
        ids = batches[0][0][:-1]
        try:
            step(ids, ids)
        except ValueError as e:
            return {"error": str(e)}
        raise AssertionError("a batch the degree does not divide trained")
    m0 = _train_metrics()
    warm = [step(*batches[i % len(batches)]).item()
            for i in range(case.get("warmup", 0))]
    collective.reset_stats()
    l0 = _flash_launches()
    if device is None:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, grads = [], []
    undo = _record_grads(step, grads) if case.get("grad_norms") else None
    for i in range(case.get("steps", 1)):
        b = batches[(len(warm) + i) % len(batches)]
        grads.append({})
        losses.append(step(*b))
    if undo is not None:
        undo()
    if device is None:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = warm + [x.item() for x in losses]
    l1 = _flash_launches()
    m1 = _train_metrics()
    params = dict(model.named_parameters())
    mine = {"rank": rank, "wall": wall,
            "launches": {k: l1[k] - l0[k] for k in l1},
            "collectives": collective.stats(),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in params.values()),
            "state_bytes": sum(v.numel() * v.element_size()
                               for v in step.opt_state_arrays().values()),
            "state_shapes": {k: tuple(v.shape) for k, v in
                             step.opt_state_arrays().items()},
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if device is None else 0),
            "metrics": {k: m1[k] - m0.get(k, 0.0) if k.endswith("}")
                        else m1[k] for k in m1}}
    if case.get("grad_norms"):
        mine["grad_sq"] = [{k: v for k, v in g.items() if k is not None}
                           for g in grads]
    if step._mode in ("1d", "2d"):
        mine["shardable"] = dict(step._shardable)
    if step._mode == "1d":
        mine["bucket_bytes"] = step.bucket_bytes()
    if step._mode == "2d":
        mine["specs"] = {k: tuple(v) for k, v in step._specs.items()}
        mine["gather_bytes_per_step"] = step._gather_bytes_per_step
    if step._mode is not None:
        mine["leaf_specs"] = {k: tuple(v)
                              for k, v in step.leaf_specs().items()}
    if case.get("return_params"):
        mine["params"] = {n: _numpy(p) for n, p in params.items()}
    if case.get("return_state"):
        mine["state"] = _state_numpy(step)
    res = {"losses": losses}
    if case.get("return_whole"):
        from .parity import gather_placed, paddle_tpu_names
        res["whole"] = paddle_tpu_names(gather_placed(
            params, getattr(step, "_specs", {}),
            getattr(step, "_mesh", None)))
    if case.get("resume") is not None:
        res["resumed"] = _resume(step, model, case, batches)
    if mesh is not None or hcg is not None:
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
    else:
        ranks = [mine]
    res["ranks"] = ranks
    set_hybrid_communicate_group(None)
    del step, model, opt
    if device is None:
        torch.cuda.empty_cache()
    return res


def _resume(step, model, case, batches):
    """The optimizer state round trip: every rank's state gathered whole
    (``parity.gather_placed``), loaded into a fresh step of the same
    placement over the trained parameters (``load_opt_state_arrays``), and
    both steps run ``resume`` more steps on the same batches: their
    losses."""
    from ..jit.train_step import TrainStep
    from .parity import gather_placed
    whole = gather_placed(step.opt_state_arrays(), step.leaf_specs(),
                          getattr(step, "_mesh", None))
    params = gather_placed({k: p.detach() for k, p in
                            model.named_parameters()},
                           getattr(step, "_specs", {}),
                           getattr(step, "_mesh", None))
    twin = _train_model({"family": case["family"], "config": case["cfg"]},
                        None, case["device"])
    with torch.no_grad():
        for n, p in twin.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    opt = _optimizer(twin, case.get("optimizer"))
    opt._global_step = step.optimizer._global_step
    kw = {}
    if getattr(step, "_mesh", None) is not None:
        kw = dict(mesh=step._mesh, sharding=step._cfg)
    from ..models.llama import LlamaPretrainingCriterion
    other = TrainStep(twin, LlamaPretrainingCriterion(), opt,
                      clip_norm=case.get("clip"), **kw)
    other.load_opt_state_arrays(whole)
    out = {"loaded": [], "continued": []}
    for i in range(case["resume"]):
        b = batches[i % len(batches)]
        out["continued"].append(step(*b).item())
        out["loaded"].append(other(*b).item())
    return out


def _train_metrics() -> Dict[str, float]:
    from ..observability import default_registry
    r = default_registry()
    m = r.get("spmd_allgather_bytes_total")
    g = r.get("train_fsdp_degree")
    return {"spmd_allgather_bytes_total{train_params}":
            0.0 if m is None else m.labels(site="train_params").value,
            "train_fsdp_degree": None if g is None else g.value}


def _attention_case(rank, case, device, backend):
    """``sdpa_ring`` / ``sdpa_ulysses`` on this rank's slices of the global
    ``q``, ``k``, ``v`` (``[B, S, H, D]``; batch over ``dp``, sequence
    over ``sep``), backward from ``sum(out * g)``: rank 0 returns the
    whole ``out``, ``dq``, ``dk``, ``dv`` and every rank's launches."""
    from ..distributed import collective
    from ..distributed.topology import (create_hybrid_group,
                                        set_hybrid_communicate_group)
    from ..ops.sequence_parallel import sdpa_ring, sdpa_ulysses
    dp, sep = case.get("dp", 1), case["sep"]
    hcg = create_hybrid_group(dp=dp, sep=sep, backend=backend)
    d, s = hcg.get_data_parallel_rank(), hcg.get_sep_parallel_rank()
    dev = "cuda" if device is None else device
    dtype = getattr(torch, case.get("dtype", "float32"))

    def mine(name):
        a = torch.from_numpy(np.asarray(case[name]))
        B, S = a.shape[0] // dp, a.shape[1] // sep
        return a[d * B:(d + 1) * B, s * S:(s + 1) * S].to(dev, dtype)
    q, k, v, g = (mine(n) for n in ("q", "k", "v", "g"))
    for t in (q, k, v):
        t.requires_grad_(True)
    fn = sdpa_ulysses if case["mode"] == "ulysses" else sdpa_ring
    collective.reset_stats()
    l0 = _flash_launches()
    out = fn(q, k, v, hcg, axis_name="sep", is_causal=case["causal"])
    (out.to(torch.float32) * g.to(torch.float32)).sum().backward()
    l1 = _flash_launches()
    got = {"out": _numpy(out), "dq": _numpy(q.grad), "dk": _numpy(k.grad),
           "dv": _numpy(v.grad), "rank": rank, "dp": d, "sep": s,
           "launches": {k_: l1[k_] - l0[k_] for k_ in l1},
           "collectives": collective.stats()}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, got)
    set_hybrid_communicate_group(None)
    if rank != 0:
        return None
    whole = {}
    for name in ("out", "dq", "dk", "dv"):
        rows = []
        for di in range(dp):
            rows.append(np.concatenate(
                [next(r[name] for r in ranks if r["dp"] == di
                      and r["sep"] == si) for si in range(sep)], axis=1))
        whole[name] = np.concatenate(rows, axis=0)
    whole["ranks"] = [{k_: r[k_] for k_ in ("rank", "dp", "sep", "launches",
                                            "collectives")} for r in ranks]
    return whole


def train_cases(rank: int, world: int, args: Dict):
    """Train (or run the sequence-parallel attention) through the cases
    of ``args`` on every rank.

    - ``device``: ``"cpu"`` or None (the card; ranks share ``cuda:0``);
    - ``backend``: the groups' backend;
    - ``models``: name -> ``{"family", "config", "state", "seed"}`` as for
      :func:`serve_cases`;
    - ``cases``: ``{"name", "model", "mesh": {"dp": n} (ZeRO, with
      ``"stage"`` and ``"bucket_mb"``) or {"fsdp", "tp", "dp"} (2-D) or
      None (rank 0 alone), "hybrid": {"dp", "sep"} (a hybrid group with
      the plain step), "config": overrides of the model's config,
      "optimizer": {"name", ...keyword arguments}, "clip", "steps",
      "warmup", "batches" or "random", "return_params", "return_state",
      "return_whole" (the trained parameters gathered whole, in the
      reference's layout), "grad_norms" (each step's gradients as the
      rank updates with them, :func:`_record_grads`), "resume": n,
      "bad_batch"}``; or ``{"name", "kind": "attention",
      "mode": "ring"|"ulysses", "sep", "dp", "causal", "dtype", "q", "k",
      "v", "g"}``; or a ``"kind": "checkpoint"``, ``"pipeline"``,
      ``"outside"``, ``"redistribute"``, ``"spmd_pipeline"`` or
      ``"state_dict"`` case
      (:mod:`.resilience`).

    Each case's result carries its seconds on rank 0 (``case_s``: set-up,
    run and teardown).  A training case returns, from rank 0, its losses
    (the warm-up's first) and every rank's wall, launches, collective stats, parameter
    and optimizer-state bytes and shapes, peak device memory and metric
    deltas (with ``return_params`` / ``return_state`` its parameters and
    state, numpy)."""
    device = args.get("device")
    backend = args.get("backend", "gloo")
    if device is None:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = []
    for case in args["cases"]:
        t0 = time.perf_counter()
        if case.get("kind") == "attention":
            res = _attention_case(rank, case, device, backend)
        elif case.get("kind") in ("checkpoint", "pipeline", "outside"):
            from . import resilience
            fn = getattr(resilience, case["kind"] + "_case")
            res = fn(rank, case, args["models"][case["model"]], device,
                     backend)
        elif case.get("kind") in ("redistribute", "spmd_pipeline",
                                  "state_dict"):
            from . import resilience
            fn = getattr(resilience, case["kind"] + "_case")
            res = fn(rank, case, device, backend)
        else:
            spec = args["models"][case["model"]]
            case = dict(case, family=spec["family"],
                        cfg=dict(spec["config"], **case.get("config", {})),
                        device=device)
            res = _train_case(rank, case, spec, device, backend)
            if not case.get("mesh") and not case.get("hybrid"):
                dist.barrier()
        if rank == 0 and isinstance(res, dict):
            res["case_s"] = time.perf_counter() - t0
        out.append(res if rank == 0 else None)
    return out
