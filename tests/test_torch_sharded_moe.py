"""Mixtral trained over ranks in the port against the JAX reference, on
the CPU.

The port's ranks run as one four-rank gloo world started once for this
module (``paddle_tpu_torch.distributed.launch.run_world`` over
``paddle_tpu_torch.testing.sharded.train_cases``); each rank builds the
reference's seeded weights and trains a tiny Mixtral (E 4, k 2; capacity
factor 1.0, which drops, and 2.0, which does not) on the global batch.
Under ZeRO-1/2 over dp 2 and fsdp 2 x tp 2 each replica routes its own
rows, as the reference's shard_map replicas do: the gates are its sharded
steps.  Under shard_mixtral at ep 2 and sharding 2 x ep 2 and ring /
Ulysses over dp 2 x sep 2 the whole batch routes as one set, as in the
reference's GSPMD-global steps: the gate is its one-device step.  Planted
per-rank routing faults must fail those gates.  The reference's steps run
here, on the conftest's 8-device CPU mesh, while the world trains.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.process_mesh import ProcessMesh as RefMesh
from paddle_tpu.jit.train_step import ShardingConfig as RefSharding
from paddle_tpu.jit.train_step import TrainStep as RefTrainStep
from paddle_tpu.models.mixtral import MixtralForCausalLM as RefMixtral
from paddle_tpu.models.mixtral import \
    MixtralPretrainingCriterion as RefMixtralCriterion
from paddle_tpu.models.mixtral import \
    mixtral_tiny_config as ref_mixtral_config
from paddle_tpu.testing.dryrun import cpu_mesh_2d

from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.models import (MixtralConfig, MixtralForCausalLM,
                                     MixtralPretrainingCriterion)
from paddle_tpu_torch.testing.parity import load_paddle_tpu_weights
from paddle_tpu_torch.testing.sharded import grad_norms
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

TOL = 1e-5
OPT = dict(name="adamw", learning_rate=1e-3)


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _cfg_dict(ref, cls):
    return {f: getattr(ref.config, f) for f in cls.__dataclass_fields__
            if hasattr(ref.config, f)}


MIX_KW = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=128, intermediate_size=64,
              num_local_experts=4, num_experts_per_tok=2)
# E 4, k 2: an expert takes int(f * N * k / E) = f N / 2 assignments of a
# forward's N tokens: factor 1.0 drops, 2.0 (= E / k) never does
CAPACITY = {"drop": 1.0, "nodrop": 2.0}
MIX_STEPS = 3
# the reference's ZeRO and 2-D steps run a shard_map replica a shard, so
# each routes its replica's rows (the degree: the replicas)
REPLICA = {"z1": 2, "z2": 2, "f2t2": 4}
# sep, hybrid data parallelism and shard_mixtral run on GSPMD-global
# arrays there: they route the whole batch, its one-device step's math
GLOBAL = ("ep2", "s2ep2", "ring", "ulysses")
MIX_PLACES = {
    "z1": dict(mesh={"dp": 2}, stage=1), "z2": dict(mesh={"dp": 2}, stage=2),
    "f2t2": dict(mesh={"fsdp": 2, "tp": 2}),
    "ep2": dict(mesh={"ep": 2}), "s2ep2": dict(mesh={"ep": 2, "sharding": 2}),
    "ring": dict(hybrid={"dp": 2, "sep": 2},
                 config=dict(sequence_parallel=True)),
    "ulysses": dict(hybrid={"dp": 2, "sep": 2},
                    config=dict(sequence_parallel=True,
                                seq_parallel_mode="ulysses")),
}
# the aux share's scale (ops.moe_gate.RoutingGroup): the step's divisor
AUX_SCALE = {"ep2": 2, "s2ep2": 4, "ring": 2, "ulysses": 2}
GLOBAL_REL = 1e-4
PLANTS = {"rank_aux": "ep2", "rank_capacity": "ring"}


def _mix_batches():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, 128, (4, 16)).astype(np.int64),
             rng.randint(0, 128, (4, 16)).astype(np.int64))
            for _ in range(2)]


def _ref_mixtral(factor):
    paddle.seed(0)
    return RefMixtral(ref_mixtral_config(expert_capacity_factor=factor,
                                         **MIX_KW))


def _ref_mixtral_losses(factor, **kw):
    model = _ref_mixtral(factor)
    crit = RefMixtralCriterion(model)
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    step = RefTrainStep(model, lambda lg, lb: crit(lg, lb), opt,
                        clip_norm=1.0, **kw)
    out = []
    for i in range(MIX_STEPS):
        ids, labels = _mix_batches()[i % 2]
        out.append(float(np.asarray(step(
            paddle.to_tensor(ids.astype(np.int32)),
            paddle.to_tensor(labels))._value)))
    return out


def _ref_mixtral_first_step(factor):
    """The reference's one-device loss function on the first batch at the
    initial weights (``TrainStep._make_loss_fn``, jitted once): each
    parameter's gradient norm, the aux term, the MoE block's input (a
    row's layer-0 input is its own: attention stays in the row) and from
    it the drops of the whole batch and of each replica's rows."""
    import jax
    from paddle_tpu.ops import moe_gate as ref_mg
    from paddle_tpu.ops import random as ref_random
    model = _ref_mixtral(factor)
    crit = RefMixtralCriterion(model)
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    step = RefTrainStep(model, lambda lg, lb: crit(lg, lb), opt)
    ids, labels = _mix_batches()[0]
    _sd, params, frozen, batch = step._gather_inputs(
        (paddle.to_tensor(ids.astype(np.int32)), paddle.to_tensor(labels)))
    blk = model.mixtral.layers[0].block_sparse_moe
    seen = []
    inner = blk.forward

    def record(x):
        seen.append(x._value)
        return inner(x)
    blk.forward = record

    # drawn outside the trace: a key drawn inside ``fn`` would leave a
    # tracer in the reference's global generator, and every later draw
    # from it in this process would fail
    key = ref_random.next_key()

    def fn(p):
        seen.clear()
        loss, _ = step._make_loss_fn(frozen, batch, key)(p)
        return loss, (seen[0], getattr(blk.l_aux, "_value", blk.l_aux))
    (loss, (x, aux)), grads = jax.jit(jax.value_and_grad(
        fn, has_aux=True))(params)
    flat = np.asarray(x).reshape(-1, MIX_KW["hidden_size"])
    gate = np.asarray(model.mixtral.layers[0].block_sparse_moe.gate
                      .weight._value)
    E, k = MIX_KW["num_local_experts"], MIX_KW["num_experts_per_tok"]

    def drops(rows):
        _w, top_i, _p = ref_mg.topk_gate(
            (rows.astype(np.float32) @ gate.astype(np.float32)), k)
        slot, _oh = ref_mg.assignment_slots(top_i, E)
        cap = max(1, int(factor * rows.shape[0] * k / E))
        return int((np.asarray(slot) >= cap).sum())
    out = {"loss": float(loss), "aux": float(aux),
           "norms": {n: float(np.sqrt((np.asarray(g, np.float64) ** 2)
                                      .sum())) for n, g in grads.items()},
           "dropped": drops(flat)}
    for parts in (2, 4):
        out["dropped_%d" % parts] = sum(
            drops(c) for c in np.split(flat, parts))
    return out


def _port_replica_norms(path, factor, parts):
    """The gradient a replica step updates with: the mean over ``parts``
    row slices of the first batch of each slice's own loss gradient (its
    own routing), from the port's one-device model on the reference's
    weights; each parameter's norm."""
    cfg = MixtralConfig(expert_capacity_factor=factor, **MIX_KW)
    model = MixtralForCausalLM(cfg, device="cpu")
    with np.load(path) as z:
        load_paddle_tpu_weights(model, {k: z[k] for k in z.files})
    crit = MixtralPretrainingCriterion(model)
    ids, labels = (torch.from_numpy(a) for a in _mix_batches()[0])
    for i, l in zip(ids.chunk(parts), labels.chunk(parts)):
        (crit(model(i), l) / parts).backward()
    return {n: float(p.grad.double().norm())
            for n, p in model.named_parameters()}


def _mix_shapes():
    return {k: tuple(p.shape) for k, p in MixtralForCausalLM(
        MixtralConfig(**MIX_KW), device="meta").named_parameters()}


def _mix_cases():
    """The Mixtral cases of the world: the one-device step and every
    placement at both capacity factors, the planted faults, the
    shard_mixtral forward check."""
    common = dict(model="mx", optimizer=OPT, clip=1.0, steps=MIX_STEPS,
                  batches=_mix_batches(), grad_norms=True)
    cases = []
    for tag, factor in CAPACITY.items():
        over = dict(expert_capacity_factor=factor)
        cases.append(dict(name="mx_one_" + tag, mesh=None, config=over,
                          **common))
        for place, kw in MIX_PLACES.items():
            kw = dict(kw)
            kw["config"] = dict(kw.get("config", {}), **over)
            cases.append(dict(name="mx_%s_%s" % (place, tag),
                              forward_check=place == "s2ep2", **kw,
                              **common))
    for plant, place in PLANTS.items():
        kw = dict(MIX_PLACES[place])
        kw["config"] = dict(kw.get("config", {}),
                            expert_capacity_factor=CAPACITY["drop"])
        cases.append(dict(name="mx_plant_" + plant, plant=plant, **kw,
                          **common))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ref = _ref_mixtral(CAPACITY["drop"])
    path = str(tmp_path_factory.mktemp("moe_world") / "mx.npz")
    np.savez(path, **{k: _np(v) for k, v in ref.state_dict().items()})
    models = {"mx": dict(family="mixtral",
                         config=_cfg_dict(ref, MixtralConfig), state=path)}
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                      "train_cases", 4, dict(device="cpu", backend="gloo",
                                             models=models,
                                             cases=_mix_cases()),
                      timeout=300, env={"OMP_NUM_THREADS": "1"})
    oracle = {}
    for tag, factor in CAPACITY.items():
        oracle["mx_one_" + tag] = _ref_mixtral_losses(factor)
        oracle["mx_z2_" + tag] = _ref_mixtral_losses(
            factor, mesh=RefMesh(shape=[2], dim_names=["dp"]),
            sharding=RefSharding(stage=2))
        oracle["mx_f2t2_" + tag] = _ref_mixtral_losses(
            factor, mesh=cpu_mesh_2d(2, 2), sharding=RefSharding(axis="fsdp"))
        oracle["mx_first_" + tag] = _ref_mixtral_first_step(factor)
        for parts in (2, 4):
            oracle["mx_replica%d_%s" % (parts, tag)] = _port_replica_norms(
                path, factor, parts)
    out = {c["name"]: r for c, r in zip(_mix_cases(), fut.result())}
    pool.shutdown()
    return out, oracle


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    diff = max(abs(a - b) for a, b in zip(got, want))
    assert diff <= tol, (got, want, diff)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def _first_norms(r):
    return grad_norms(r["ranks"], _mix_shapes())[0]


@pytest.mark.parametrize("tag", sorted(CAPACITY))
def test_mixtral_one_device_step_matches_the_reference(world, tag):
    """The one-device Mixtral step: losses within 1e-5 of the reference's
    over 3 steps; at the first step every parameter's gradient norm
    before the clip within 1e-5 relative, the aux term, and the dropped
    assignments equal (none at factor 2)."""
    out, ora = world
    r, first = out["mx_one_" + tag], ora["mx_first_" + tag]
    _close(r["losses"], ora["mx_one_" + tag])
    norms = _first_norms(r)
    assert sorted(norms) == sorted(first["norms"])
    for k, w in first["norms"].items():
        assert _rel(norms[k], w) <= TOL, (k, norms[k], w)
    dropped, aux = r["ranks"][0]["moe"][0][0]
    assert dropped == first["dropped"]
    assert (dropped > 0) == (tag == "drop")
    assert aux > 0 and _rel(aux, first["aux"]) <= TOL


@pytest.mark.parametrize("tag", sorted(CAPACITY))
@pytest.mark.parametrize("place", sorted(REPLICA))
def test_mixtral_zero_and_2d_route_each_replica(world, place, tag):
    """ZeRO-1/2 over dp 2 and fsdp 2 x tp 2 route each replica's rows
    alone, as the reference's shard_map replicas do: losses within 1e-5
    of the reference's sharded step (stage 1 and 2 against its stage 2:
    the same math), the first step's gradient norms within 1e-5 relative
    of the mean of the replicas' own gradients, and the replicas' drops
    those of the reference's block input cut into the replicas' rows."""
    out, ora = world
    r = out["mx_%s_%s" % (place, tag)]
    parts = REPLICA[place]
    want = ora["mx_%s_%s" % ("f2t2" if place == "f2t2" else "z2", tag)]
    _close(r["losses"], want)
    norms = _first_norms(r)
    for k, w in ora["mx_replica%d_%s" % (parts, tag)].items():
        assert _rel(norms[k], w) <= TOL, (place, k, norms[k], w)
    assert len(r["ranks"]) == parts
    # each rank runs one replica: its own drops
    assert sum(rk["moe"][0][0][0] for rk in r["ranks"]) \
        == ora["mx_first_" + tag]["dropped_%d" % parts]
    # replica routing is not the one-device step's
    assert max(_rel(a, b) for a, b in zip(
        r["losses"], out["mx_one_" + tag]["losses"])) > TOL


@pytest.mark.parametrize("tag", sorted(CAPACITY))
@pytest.mark.parametrize("place", GLOBAL)
def test_mixtral_over_ranks_routes_the_whole_batch(world, place, tag):
    """shard_mixtral at ep 2 and sharding 2 x ep 2, and ring and Ulysses
    over dp 2 x sep 2, route the whole batch as one set (the global
    capacity, slot order and aux term over every rank's tokens): losses
    within 1e-4 relative of the reference's one-device step and every
    gradient norm before the clip at the first step too, every step's
    norms within 1e-5 relative of the port's one-device step, the dropped
    count the reference's, and the ranks' aux shares summing (over the
    step's divisor) to its aux term."""
    out, ora = world
    r, one = out["mx_%s_%s" % (place, tag)], out["mx_one_" + tag]
    first = ora["mx_first_" + tag]
    for got, want in zip(r["losses"], ora["mx_one_" + tag]):
        assert _rel(got, want) <= GLOBAL_REL, (got, want)
    got_norms = grad_norms(r["ranks"], _mix_shapes())
    for k, w in first["norms"].items():
        assert _rel(got_norms[0][k], w) <= GLOBAL_REL, (k, w)
    for g, w in zip(got_norms, grad_norms(one["ranks"], _mix_shapes())):
        for k in w:
            assert _rel(g[k], w[k]) <= TOL, (place, k, g[k], w[k])
    for rk in r["ranks"]:
        assert rk["moe"][0][0][0] == first["dropped"]
    aux = sum(rk["moe"][0][0][1] for rk in r["ranks"]) / AUX_SCALE[place]
    assert aux > 0 and _rel(aux, first["aux"]) <= GLOBAL_REL


def test_shard_mixtral_bytes_payload_and_forward(world):
    """A rank of shard_mixtral stores 1/ep of the expert banks (1/4 under
    sharding 2 x ep 2), the dispatch all_to_all's payload is its analytic
    count (four calls a layer and step, forward and backward, each of the
    send buffer ``[E, min(C, N_local), D]``), and the sharded forward
    gives the whole batch's logits within 3e-4 of the unsharded model
    (the reference's own gate)."""
    out, _ = world
    whole = out["mx_one_drop"]["ranks"][0]["expert_bytes"]
    E, D = MIX_KW["num_local_experts"], MIX_KW["hidden_size"]
    k, L = MIX_KW["num_experts_per_tok"], MIX_KW["num_hidden_layers"]
    for tag, factor in CAPACITY.items():
        for place, ranks in (("ep2", 2), ("s2ep2", 4)):
            r = out["mx_%s_%s" % (place, tag)]
            n_local = 4 * 16 // ranks
            cap = max(1, int(factor * 4 * 16 * k / E))
            for rk in r["ranks"]:
                assert rk["expert_bytes"] * ranks == whole
                calls = rk["collectives"]["calls"]["moe_all_to_all"]
                assert calls == 4 * L * MIX_STEPS
                assert rk["collectives"]["bytes"]["moe_all_to_all"] \
                    == calls * E * min(cap, n_local) * D * 4
    for tag in CAPACITY:
        for rk in out["mx_s2ep2_" + tag]["ranks"]:
            assert rk["forward_diff"] <= 3e-4


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_planted_per_rank_routing_is_rejected(world, plant):
    """A per-rank aux term (each rank's own f_e and P_e) or a per-rank
    capacity, planted into the routing over ranks: the gates above
    reject it (the losses or a gradient norm leave their 1e-4)."""
    out, ora = world
    r = out["mx_plant_" + plant]
    first = ora["mx_first_drop"]
    loss_off = max(_rel(a, b) for a, b in zip(r["losses"],
                                              ora["mx_one_drop"]))
    norms = _first_norms(r)
    norm_off = max(_rel(norms[k], w) for k, w in first["norms"].items())
    assert max(loss_off, norm_off) > 10 * GLOBAL_REL, (loss_off, norm_off)
