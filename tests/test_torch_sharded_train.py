"""ZeRO-1/2 data-parallel and 2-D fsdp x tp training in the port against
the JAX reference, on the CPU.

The port's ranks run as one four-rank gloo world started once for this
module (``paddle_tpu_torch.distributed.launch.run_world`` over
``paddle_tpu_torch.testing.sharded.train_cases``); each rank builds the
reference's seeded weights (``state_from_paddle_tpu``) and trains through
``TrainStep(mesh=..., sharding=...)`` on the global batch.  The
reference's sharded steps run here, on the conftest's 8-device CPU mesh.
The gates are ``tests/test_sharded_update.py``'s and
``tests/test_spmd2d.py``'s: losses step for step within 1e-5 (ZeRO over 10
steps, 2-D over 6), optimizer state 1/dp rows for the shardable
parameters and whole for the others, one reduce-scatter a bucket a step
in stage 2 and none in stage 1, the 2-D ranks' stored shards the slices
of the reference's trained parameters, param + optimizer bytes a rank
against the replicated step, the ``train_fsdp_degree`` gauge and the
``train_params`` gather bytes equal to the reference's, the optimizer
state round trip through ``opt_state_arrays``, and the errors.

The same world runs the reference's three group_sharded_parallel marker
tests, the differentiable collectives and the 2-D train -> fsdp-serve
handoff.  Mixtral over ranks is ``tests/test_torch_sharded_moe.py``.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.process_mesh import ProcessMesh as RefMesh
from paddle_tpu.jit.train_step import ShardingConfig as RefSharding
from paddle_tpu.jit.train_step import TrainStep as RefTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as RefCriterion
from paddle_tpu.models.llama import llama_tiny_config as ref_llama_config
from paddle_tpu.models.qwen import Qwen2ForCausalLM as RefQwen2
from paddle_tpu.models.qwen import qwen2_tiny_config
from paddle_tpu.observability import default_registry as ref_registry
from paddle_tpu.testing.dryrun import cpu_mesh_2d

from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.distributed.process_mesh import ProcessMesh
from paddle_tpu_torch.jit import spmd
from paddle_tpu_torch.jit.train_step import ShardingConfig, TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     Qwen2Config)
from paddle_tpu_torch.models.llama import (LlamaPretrainingCriterion,
                                           llama_tiny_config)
from paddle_tpu_torch.optimizer import Adafactor, AdamW
from paddle_tpu_torch.testing.parity import (paddle_tpu_names,
                                             state_from_paddle_tpu)
from paddle_tpu_torch.testing.sharded import grad_norms
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

ZERO_STEPS = 10
TWO_D_STEPS = 6
TOL = 1e-5
OPT = dict(name="adamw", learning_rate=1e-3)
MESHES = {"f2t2": {"fsdp": 2, "tp": 2}, "f4": {"fsdp": 4, "tp": 1},
          "dp2f2": {"dp": 2, "fsdp": 2, "tp": 1}}
GATHER = "spmd_allgather_bytes_total{train_params}"


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _batches(vocab):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, vocab, (8, 16)).astype(np.int64),
             rng.randint(0, vocab, (8, 16)).astype(np.int64))
            for _ in range(3)]


LLAMA_KW = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, vocab_size=128, intermediate_size=128)
# head dim 18 and one kv head: k/v projections and biases of 18 rows,
# which a degree of 4 does not divide
QWEN_KW = dict(hidden_size=72, num_hidden_layers=1, num_attention_heads=4,
               num_key_value_heads=1, vocab_size=128, intermediate_size=128)


def _ref_model(family):
    paddle.seed(0)
    if family == "llama":
        return RefLlama(ref_llama_config(**LLAMA_KW))
    return RefQwen2(qwen2_tiny_config(**QWEN_KW))


def _ref_losses(family, n, **kw):
    model = _ref_model(family)
    crit = RefCriterion()
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    step = RefTrainStep(model, lambda lg, lb: crit(lg, lb), opt,
                        clip_norm=1.0, **kw)
    vocab = model.config.vocab_size
    batches = _batches(vocab)
    out = []
    for i in range(n):
        ids, labels = batches[i % len(batches)]
        loss = step(paddle.to_tensor(ids.astype(np.int32)),
                    paddle.to_tensor(labels))
        out.append(float(np.asarray(loss._value)))
    return step, model, out


def _ref_gather_bytes():
    c = ref_registry().get("spmd_allgather_bytes_total")
    return c.labels(site="train_params").value if c else 0.0


def _cfg_dict(ref, cls):
    return {f: getattr(ref.config, f) for f in cls.__dataclass_fields__
            if hasattr(ref.config, f)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_world")
    models = {}
    for name, family, cls in (("m", "llama", LlamaConfig),
                              ("q", "qwen2", Qwen2Config)):
        ref = _ref_model(family)
        path = str(tmp / ("%s.npz" % name))
        np.savez(path, **{k: _np(v) for k, v in ref.state_dict().items()})
        models[name] = dict(family=family, config=_cfg_dict(ref, cls),
                            state=path)
    llama_b, qwen_b = _batches(128), _batches(128)
    common = dict(optimizer=OPT, clip=1.0)
    cases = [
        dict(name="one", model="m", mesh=None, steps=ZERO_STEPS,
             batches=llama_b, grad_norms=True, **common),
        dict(name="z1", model="m", mesh={"dp": 4}, stage=1,
             steps=ZERO_STEPS, batches=llama_b, grad_norms=True, **common),
        dict(name="z2", model="m", mesh={"dp": 4}, stage=2,
             steps=ZERO_STEPS, batches=llama_b, resume=2, grad_norms=True,
             **common),
        dict(name="q_z2", model="q", mesh={"dp": 4}, stage=2,
             bucket_mb=0.02, steps=ZERO_STEPS, batches=qwen_b, **common),
        dict(name="z2_bad", model="m", mesh={"dp": 4}, stage=2,
             bad_batch=True, batches=llama_b, **common),
        dict(name="f2t2", model="m", mesh=MESHES["f2t2"],
             steps=TWO_D_STEPS, batches=llama_b, return_params=True,
             return_whole=True, resume=2, grad_norms=True, **common),
        dict(name="f4", model="m", mesh=MESHES["f4"], steps=TWO_D_STEPS,
             batches=llama_b, **common),
        dict(name="dp2f2", model="m", mesh=MESHES["dp2f2"],
             steps=TWO_D_STEPS, batches=llama_b, return_params=True,
             grad_norms=True, **common),
        dict(name="marker", kind="marker"),
        dict(name="collectives", kind="collectives"),
        dict(name="handoff", kind="handoff", model="m",
             mesh=MESHES["f2t2"], steps=3, batches=llama_b, **common,
             engine=dict(max_batch_size=4, num_blocks=64, block_size=4,
                         mixed_step=True, prefill_chunk_size=4),
             ops=[["add", [5, 7, 11], 6], ["add", [2, 3, 4, 5, 6], 6],
                  ["run"]]),
    ]
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                      "train_cases", 4, dict(device="cpu", backend="gloo",
                                             models=models, cases=cases),
                      timeout=300, env={"OMP_NUM_THREADS": "1"})
    oracle = {"one": _ref_losses("llama", ZERO_STEPS)[2]}
    for name, family, stage in (("z1", "llama", 1), ("z2", "llama", 2),
                                ("q_z2", "qwen2", 2)):
        oracle[name] = _ref_losses(
            family, ZERO_STEPS, mesh=RefMesh(shape=[4], dim_names=["dp"]),
            sharding=RefSharding(stage=stage))[2]
    for name, mesh in (("f2t2", cpu_mesh_2d(2, 2)), ("f4", cpu_mesh_2d(4, 1)),
                       ("dp2f2", cpu_mesh_2d(2, 1, replica=2))):
        b0 = _ref_gather_bytes()
        step, model, losses = _ref_losses("llama", TWO_D_STEPS, mesh=mesh,
                                          sharding=RefSharding(axis="fsdp"))
        oracle[name] = dict(
            losses=losses, bytes=_ref_gather_bytes() - b0,
            per_step=step._gather_bytes_per_step,
            gauge=ref_registry().get("train_fsdp_degree").value,
            params={k: _np(v) for k, v in model.state_dict().items()})
    out = {c["name"]: r for c, r in zip(cases, fut.result())}
    pool.shutdown()
    return out, oracle


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    diff = max(abs(a - b) for a, b in zip(got, want))
    assert diff <= tol, (got, want, diff)


def test_zero_stage_1_and_2_losses_match_the_reference(world):
    out, ora = world
    _close(out["one"]["losses"], ora["one"])
    for name in ("z1", "z2", "q_z2"):
        _close(out[name]["losses"], ora[name])
    # the sharded update is the replicated one
    _close(out["z2"]["losses"], out["one"]["losses"])


def test_zero_state_is_one_dp_th_of_the_shardable_rows(world):
    out, _ = world
    moment = "opt.llama.layers.0.self_attn.q_proj.weight.moment1"
    for name in ("z1", "z2"):
        for rk in out[name]["ranks"]:
            assert rk["state_shapes"][moment] == (16, 64)
            assert rk["shardable"]["llama.embed_tokens.weight"]
            assert rk["leaf_specs"][moment] == ("dp",)
            # a rank's moments are a quarter of the replicated step's
            assert rk["state_bytes"] * 4 <= out["one"]["ranks"][0][
                "state_bytes"] + 4 * 4 * 4 * len(rk["shardable"])
    for rk in out["q_z2"]["ranks"]:
        shapes = rk["state_shapes"]
        # 18 rows do not divide by 4: the k bias and weight stay whole
        assert shapes["opt.llama.layers.0.self_attn.k_proj.bias.moment1"] \
            == (18,)
        assert shapes["opt.llama.layers.0.self_attn.k_proj.weight.moment2"] \
            == (18, 72)
        assert not rk["shardable"]["llama.layers.0.self_attn.k_proj.bias"]
        assert shapes["opt.llama.layers.0.self_attn.q_proj.bias.moment1"] \
            == (18,)
        assert rk["shardable"]["llama.layers.0.self_attn.q_proj.bias"]


def test_stage_2_reduce_scatters_once_a_bucket_and_stage_1_never(world):
    out, _ = world
    for name, stage in (("z1", 1), ("z2", 2), ("q_z2", 2)):
        rk = out[name]["ranks"][0]
        calls = rk["collectives"]["calls"]
        buckets = rk["bucket_bytes"]
        if stage == 2:
            assert calls["reduce_scatter"] == len(buckets) * ZERO_STEPS
            assert rk["collectives"]["bytes"]["reduce_scatter"] \
                == sum(buckets) * ZERO_STEPS
        else:
            assert "reduce_scatter" not in calls
        # one all_gather of the updated rows a bucket
        assert calls["all_gather"] == len(buckets) * ZERO_STEPS
        assert rk["collectives"]["bytes"]["all_gather"] \
            == sum(buckets) // 4 * ZERO_STEPS
    # small buckets split the qwen grads; one bucket holds the llama's
    assert len(out["q_z2"]["ranks"][0]["bucket_bytes"]) > 1
    assert len(out["z2"]["ranks"][0]["bucket_bytes"]) == 1


def test_two_d_losses_match_the_reference_and_the_dp4_step(world):
    out, ora = world
    for name in MESHES:
        _close(out[name]["losses"], ora[name]["losses"])
        _close(out[name]["losses"], out["z2"]["losses"][:TWO_D_STEPS])


def test_two_d_ranks_store_the_slices_of_the_trained_reference(world):
    out, ora = world
    for name in ("f2t2", "dp2f2"):
        mesh = spmd.mesh_2d(MESHES[name]["fsdp"], MESHES[name]["tp"],
                            replica=MESHES[name].get("dp", 1))
        trained = state_from_paddle_tpu(ora[name]["params"])
        for rk in out[name]["ranks"]:
            coords = mesh.coords(rk["rank"])
            for k, got in rk["params"].items():
                want = spmd.shard_tensor(trained[k], spmd.P(*rk["specs"][k]),
                                         mesh, coords)
                np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                           atol=TOL, err_msg=k)
    # the ranks' slices gathered whole, in the reference's names and
    # layout, are its trained parameters
    whole = out["f2t2"]["whole"]
    assert sorted(whole) == sorted(ora["f2t2"]["params"])
    for k, want in ora["f2t2"]["params"].items():
        np.testing.assert_allclose(whole[k], want, rtol=0, atol=TOL,
                                   err_msg=k)
    specs = out["f2t2"]["ranks"][0]["specs"]
    assert specs["llama.layers.0.self_attn.q_proj.weight"] == ("tp", "fsdp")
    assert specs["llama.embed_tokens.weight"] == ("tp", "fsdp")
    assert specs["llama.norm.weight"] == ("fsdp",)


def test_gradient_norms_before_the_clip_match_the_one_device_step(world):
    """Each parameter's gradient as the ranks update with it, its norm
    before the clip put together from the ranks' slices
    (``testing.sharded.grad_norms``): ZeRO-1/2 and the 2-D placements
    against the one-device step, step by step; the losses alone would
    not see a gradient scaled wrong (the clip and Adam undo a scale)."""
    out, _ = world
    shapes = {k: tuple(p.shape) for k, p in LlamaForCausalLM(
        LlamaConfig(**_cfg_dict(_ref_model("llama"), LlamaConfig)),
        device="meta").named_parameters()}
    want = grad_norms(out["one"]["ranks"], shapes)
    assert len(want) == ZERO_STEPS and len(want[0]) == len(shapes)
    for name in ("z1", "z2", "f2t2", "dp2f2"):
        got = grad_norms(out[name]["ranks"], shapes)
        assert len(got) == (ZERO_STEPS if name[0] == "z" else TWO_D_STEPS)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert abs(g[k] - w[k]) <= TOL * w[k], (name, k, g[k], w[k])


def test_two_d_param_and_state_bytes_a_rank(world):
    out, _ = world
    one = out["one"]["ranks"][0]
    whole = one["param_bytes"] + one["state_bytes"]
    for name, limit in (("f2t2", 0.35), ("f4", 0.35), ("dp2f2", 0.55)):
        for rk in out[name]["ranks"]:
            ratio = (rk["param_bytes"] + rk["state_bytes"]) / whole
            assert ratio <= limit, (name, ratio)


def test_two_d_gauge_and_gather_bytes_equal_the_reference(world):
    out, ora = world
    for name in MESHES:
        for rk in out[name]["ranks"]:
            assert rk["gather_bytes_per_step"] == ora[name]["per_step"]
            assert rk["metrics"][GATHER] == ora[name]["bytes"] \
                == ora[name]["per_step"] * TWO_D_STEPS
            assert rk["metrics"]["train_fsdp_degree"] == ora[name]["gauge"] \
                == MESHES[name]["fsdp"]
            calls = rk["collectives"]["calls"]
            assert calls["train_gather"] > 0 and calls["reduce_scatter"] > 0


def test_opt_state_round_trip_continues_the_trajectory(world):
    """Every rank's state gathered whole, loaded into a fresh step of the
    same placement over the trained weights: the next losses equal the
    uninterrupted run's."""
    out, _ = world
    for name in ("z2", "f2t2"):
        r = out[name]["resumed"]
        np.testing.assert_allclose(r["loaded"], r["continued"], rtol=0,
                                   atol=TOL)


def test_non_divisible_batch_raises_the_reference_message(world):
    out, _ = world
    msg = out["z2_bad"]["error"]
    assert "batch dim0=7 is not divisible by the mesh degree 4" in msg


def _tiny():
    model = LlamaForCausalLM(llama_tiny_config(**LLAMA_KW), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("mesh", [ProcessMesh([4], ["dp"]),
                                  spmd.mesh_2d(2, 2)],
                         ids=["zero", "fsdp_tp"])
def test_adafactor_does_not_shard(mesh):
    model = _tiny()
    opt = Adafactor(1e-3, parameters=model.named_parameters())
    assert not opt.shardable_update and AdamW.shardable_update
    with pytest.raises(ValueError, match="not elementwise"):
        TrainStep(model, LlamaPretrainingCriterion(), opt, mesh=mesh,
                  sharding=ShardingConfig(stage=2))


def test_extra_mesh_axes_raise_and_degree_one_is_plain():
    model = _tiny()
    opt = AdamW(1e-3, parameters=model.named_parameters())
    with pytest.raises(NotImplementedError, match="pure data parallelism"):
        TrainStep(model, LlamaPretrainingCriterion(), opt,
                  mesh=ProcessMesh([2, 2], ["dp", "mp"]),
                  sharding=ShardingConfig(stage=1))
    step = TrainStep(model, LlamaPretrainingCriterion(), opt,
                     mesh=ProcessMesh([1], ["dp"]),
                     sharding=ShardingConfig(stage=2))
    ids = torch.from_numpy(_batches(128)[0][0])
    assert torch.isfinite(step(ids, ids)) and step._mode is None


def test_state_round_trip_names_map_to_the_reference_layout():
    arrays = {"lm_head.weight": np.zeros((128, 64)),
              "opt.llama.norm.weight.moment1": np.zeros(64),
              "opt.lm_head.weight.moment1": np.zeros((128, 64))}
    got = paddle_tpu_names(arrays)
    assert got["opt.lm_head.weight.moment1"].shape == (64, 128)
    assert got["lm_head.weight"].shape == (64, 128)
    assert got["opt.llama.norm.weight.moment1"].shape == (64,)


# ---------------------------------------------------------------------------
# the group_sharded_parallel marker
# ---------------------------------------------------------------------------
def test_group_sharded_levels_route_to_stages(world):
    """'os' and 'os_g' mark the optimizer with the hybrid group's mesh:
    a TrainStep built from it without a mesh runs ZeRO-1 / ZeRO-2 over
    the data axis (a rank's moments its quarter of the rows) and trains
    as the replicated step; 'p_g_os' marks nothing."""
    out, _ = world
    m = out["marker"]
    for level, stage in (("os", 1), ("os_g", 2)):
        r = m[level]
        assert r["marker"] and r["mode"] == "1d" and r["stage"] == stage
        assert r["axis"] == "data" and r["state_rows"] == (8, 8)
        _close(r["losses"], m["plain"])
    assert not m["p_g_os"]["marker"] and m["p_g_os"]["mode"] == "hybrid"


def test_implicit_marker_degrades_to_replicated(world):
    """Lamb (not elementwise) under a marker warns and builds the
    replicated step, which trains."""
    out, _ = world
    r = out["marker"]["lamb"]
    assert any("building the replicated TrainStep instead" in w
               and "not elementwise" in w for w in r["warnings"])
    assert r["mode"] == "hybrid" and np.isfinite(r["losses"]).all()


def test_sum_reduction_loss_parity(world):
    """loss_reduction='sum': the ranks' losses and gradients are summed,
    so a sum-reduced criterion under ZeRO-2 matches the plain step."""
    out, _ = world
    m = out["marker"]
    assert m["sum_sharded"]["mode"] == "1d"
    got, want = m["sum_sharded"]["losses"], m["sum_plain"]
    assert max(abs(a - b) / max(abs(a), 1.0) for a, b in zip(want, got)) \
        <= 1e-5
    assert want[0] > 100


def test_non_elementwise_optimizers_do_not_shard():
    """Lamb keeps ``shardable_update = False``, which the marker's degrade
    path relies on; the new elementwise rules shard."""
    from paddle_tpu_torch import optimizer as optim
    assert not optim.Lamb.shardable_update
    assert all(c.shardable_update for c in (
        optim.SGD, optim.Momentum, optim.Adagrad, optim.RMSProp,
        optim.Adadelta, optim.Adamax, optim.Rprop))


# ---------------------------------------------------------------------------
# the 2-D train -> fsdp-serve handoff
# ---------------------------------------------------------------------------
def test_train_to_serve_adopts_every_slice_and_matches_one_card(world):
    """An fsdp 2 x tp 2 engine built from the model a 2-D TrainStep
    trained adopts the step's stored slices: every parameter keeps its
    storage and data pointer, every fsdp-sharded slice is adopted with no
    copy, and the greedy tokens equal the one-card engine's on the
    gathered trained weights."""
    out, _ = world
    r = out["handoff"]
    assert len(r["ranks"]) == 4
    for rk in r["ranks"]:
        assert all(rk["same"].values()), rk["same"]
        assert rk["adopted"] == rk["fsdp_slices"] > 0
        assert rk["degrees"] == (2, 2)
    assert r["tokens"] == r["one_card"]
    assert all(len(t) > 0 for t in r["tokens"])
    assert np.isfinite(r["losses"]).all()


# ---------------------------------------------------------------------------
# the differentiable collectives and the group-sharded save
# ---------------------------------------------------------------------------
def test_differentiable_collectives_and_their_adjoints(world):
    """Over the 4 ranks: ``all_to_all_diff`` sends chunk g of rank r to
    rank g and moves the cotangent back by the same all_to_all;
    ``all_gather_diff`` stacks every rank's input and its adjoint is the
    reduce-scatter (rank r's block of the sum of every rank's weights);
    ``reduce_scatter_diff`` sums row r to rank r and its adjoint gathers
    each rank's cotangent row back."""
    ranks = world[0]["collectives"]
    n, c = len(ranks), 4
    x = [r + np.arange(n * c, dtype=np.float32) for r in range(n)]

    def w(r, size):
        return (r + 1) * (1 + np.arange(size, dtype=np.float32))
    for r, got in enumerate(ranks):
        y, g = got["all_to_all"]
        np.testing.assert_array_equal(y, np.concatenate(
            [x[s][r * c:(r + 1) * c] for s in range(n)]))
        # chunk s of rank r's input landed as chunk r of rank s's output
        np.testing.assert_array_equal(g, np.concatenate(
            [w(s, n * c)[r * c:(r + 1) * c] for s in range(n)]))
        y, g = got["all_gather"]
        np.testing.assert_array_equal(y, np.concatenate(x))
        size = n * n * c
        np.testing.assert_array_equal(g, sum(
            w(s, size) for s in range(n))[r * n * c:(r + 1) * n * c])
        y, g = got["reduce_scatter"]
        np.testing.assert_array_equal(y, sum(
            xs.reshape(n, c)[r] for xs in x))
        np.testing.assert_array_equal(g, np.concatenate(
            [w(s, c) for s in range(n)]))


def test_save_group_sharded_model_writes_model_and_optimizer(tmp_path):
    """``save_group_sharded_model`` (one process) writes the wrapped
    layer's state dict and the optimizer's, readable by pickle."""
    import pickle
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    model = _tiny()
    opt = AdamW(1e-3, parameters=model.named_parameters())
    wrapped, sopt, _ = group_sharded_parallel(model, opt, level="os_g")
    ids = torch.from_numpy(_batches(128)[0][0])
    step = TrainStep(wrapped, LlamaPretrainingCriterion(), sopt)
    assert step._mode is None and np.isfinite(step(ids, ids).item())
    save_group_sharded_model(wrapped, str(tmp_path), sopt)
    with open(tmp_path / "model.pdmodel", "rb") as f:
        sd = pickle.load(f)
    assert sorted(sd) == sorted(model.state_dict())
    assert torch.equal(sd["lm_head.weight"], model.lm_head.weight.detach())
    with open(tmp_path / "model.pdopt", "rb") as f:
        osd = pickle.load(f)
    assert osd["global_step"] == 1
    assert torch.equal(osd["lm_head.weight_moment1"],
                       opt.state("lm_head.weight")["moment1"])
