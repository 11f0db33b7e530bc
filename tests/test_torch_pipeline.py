"""Pipeline parallelism in the port against the JAX reference, on the CPU:
``paddle_tpu_torch.distributed.pipelining`` (host-driven GPipe over a
``pipe`` axis of ``torch.distributed`` ranks, point-to-point sends between
stage ranks) and ``paddle_tpu_torch.models.llama_pipeline.
LlamaPipelineTrainStep``.

The reference's ``tests/test_pipeline.py`` gates, retargeted:
``spmd_pipeline`` against the serial stages (:147; loss rtol 1e-5, grads
atol 1e-4, here over four stage ranks, with and without remat), and the
Llama pipeline step (:188) at pp2 x tp2 and pp2 x dp2 against the
reference's ``LlamaPipelineTrainStep`` at the same mesh shape and weights
(first loss rtol 1e-4, then two more steps within 1e-5), with ``-100``
labels in one micro-batch only (the loss averages over every valid token
of the whole batch), plus each parameter's gradient norm before the clip
against the port's one-card ``TrainStep`` on the same weights, untied and
tied (the embedding's gradient is the lookup's plus the head's).
dp2 x pp2 x tp2 (eight ranks) runs in the slow lane.  One four-rank gloo
world (``testing.sharded.train_cases``) holds the tier-1 cases.
"""
from dataclasses import asdict

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed import pipelining as ref_pipe
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_llama_config
from paddle_tpu.models.llama_pipeline import \
    LlamaPipelineTrainStep as RefPipelineStep

from paddle_tpu_torch.distributed import pipelining
from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.testing.sharded import grad_norms
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

STEPS = 3
TOL = 1e-5
GRAD_RTOL = 1e-4
OPT = dict(name="adamw", learning_rate=1e-3)
LLAMA_KW = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, intermediate_size=176,
                vocab_size=512)
MESHES = {"pp2tp2": {"pipe": 2, "model": 2},
          "pp2dp2": {"data": 2, "pipe": 2}}
D, M = 16, 8              # spmd_pipeline: width, micro-batches


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _batch(b=8):
    """ids and labels, with -100 in one micro-batch's labels only."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (b, 32)).astype(np.int64)
    labels = ids.copy()
    labels[1, 3:20] = -100
    return ids, labels


def _ref_losses(mesh_shape, batch):
    paddle.seed(0)
    model = RefLlama(ref_llama_config(**LLAMA_KW))
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    names = ("data", "pipe", "sharding", "model")
    devs = np.array(jax.devices()[:int(np.prod(mesh_shape))])
    mesh = Mesh(devs.reshape(mesh_shape), names)
    step = RefPipelineStep(model, opt, mesh, n_microbatches=4,
                           clip_norm=1.0)
    ids, labels = batch
    return [float(np.asarray(step(paddle.to_tensor(ids.astype(np.int32)),
                                  paddle.to_tensor(labels))._value))
            for _ in range(STEPS)]


def _stages(rng):
    return [{"w": rng.randn(D, D).astype(np.float32) * 0.3,
             "b": rng.randn(D).astype(np.float32) * 0.1} for _ in range(4)]


def _models(tmp):
    paddle.seed(0)
    ref = RefLlama(ref_llama_config(**LLAMA_KW))
    path = str(tmp / "m.npz")
    np.savez(path, **{k: _np(v) for k, v in ref.state_dict().items()})
    cfg = {f: getattr(ref.config, f) for f in LlamaConfig.__dataclass_fields__
           if hasattr(ref.config, f)}
    tied = asdict(llama_tiny_config(tie_word_embeddings=True, **LLAMA_KW))
    return {"m": dict(family="llama", config=cfg, state=path),
            "tied": dict(family="llama", config=tied, seed=3)}


def _pipe_cases(batch, meshes):
    common = dict(optimizer=OPT, clip=1.0, steps=STEPS, grad_norms=True,
                  batches=[batch])
    cases = [dict(common, name="one", model="m", mesh=None)]
    for i, (name, mesh) in enumerate(meshes.items()):
        cases.append(dict(common, name=name, kind="pipeline", model="m",
                          mesh=mesh, micro=4, remat=i % 2 == 0))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_world")
    rng = np.random.RandomState(0)
    stages = _stages(rng)
    xs = rng.randn(M, 4, D).astype(np.float32)
    batch = _batch()
    common = dict(optimizer=OPT, clip=1.0, steps=STEPS, grad_norms=True,
                  batches=[batch])
    cases = _pipe_cases(batch, MESHES) + [
        dict(common, name="one_tied", model="tied", mesh=None),
        dict(common, name="pp2_tied", kind="pipeline", model="tied",
             mesh={"data": 2, "pipe": 2}, micro=2, remat=True),
        dict(name="spmd", kind="spmd_pipeline", stages=stages, xs=xs),
        dict(name="spmd_remat", kind="spmd_pipeline", stages=stages, xs=xs,
             remat=True),
        dict(name="outside", kind="outside", model="m", optimizer=OPT,
             meshes={"pp2": {"pipe": 2}, "dp2": {"dp": 2}}),
    ]
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                      "train_cases", 4, dict(device="cpu", backend="gloo",
                                             models=_models(tmp),
                                             cases=cases),
                      timeout=300, env={"OMP_NUM_THREADS": "1"})
    oracle = {name: _ref_losses((1, 2, 1, 2) if name == "pp2tp2"
                                else (2, 2, 1, 1), batch)
              for name in MESHES}
    out = {c["name"]: r for c, r in zip(cases, fut.result())}
    pool.shutdown()
    return out, oracle, dict(stages=stages, xs=xs)


def _shapes(config):
    m = LlamaForCausalLM(LlamaConfig(**config), device="meta")
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


def test_spmd_pipeline_matches_the_serial_stages(world):
    """Four stage ranks, eight micro-batches, ``sum(y ** 2)``: the loss
    and every stage's gradients against the stages run one after the
    other (the reference's :147 tolerances)."""
    import torch
    out, _, data = world
    params = [{k: torch.from_numpy(v).requires_grad_()
               for k, v in s.items()} for s in data["stages"]]
    ys = torch.from_numpy(data["xs"])
    for p in params:
        ys = torch.tanh(ys @ p["w"] + p["b"])
    loss = (ys ** 2).sum()
    loss.backward()
    for name in ("spmd", "spmd_remat"):
        for rk in out[name]["ranks"]:
            np.testing.assert_allclose(rk["loss"], loss.item(), rtol=1e-5)
            for k, g in rk["grads"].items():
                np.testing.assert_allclose(
                    g, params[rk["rank"]][k].grad.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_llama_pipeline_step_matches_the_reference(world, name):
    out, oracle, _ = world
    got, want = out[name]["losses"], oracle[name]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert max(abs(a - b) for a, b in zip(got[1:], want[1:])) <= TOL, \
        (got, want)
    assert got[-1] < got[0]


@pytest.mark.parametrize("name,one", [("pp2tp2", "one"), ("pp2dp2", "one"),
                                      ("pp2_tied", "one_tied")])
def test_pipeline_gradient_norms_match_the_one_card_step(world, name, one):
    """Each parameter's gradient norm before the clip, at every step,
    against the port's one-card ``TrainStep`` on the same weights: a
    stage's layers come from its ranks only, the embedding, final norm
    and head from every rank."""
    out, _, _ = world
    shapes = _shapes(_CONFIGS["tied" if "tied" in name else "m"])
    got = grad_norms(out[name]["ranks"], shapes)
    want = grad_norms(out[one]["ranks"], shapes)
    assert len(got) == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        rel = max(abs(g[k] - w[k]) / w[k] for k in w)
        assert rel <= GRAD_RTOL, rel
    np.testing.assert_allclose(out[name]["losses"], out[one]["losses"],
                               rtol=1e-5)


def test_pipeline_stage_ranks_hold_their_layers_and_send_activations(world):
    """pp2 x tp2: a stage's ranks store only its layer's slices (tp split
    on the projections), and each boundary carries the micro-batches'
    activations forward and their cotangents back, once each."""
    out, _, _ = world
    ranks = out["pp2tp2"]["ranks"]
    assert [rk["stage"] for rk in ranks] == [0, 0, 1, 1]
    for rk in ranks:
        layers = {k.split(".")[2] for k in rk["specs"]
                  if k.startswith("llama.layers.")}
        assert layers == {str(rk["stage"])}
        q = "llama.layers.%d.self_attn.q_proj.weight" % rk["stage"]
        assert rk["specs"][q] == ("model",)
        assert rk["specs"]["llama.embed_tokens.weight"] == ("model",)
        act = 4 * 1 * 32 * 64 * 4 * STEPS      # M x mb x S x h x fp32
        b = rk["collectives"]["bytes"]
        if rk["stage"] == 0:
            assert b["pipe_fwd"] == act and "pipe_bwd" not in b
        else:
            assert b["pipe_bwd"] == act and "pipe_fwd" not in b


def test_a_rank_outside_a_smaller_mesh_refuses_a_step(world):
    """A pipe-2 and a dp-2 step in a four-rank world: ranks 0-1 build
    them, ranks 2-3 raise (rather than run stage 0's layers alone)."""
    out, _, _ = world
    for rk in out["outside"]["ranks"]:
        for name, err in rk["errors"].items():
            if rk["rank"] < 2:
                assert err is None, (name, err)
            else:
                assert "holds 2 ranks but the world has 4" in err, err


def test_stage_helpers_match_the_reference():
    import torch
    for args in ((0, 8, 2), (3, 8, 2), (4, 8, 2), (7, 8, 4, 2), (5, 8, 2, 2)):
        assert pipelining.stage_index_of(*args) == \
            ref_pipe.stage_index_of(*args)
    st = pipelining.stack_stage_params(
        [{"w": torch.full((2,), float(i))} for i in range(3)])
    assert st["w"].shape == (3, 2) and float(st["w"][2, 0]) == 2.0


_CONFIGS = {"m": asdict(llama_tiny_config(**LLAMA_KW)),
            "tied": asdict(llama_tiny_config(tie_word_embeddings=True,
                                             **LLAMA_KW))}


@pytest.mark.slow
def test_dp2_pp2_tp2_on_eight_ranks(tmp_path):
    batch = _batch(16)
    meshes = {"dp2pp2tp2": {"data": 2, "pipe": 2, "model": 2}}
    cases = _pipe_cases(batch, meshes)
    out = run_world("paddle_tpu_torch.testing.sharded:train_cases", 8,
                    dict(device="cpu", backend="gloo",
                         models=_models(tmp_path), cases=cases),
                    timeout=600, env={"OMP_NUM_THREADS": "1"})
    got = out[1]["losses"]
    want = _ref_losses((2, 2, 1, 2), batch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert max(abs(a - b) for a, b in zip(got[1:], want[1:])) <= TOL
    shapes = _shapes(_CONFIGS["m"])
    for g, w in zip(grad_norms(out[1]["ranks"], shapes),
                    grad_norms(out[0]["ranks"], shapes)):
        assert max(abs(g[k] - w[k]) / w[k] for k in w) <= GRAD_RTOL
