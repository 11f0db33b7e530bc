"""Ring and Ulysses sequence-parallel attention, and Llama training under
sep, in the port against the JAX reference, on the CPU.

The port's ranks run as one four-rank gloo world started once for this
module (``run_world`` over ``testing.sharded.train_cases``): each rank
holds its slice of the sequence (and of the batch under dp x sep) and
runs ``ops.sequence_parallel.sdpa_ring`` / ``sdpa_ulysses`` over a hybrid
group's sep axis, or trains a Llama with ``sequence_parallel=True``
through ``TrainStep`` (the gradients summed over the data x sep ranks).
The reference runs here on the conftest's 8-device CPU mesh: its
``ring_attention`` / ``ulysses_attention`` under ``shard_map`` over a sep
mesh (values within 1e-4, dq/dk/dv against ``jax.vjp`` within 2e-4) and
its sequence-parallel and serial ``TrainStep`` runs on ``tests/
test_attention.py``'s model and batch (losses within 2e-4 over 3 steps).  The ring's
hops are exact: a causal ring's rank ``r`` runs ``r + 1`` blocks and the
masked hops none; its shifts carry the packed k/v and dk/dv the bytes
``ring_bytes`` gives.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu.core.jax_compat import shard_map_compat
from paddle_tpu.distributed import topology as ref_topology
from paddle_tpu.distributed.process_mesh import as_jax_mesh
from paddle_tpu.jit.train_step import TrainStep as RefTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as RefCriterion
from paddle_tpu.models.llama import llama_tiny_config as ref_llama_config
from paddle_tpu.ops import pallas_kernels as pk

from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.ops.sequence_parallel import (ring_bytes, ring_hops,
                                                    ulysses_attention)
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

ATTN_TOL = 1e-4
GRAD_TOL = 2e-4
TRAIN_TOL = 2e-4
B, S, H, D = 2, 32, 4, 16
STEPS = 3
ATTN_CASES = {"ring_sep4": ("ring", 1, 4), "ulysses_sep4": ("ulysses", 1, 4),
              "ring_dp2sep2": ("ring", 2, 2),
              "ulysses_dp2sep2": ("ulysses", 2, 2)}
TRAIN_CASES = {"ring_sep4": ("ring", 1, 4), "ulysses_sep4": ("ulysses", 1, 4),
               "ring_dp2sep2": ("ring", 2, 2),
               "ulysses_dp2sep2": ("ulysses", 2, 2)}
MODEL_KW = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
                num_key_value_heads=2, vocab_size=128, intermediate_size=88)


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _qkvg():
    rng = np.random.RandomState(0)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _ref_attention(mode, dp, sep, causal, q, k, v, g):
    """The reference's ring / Ulysses body under ``shard_map`` over a
    dp x sep mesh (``sdpa_ring``'s own spec), and ``jax.vjp`` of it."""
    hcg = ref_topology.create_hybrid_group(dp=dp, sep=sep)
    jmesh = as_jax_mesh(hcg.mesh)
    spec = JP("data" if dp > 1 else None, "sep", None, None)
    inner = pk.ring_attention if mode == "ring" else pk.ulysses_attention
    fn = shard_map_compat(lambda a, b, c: inner(a, b, c, "sep", causal),
                          jmesh, in_specs=(spec,) * 3, out_specs=spec)

    @jax.jit
    def value_and_vjp(q_, k_, v_, g_):
        out, vjp = jax.vjp(fn, q_, k_, v_)
        return (out,) + tuple(vjp(g_))
    out, dq, dk, dv = value_and_vjp(*(jnp.asarray(t) for t in (q, k, v, g)))
    return dict(out=np.asarray(out), dq=np.asarray(dq), dk=np.asarray(dk),
                dv=np.asarray(dv), mesh=hcg.mesh)


def _train_batch():
    rs = np.random.RandomState(42)
    return (rs.randint(0, 128, (2, 32)).astype(np.int64),
            rs.randint(0, 128, (2, 32)).astype(np.int64))


def _ref_train(mode, dp, sep, clip=None):
    """The reference's ``TrainStep`` (AdamW, ``clip``) under a dp x sep
    hybrid group, on ``test_long_context_training_parity_under_sep``'s
    model and batch."""
    ref_topology.create_hybrid_group(dp=dp, sep=sep)
    cfg = ref_llama_config(sequence_parallel=sep > 1, seq_parallel_mode=mode,
                           **MODEL_KW)
    paddle.seed(0)
    m = RefLlama(cfg)
    crit = RefCriterion()
    opt = paddle.optimizer.AdamW(1e-3, parameters=m.parameters())
    ids, labels = _train_batch()
    ids, labels = paddle.to_tensor(ids.astype(np.int32)), \
        paddle.to_tensor(labels)
    step = RefTrainStep(m, lambda a, b: crit(a, b), opt, clip_norm=clip)
    return [float(_np(step(ids, labels)._value)) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    saved = ref_topology.get_hybrid_communicate_group()
    tmp = tmp_path_factory.mktemp("sep_world")
    paddle.seed(0)
    ref = RefLlama(ref_llama_config(**MODEL_KW))
    path = str(tmp / "m.npz")
    np.savez(path, **{k: _np(v) for k, v in ref.state_dict().items()})
    cfg = {f: getattr(ref.config, f) for f in LlamaConfig.__dataclass_fields__
           if hasattr(ref.config, f)}
    models = {"m": dict(family="llama", config=cfg, state=path)}
    q, k, v, g = _qkvg()
    cases = []
    for name, (mode, dp, sep) in ATTN_CASES.items():
        for causal in (True, False):
            cases.append(dict(name="%s_%s" % (name, causal), kind="attention",
                              mode=mode, dp=dp, sep=sep, causal=causal, q=q,
                              k=k, v=v, g=g))
    batch = [_train_batch()]
    opt = dict(name="adamw", learning_rate=1e-3)
    for name, (mode, dp, sep) in TRAIN_CASES.items():
        cases.append(dict(name="train_" + name, model="m",
                          hybrid={"dp": dp, "sep": sep}, optimizer=opt,
                          config=dict(sequence_parallel=True,
                                      seq_parallel_mode=mode),
                          steps=STEPS, batches=batch))
    # a model that is not sequence-parallel under a dp x sep group: the
    # sep ranks compute the same thing, the gradients sum over dp only
    cases.append(dict(name="train_dp2_not_sep", model="m",
                      hybrid={"dp": 2, "sep": 2}, optimizer=opt,
                      steps=STEPS, batches=batch))
    cases.append(dict(name="train_ring_sep4_clip", model="m",
                      hybrid={"sep": 4}, optimizer=opt, clip=1.0,
                      config=dict(sequence_parallel=True), steps=STEPS,
                      batches=batch, resume=1))
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                      "train_cases", 4, dict(device="cpu", backend="gloo",
                                             models=models, cases=cases),
                      timeout=300, env={"OMP_NUM_THREADS": "1"})
    oracle = {}
    try:
        for name, (mode, dp, sep) in ATTN_CASES.items():
            for causal in (True, False):
                oracle["%s_%s" % (name, causal)] = _ref_attention(
                    mode, dp, sep, causal, q, k, v, g)
        oracle["serial"] = _ref_train("ring", 1, 1)
        oracle["serial_clip"] = _ref_train("ring", 1, 1, clip=1.0)
        # the reference's public entry, once
        want = oracle["ring_sep4_True"]
        oracle["public_ring_sep4_True"] = _np(pk.sdpa_ring(
            paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
            want.pop("mesh"), axis_name="sep", is_causal=True))
        for name, (mode, dp, sep) in TRAIN_CASES.items():
            oracle["train_" + name] = _ref_train(mode, dp, sep)
    finally:
        ref_topology.set_hybrid_communicate_group(saved)
    out = {c["name"]: r for c, r in zip(cases, fut.result())}
    pool.shutdown()
    return out, oracle


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_attention_values_and_grads_match_the_reference(world, name,
                                                        causal):
    out, ora = world
    key = "%s_%s" % (name, causal)
    got, want = out[key], ora[key]
    if "public_" + key in ora:
        np.testing.assert_allclose(ora["public_" + key], want["out"], rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                               atol=ATTN_TOL)
    for grad in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[grad], want[grad], rtol=0,
                                   atol=GRAD_TOL, err_msg=grad)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_hops_and_shift_bytes_are_exact(world, causal):
    """A causal ring's rank r runs r + 1 blocks (the masked hops none); a
    full one n; every rank shifts the packed k/v n - 1 times a pass and
    the packed fp32 dk/dv n times in the backward."""
    out, _ = world
    n = 4
    for r in range(n):
        hops = ring_hops(r, n, causal)
        assert len(hops) == (r + 1 if causal else n)
        assert [h[1] for h in hops] == ([r - i for i in range(r + 1)]
                                        if causal else
                                        [(r - i) % n for i in range(n)])
    for rk in out["ring_sep4_%s" % causal]["ranks"]:
        calls = rk["collectives"]["calls"]
        assert calls["ring_kv"] == 2 * (n - 1) and calls["ring_dkv"] == n
        want = ring_bytes((B, S // n, H, D), 4, n, backward=True)
        fwd = ring_bytes((B, S // n, H, D), 4, n, backward=False)
        assert rk["collectives"]["bytes"]["ring_kv"] \
            == want["ring_kv"] + fwd["ring_kv"]
        assert rk["collectives"]["bytes"]["ring_dkv"] == want["ring_dkv"]
        # the CPU runs the plain versions: no kernel launch
        assert not any(rk["launches"].values())


def test_ulysses_all_to_alls_and_head_divisibility(world):
    out, _ = world
    for rk in out["ulysses_sep4_True"]["ranks"]:
        # q, k, v there and the output back; the gradients the reverse
        assert rk["collectives"]["calls"]["all_to_all"] == 8

    class Comm:
        size, index = 4, 0
    bad = np.zeros((2, 8, 6, 8), np.float32)
    import torch
    t = torch.from_numpy(bad)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(t, t, t, Comm())


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_llama_training_under_sep_matches_the_reference(world, name):
    out, ora = world
    got = out["train_" + name]["losses"]
    np.testing.assert_allclose(got, ora["train_" + name], rtol=0,
                               atol=TRAIN_TOL)
    np.testing.assert_allclose(got, ora["serial"], rtol=0, atol=TRAIN_TOL)


def test_data_parallel_under_a_hybrid_group_matches_the_serial_run(world):
    out, ora = world
    r = out["train_dp2_not_sep"]
    np.testing.assert_allclose(r["losses"], ora["serial"], rtol=0,
                               atol=TRAIN_TOL)
    for rk in r["ranks"]:
        # one flat sum of the gradients and one of the loss a step
        assert rk["collectives"]["calls"]["all_reduce"] == 2 * STEPS


def test_clipped_sep_training_matches_the_serial_train_step(world):
    """The gradients are summed over the sep ranks before the clip: the
    clipped ring run is the reference's serial clipped step, and its
    optimizer state round-trips through ``opt_state_arrays``."""
    out, ora = world
    r = out["train_ring_sep4_clip"]
    np.testing.assert_allclose(r["losses"], ora["serial_clip"], rtol=0,
                               atol=TRAIN_TOL)
    np.testing.assert_allclose(r["resumed"]["loaded"],
                               r["resumed"]["continued"], rtol=0, atol=1e-6)
