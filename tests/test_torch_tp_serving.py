"""Tensor-parallel serving in the port against the JAX reference, on the
CPU.

The port's ranks run as one two-rank gloo world (``paddle_tpu_torch.
distributed.launch.run_world`` over ``paddle_tpu_torch.testing.sharded.
serve_cases``), started once for this module; each rank builds its shard
of the reference's weights (``spmd.shard_model`` over
``testing.parity.state_from_paddle_tpu``) and serves every case below in
turn.  The reference's engines run here, in the test's own process, on
the conftest's 8-device CPU mesh.  The gates are the reference tests':
``tests/test_serving_tp.py`` (fp32 tokens byte-identical, per-rank pool
bytes exactly 1/tp, construction errors, tp = 1 degenerating, the prefix
cache's copy-on-write leak-free), ``tests/test_serving_sampling.py::
test_sampled_parity_split_vs_mixed_vs_tp`` and ``tests/
test_serving_quant.py::test_tp2_quant_collective_token_match`` (the int8
logits gather, match >= 0.6 with the reference's byte count).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu.core.jax_compat import shard_map_compat
from paddle_tpu.distributed.process_mesh import ProcessMesh as RefMesh
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.jit import spmd as ref_spmd
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.observability import default_registry as ref_registry

from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.distributed.process_mesh import ProcessMesh
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit import spmd
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.testing.parity import load_paddle_tpu_weights
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

PROMPTS = [[7, 9, 2], [3, 14, 15, 92, 65], list(range(1, 11))]
BUDGET = 4
STAGGER = [["add", PROMPTS[0], BUDGET], ["step"],
           ["add", PROMPTS[1], BUDGET], ["add", PROMPTS[2], BUDGET],
           ["run"]]
MIXED = dict(max_batch_size=4, num_blocks=64, block_size=4,
             mixed_step=True, prefill_chunk_size=4)
SPLIT = dict(max_batch_size=4, num_blocks=64, block_size=4,
             prefill_buckets=(4, 8, 16))
# tests/test_serving_tp.py's prefix-cache workload (the last request is a
# whole-prompt hit: copy-on-write of its last shared page)
P = [5, 17, 42, 7, 99, 3, 11, 23]
PREFIX = dict(max_batch_size=2, num_blocks=32, block_size=4,
              mixed_step=True, prefill_chunk_size=4,
              enable_prefix_cache=True)
PREFIX_OPS = [["add", P, 4], ["run"], ["add", P + [77, 8], 4],
              ["add", P, 4], ["run"]]
SAMPLED_P = [3, 14, 15, 92, 65]
SAMPLED_KW = dict(temperature=0.9, top_k=50, seed=13)
SAMPLED = dict(max_batch_size=2, num_blocks=32, block_size=4, sampling=True)


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _ref_model(**kw):
    paddle.seed(0)
    model = RefLlama(ref_tiny_config(**kw))
    model.eval()
    return model


def _cfg_dict(ref):
    c = ref.config
    return {f: getattr(c, f) for f in LlamaConfig.__dataclass_fields__
            if hasattr(c, f)}


def _port_whole(ref):
    port = LlamaForCausalLM(LlamaConfig(**_cfg_dict(ref)), device="cpu")
    load_paddle_tpu_weights(port, {k: _np(v)
                                   for k, v in ref.state_dict().items()})
    return port.eval()


def _quant_workload(vocab):
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, vocab, (n,)).astype(np.int64).tolist()
               for n in (5, 3, 8)]
    budgets = [6, 8, 5]
    ops = []
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        ops.append(["add", p, b])
        if i % 2 == 0:
            ops.append(["step"])
    return prompts, budgets, ops + [["run"]]


def _ref_serve(model, ops, **kw):
    eng = RefEngine(model, **kw)
    rids = []
    for op in ops:
        if op[0] == "add":
            rids.append(eng.add_request(np.asarray(op[1], np.int64), op[2],
                                        **(op[3] if len(op) > 3 else {})))
        elif op[0] == "step":
            eng.step()
        else:
            eng.run_to_completion()
    return eng, [eng.result(r) for r in rids]


def _ref_counters():
    r = ref_registry()
    c = r.get("serving_tp_collective_bytes_total")
    q = r.get("serving_quant_collective_bytes_total")
    return {"psum": c.labels(op="psum").value if c else 0.0,
            "all_gather": c.labels(op="all_gather").value if c else 0.0,
            "quant": q.labels(op="all_gather").value if q else 0.0}


def _match_rate(ref, got):
    tot = sum(len(a) for a in ref)
    hit = sum(x == y for a, b in zip(ref, got) for x, y in zip(a, b))
    return hit / max(1, tot)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference models and their oracles, and ONE two-rank world
    serving every port case."""
    tmp = tmp_path_factory.mktemp("tp_world")
    refs = {"a": _ref_model(num_hidden_layers=2, hidden_size=64,
                            num_attention_heads=4, num_key_value_heads=2,
                            vocab_size=128, intermediate_size=128),
            "s": _ref_model(num_key_value_heads=4)}
    models = {}
    for name, ref in refs.items():
        path = str(tmp / ("%s.npz" % name))
        np.savez(path, **{k: _np(v) for k, v in ref.state_dict().items()})
        models[name] = dict(family="llama", config=_cfg_dict(ref),
                            state=path)
    q_prompts, q_budgets, q_ops = _quant_workload(
        refs["s"].config.vocab_size)
    qkw = dict(max_batch_size=4, num_blocks=64, block_size=4,
               mixed_step=True, prefill_chunk_size=8)
    sampled_ops = [["add", SAMPLED_P, 7, SAMPLED_KW], ["run"]]
    rng = np.random.RandomState(3)
    helpers = dict(table=rng.randn(16, 8).astype(np.float32),
                   tokens=np.array([0, 3, 7, 8, 15, 9, 1], np.int64),
                   logits=(rng.randn(5, 32) * 3).astype(np.float32))
    tp2 = {"tp": 2}
    cases = [
        dict(name="tp2_mixed", model="a", mesh=tp2, engine=MIXED,
             ops=STAGGER),
        dict(name="tp1_mixed", model="a", mesh=None, engine=MIXED,
             ops=STAGGER),
        dict(name="tp2_split", model="a", mesh=tp2, engine=SPLIT,
             ops=STAGGER),
        dict(name="tp1_split", model="a", mesh=None, engine=SPLIT,
             ops=STAGGER),
        dict(name="tp2_prefix", model="a", mesh=tp2, engine=PREFIX,
             ops=PREFIX_OPS),
        dict(name="tp2_prefix_no_replay", model="a", mesh=tp2,
             engine=PREFIX, ops=PREFIX_OPS, drop_copy_replay=True),
        dict(name="tp2_sampled", model="s", mesh=tp2,
             engine=dict(SAMPLED, mixed_step=True, prefill_chunk_size=4),
             ops=sampled_ops),
        dict(name="tp2_sampled_split", model="s", mesh=tp2,
             engine=dict(SAMPLED, prefill_buckets=(4, 8)), ops=sampled_ops),
        dict(name="tp2_q8", model="s", mesh=tp2,
             engine=dict(qkw, kv_dtype="int8", quant_collectives=True),
             ops=q_ops),
        dict(name="tp2_w8", model="a", mesh=tp2,
             engine=dict(MIXED, weight_quant="int8"), ops=STAGGER),
        dict(name="tp2_w8_split", model="a", mesh=tp2,
             engine=dict(SPLIT, weight_quant="int8"), ops=STAGGER),
        dict(name="tp1_w8", model="a", mesh=None,
             engine=dict(MIXED, weight_quant="int8"), ops=STAGGER),
        dict(name="helpers", mesh=tp2, helpers=helpers),
    ]
    # the port's world runs in its own processes while the reference
    # serves here
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run_world,
                      "paddle_tpu_torch.testing.sharded:serve_cases", 2,
                      dict(device="cpu", backend="gloo", models=models,
                           cases=cases),
                      timeout=300, env={"OMP_NUM_THREADS": "2"})
    a = refs["a"]
    c0 = _ref_counters()
    e2, t2 = _ref_serve(a, STAGGER, mesh=ref_spmd.tp_mesh(2), **MIXED)
    c1 = _ref_counters()
    _, t1 = _ref_serve(a, STAGGER, **MIXED)
    _, p1 = _ref_serve(a, PREFIX_OPS, **PREFIX)
    s = refs["s"]
    _, smixed = _ref_serve(s, sampled_ops, mixed_step=True,
                           prefill_chunk_size=4, **SAMPLED)
    _, ssplit = _ref_serve(s, sampled_ops, prefill_buckets=(4, 8),
                           **SAMPLED)
    _, qfp = _ref_serve(s, q_ops, **qkw)
    _, w8 = _ref_serve(a, STAGGER, weight_quant="int8", **MIXED)
    out = {c["name"]: r for c, r in zip(cases, fut.result())}
    pool.shutdown()
    oracle = dict(tp2_mixed=t2, mixed=t1, prefix=p1, sampled_mixed=smixed,
                  sampled_split=ssplit, q_fp32=qfp, w8=w8,
                  tp2_counters={k: c1[k] - c0[k] for k in c0},
                  tp2_budgets=e2.token_budgets, helpers=helpers,
                  vocab_s=s.config.vocab_size,
                  q_slots=qkw["max_batch_size"])
    return out, oracle, refs


def test_tp2_mixed_and_split_byte_identical(world):
    out, ora, _ = world
    assert ora["tp2_mixed"] == ora["mixed"]          # the reference's own
    for name in ("tp2_mixed", "tp1_mixed", "tp2_split", "tp1_split"):
        assert out[name]["tokens"] == ora["tp2_mixed"], name
    f = out["tp2_mixed"]["facts"]
    assert f["tp_degree"] == 2 and not f["tp_is_none"]
    assert f["mixed_compiles"] <= 4 and f["decode_compiles"] == 0
    assert f["free"] == f["num_blocks"]              # no page leaked
    fs = out["tp2_split"]["facts"]
    assert fs["decode_compiles"] == 1
    assert fs["prefill_compiles"] <= 3


def test_tp2_pool_bytes_exactly_half_on_every_rank(world):
    out, _, _ = world
    whole = out["tp1_mixed"]["facts"]["pool_bytes"]
    for name in ("tp2_mixed", "tp2_split"):
        per_rank = [r["pool_bytes"] for r in out[name]["ranks"]]
        assert per_rank == [whole // 2] * 2, (name, per_rank, whole)
        assert 2 * per_rank[0] == whole


def test_tp2_metrics_equal_the_reference_registry(world):
    """``serving_tp_collective_bytes_total{op}`` over the same workload
    moves by the reference's amounts, and the degree gauges read 2."""
    out, ora, _ = world
    m = out["tp2_mixed"]["metrics"]
    ref = ora["tp2_counters"]
    assert m["serving_tp_collective_bytes_total{psum}"] == ref["psum"] > 0
    assert m["serving_tp_collective_bytes_total{all_gather}"] \
        == ref["all_gather"] > 0
    assert m["serving_tp_degree"] == 2.0
    assert m["serving_mesh_shape{tp}"] == 2.0
    assert m["serving_ep_degree"] == 1.0


def test_one_broadcast_per_device_operation(world):
    """Rank 0 sends each device operation (a step's packed array, a
    copy-on-write page copy) in ONE control broadcast, plus one to shut
    the workers down; every rank made the same broadcasts and sums."""
    out, _, _ = world
    for name in ("tp2_mixed", "tp2_split", "tp2_prefix"):
        f = out[name]["facts"]
        ops = f["device_ops"]
        assert ops["steps"] > 0
        assert f["control_broadcasts"] == ops["steps"] + ops["copies"] + 1
    assert out["tp2_prefix"]["facts"]["device_ops"]["copies"] == 1
    f = out["tp2_mixed"]["facts"]
    launches = out["tp2_mixed"]["ranks"][0]["launches"]
    assert launches["ragged"] == 0      # the CPU runs the plain versions
    # every rank made the same collectives, one per call
    calls = [r["collectives"]["calls"] for r in out["tp2_mixed"]["ranks"]]
    assert calls[0]["all_reduce"] == calls[1]["all_reduce"] > 0
    assert calls[0]["broadcast"] == calls[1]["broadcast"] \
        == f["control_broadcasts"]


def test_tp_prefix_cache_cow_parity_and_leak_free(world):
    out, ora, _ = world
    r = out["tp2_prefix"]
    assert r["tokens"] == ora["prefix"]
    f = r["facts"]
    assert f["prefix_hits"][2] == 7                  # the COW-capped hit
    assert f["cached_refcounts_one"]
    assert f["free"] + f["cached"] == f["num_blocks"]


def test_dropping_the_page_copy_replay_breaks_parity(world):
    """Without the copy-on-write copy on rank 1, its head-sharded pool
    drifts from rank 0's and the whole-prompt hit's tokens change."""
    out, ora, _ = world
    got = out["tp2_prefix_no_replay"]["tokens"]
    assert got[:2] == ora["prefix"][:2]
    assert got[2] != ora["prefix"][2]


def test_sampled_parity_split_vs_mixed_vs_tp(world):
    out, ora, _ = world
    assert ora["sampled_mixed"] == ora["sampled_split"]
    assert out["tp2_sampled"]["tokens"] == ora["sampled_mixed"]
    assert out["tp2_sampled_split"]["tokens"] == ora["sampled_mixed"]


def test_tp2_quant_collective_token_match(world):
    out, ora, _ = world
    r = out["tp2_q8"]
    assert _match_rate(ora["q_fp32"], r["tokens"]) >= 0.6
    top = r["facts"]["collective_bytes_top"]
    assert top["all_gather"] == ora["q_slots"] * (ora["vocab_s"] // 2) + 4
    m = r["metrics"]
    assert m["serving_quant_collective_bytes_total{all_gather}"] \
        == m["serving_tp_collective_bytes_total{all_gather}"] > 0


def test_tp2_w8_equals_one_card_w8_and_reference(world):
    """int8 weights under tp: each rank's codes and scales are the slice of
    the one-card tree (row-sharded scales reduced over tp), so the tokens
    equal the port's one-card w8 engine and the reference's."""
    out, ora, _ = world
    assert out["tp1_w8"]["tokens"] == ora["w8"]
    assert out["tp2_w8"]["tokens"] == ora["w8"]
    assert out["tp2_w8_split"]["tokens"] == ora["w8"]
    specs = out["tp2_w8"]["facts"]["specs"]
    assert specs["llama.layers.0.self_attn.q_proj.weight::scale"] == ("tp",)
    assert specs["llama.layers.0.mlp.down_proj.weight::scale"] == ()


def test_tp_helpers_match_the_reference(world):
    """``tp_embed`` (exact) and the exact and int8 logits gathers against
    the reference's under ``shard_map`` on two CPU devices."""
    out, ora, _ = world
    h = ora["helpers"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("tp",))

    def ref(fn, *a):
        return np.asarray(jax.jit(shard_map_compat(
            fn, mesh, in_specs=tuple(JP(*s) for s in a[1]),
            out_specs=JP()))(*a[0]))
    emb = ref(lambda t, x: ref_spmd.tp_embed(t, x, "tp"),
              (jnp.asarray(h["table"]), jnp.asarray(h["tokens"])),
              [("tp", None), ()])
    g = ref(lambda x: ref_spmd.tp_gather_logits(x, "tp"),
            (jnp.asarray(h["logits"]),), [(None, "tp")])
    q8 = ref(lambda x: ref_spmd.tp_gather_logits_q8(x, "tp"),
             (jnp.asarray(h["logits"]),), [(None, "tp")])
    got = out["helpers"]
    np.testing.assert_array_equal(got["embed"], emb)
    np.testing.assert_array_equal(got["gather"], g)
    np.testing.assert_array_equal(got["gather"], h["logits"])
    np.testing.assert_allclose(got["q8"], q8, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# construction: the reference's errors, before any rank is needed
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def whole():
    return _port_whole(_ref_model(num_hidden_layers=2, hidden_size=64,
                                  num_attention_heads=4,
                                  num_key_value_heads=2, vocab_size=128,
                                  intermediate_size=128))


def test_tp_validation_errors_at_construction(whole):
    base = dict(max_batch_size=2, num_blocks=16, block_size=4, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        ContinuousBatchingEngine(whole, mixed_step=True,
                                 mesh=spmd.tp_mesh(4), **base)
    with pytest.raises(ValueError, match="dense"):
        ContinuousBatchingEngine(whole, mesh=spmd.tp_mesh(2), **base)
    # tp = 1 degenerates to the plain one-device engine
    eng = ContinuousBatchingEngine(whole, mixed_step=True,
                                   mesh=spmd.tp_mesh(1), **base)
    assert eng.tp is None and eng.tp_degree == 1
    # a whole model under a tp = 2 mesh: each rank serves its shard
    with pytest.raises(ValueError, match="shard_model"):
        ContinuousBatchingEngine(whole, mixed_step=True,
                                 mesh=spmd.tp_mesh(2, backend="gloo"),
                                 **base)


def test_mesh_refusals_keep_the_reference_messages(whole):
    base = dict(max_batch_size=2, num_blocks=16, block_size=4, device="cpu",
                mixed_step=True)
    with pytest.raises(ValueError, match="single-chip"):
        ContinuousBatchingEngine(whole, draft_model=whole,
                                 mesh=spmd.tp_mesh(2), **base)
    with pytest.raises(ValueError, match="single-chip"):
        ContinuousBatchingEngine(whole, enable_prefix_cache=True,
                                 host_tier_bytes=1 << 20,
                                 mesh=spmd.tp_mesh(2), **base)
    with pytest.raises(ValueError, match="single-chip"):
        ContinuousBatchingEngine(whole, quant_collectives=True, **base)
    # cp and fsdp meshes serve (tests/test_torch_cp_serving.py,
    # tests/test_torch_fsdp_serving.py): every rank serves its shard, so a
    # whole model under them is refused as under tp
    for mesh in (ProcessMesh([2], ["cp"], backend="gloo"),
                 ProcessMesh([2], ["fsdp"], backend="gloo"),
                 spmd.cp_mesh(2, 2), spmd.mesh_2d(2, 2)):
        with pytest.raises(ValueError, match="shard_model"):
            ContinuousBatchingEngine(whole, mesh=mesh, **base)


def test_spec_tables_and_collective_bytes_equal_the_reference(whole):
    ref = _ref_model(num_hidden_layers=2, hidden_size=64,
                     num_attention_heads=4, num_key_value_heads=2,
                     vocab_size=128, intermediate_size=128)
    keys = list(ref.state_dict().keys())
    shapes = {k: tuple(v._value.shape) for k, v in ref.state_dict().items()}
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("tp",))
    got = spmd.llama_param_specs(keys, spmd.SpecLayout(), shapes=shapes,
                                 mesh={"tp": 2})
    want = ref_spmd.llama_param_specs(keys, ref_spmd.SpecLayout(),
                                      shapes=shapes, mesh=jmesh)
    assert {k: tuple(v) for k, v in got.items()} \
        == {k: tuple(v) for k, v in want.items()}
    qkeys = [k + "::scale" for k in keys if "proj" in k or "lm_head" in k]
    assert {k: tuple(v) for k, v in spmd.llama_param_specs(qkeys).items()} \
        == {k: tuple(v) for k, v in ref_spmd.llama_param_specs(
            qkeys).items()}
    pctx = spmd.tp_serving_context(whole, spmd.tp_mesh(2))
    rctx = ref_spmd.tp_serving_context(ref, RefMesh(shape=[2],
                                                    dim_names=["tp"]))
    assert {k: tuple(v) for k, v in pctx.specs.items()} \
        == {k: tuple(v) for k, v in rctx.specs.items()}
    for cfg_dtype in ("float32", "bfloat16"):
        cfg = ref_tiny_config(dtype=cfg_dtype)
        for n, rows, q8 in ((8, 4, False), (16, 4, True), (1, 1, False)):
            assert pctx.collective_bytes(cfg, n, rows, q8) \
                == rctx.collective_bytes(cfg, n, rows, q8)
    assert spmd.prune_spec_axes(spmd.P("tp", None), (3, 4), {"tp": 2}) \
        == tuple(ref_spmd.prune_spec_axes(JP("tp", None), (3, 4), jmesh))


def test_shard_is_the_slice_of_the_one_card_model():
    """``shard_model`` from the seed: each rank's parameters equal, bit for
    bit, the slices of the model the same seed builds whole (Linear
    weights cut along the port's ``[out, in]`` layout)."""
    from paddle_tpu_torch.models.llama import llama_tiny_config
    cfg = llama_tiny_config(num_key_value_heads=2)
    whole = LlamaForCausalLM(cfg, device="cpu")
    mesh = spmd.tp_mesh(2)
    sd = whole.state_dict()
    for rank in range(2):
        shard = spmd.shard_model(LlamaForCausalLM, cfg, mesh, rank=rank,
                                 device="cpu")
        att = shard.llama.layers[0].self_attn
        assert (att.num_heads, att.num_kv_heads) == (2, 1)
        for k, v in shard.state_dict().items():
            if "q_proj" in k or "up_proj" in k or k == "lm_head.weight":
                n = sd[k].shape[0] // 2
                want = sd[k][rank * n:(rank + 1) * n]
            elif "o_proj" in k or "down_proj" in k:
                n = sd[k].shape[1] // 2
                want = sd[k][:, rank * n:(rank + 1) * n]
            elif "embed_tokens" in k:
                n = sd[k].shape[0] // 2
                want = sd[k][rank * n:(rank + 1) * n]
            elif k.endswith("norm.weight"):
                want = sd[k]
            else:
                continue
            assert torch.equal(v, want), k
