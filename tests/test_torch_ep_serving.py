"""Expert-parallel (and ep x tp) serving in the port against the JAX
reference, on the CPU.

Two gloo worlds, each started once for this module
(``paddle_tpu_torch.distributed.launch.run_world`` over
``paddle_tpu_torch.testing.sharded.serve_cases``): two ranks for ep = 2,
four for ep2 x tp2 and tp = 4.  Each rank builds its shard of the
reference's weights.  The reference's engines and eager ``generate`` run
here, on the conftest's 8-device CPU mesh.  The gates are
``tests/test_serving_moe.py``'s: tokens byte-identical to the reference's
ep = 2 engine and to eager ``generate`` (the dispatch is dropless), the
bank spec ``('ep', None, None)`` with the router replicated, per-rank
expert bytes exactly 1/ep, the dispatch counted with nothing dropped, the
ep collective bytes, the validation errors, ep = 1 degenerating, the
prefix cache's copy-on-write leak-free, int8 expert PTQ under ep equal to
the one-card int8 engine.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.process_mesh import ProcessMesh as RefMesh
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.jit import spmd as ref_spmd
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_llama_config
from paddle_tpu.models.mixtral import MixtralForCausalLM as RefMixtral
from paddle_tpu.models.mixtral import mixtral_tiny_config as ref_tiny_config
from paddle_tpu.observability import default_registry as ref_registry

from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.distributed.process_mesh import ProcessMesh
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit import spmd
from paddle_tpu_torch.models import (LlamaConfig, MixtralConfig,
                                     MixtralForCausalLM)
from paddle_tpu_torch.ops import moe_gate as mg
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
P = [5, 17, 42, 7, 99, 3, 11, 23]
PREFIX = dict(max_batch_size=2, num_blocks=32, block_size=4,
              mixed_step=True, prefill_chunk_size=4,
              enable_prefix_cache=True)
PREFIX_OPS = [["add", P, 4], ["run"], ["add", P + [77, 8], 4],
              ["add", P, 4], ["run"]]
BANK = "mixtral.layers.0.block_sparse_moe.w_gate"
ROUTER = "mixtral.layers.0.block_sparse_moe.gate.weight"


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _ref_mixtral(**kw):
    paddle.seed(0)
    model = RefMixtral(ref_tiny_config(num_hidden_layers=2, **kw))
    model.eval()
    return model


def _cfg_dict(ref, cls):
    return {f: getattr(ref.config, f) for f in cls.__dataclass_fields__
            if hasattr(ref.config, f)}


def _ref_serve(model, ops, **kw):
    eng = RefEngine(model, **kw)
    rids = []
    for op in ops:
        if op[0] == "add":
            rids.append(eng.add_request(np.asarray(op[1], np.int64), op[2]))
        elif op[0] == "step":
            eng.step()
        else:
            eng.run_to_completion()
    return eng, [eng.result(r) for r in rids]


def _eager(model, prompts, n):
    out = []
    for p in prompts:
        ids = model.generate(paddle.to_tensor(np.asarray(p)[None, :]),
                             max_new_tokens=n)
        out.append(np.asarray(ids._value)[0, len(p):].tolist())
    return out


def _ref_ep_counters():
    c = ref_registry().get("serving_ep_collective_bytes_total")
    return {op: c.labels(op=op).value if c else 0.0
            for op in ("all_to_all", "all_gather")}


def _save(tmp, name, ref, family, cls):
    path = str(tmp / ("%s.npz" % name))
    np.savez(path, **{k: _np(v) for k, v in ref.state_dict().items()})
    return dict(family=family, config=_cfg_dict(ref, cls), state=path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_world")
    mix = _ref_mixtral()
    paddle.seed(0)
    llama4 = RefLlama(ref_llama_config(num_hidden_layers=2, hidden_size=64,
                                       num_attention_heads=4,
                                       num_key_value_heads=4,
                                       vocab_size=128,
                                       intermediate_size=128))
    llama4.eval()
    models = {"m": _save(tmp, "m", mix, "mixtral", MixtralConfig),
              "l4": _save(tmp, "l4", llama4, "llama", LlamaConfig)}
    ep2 = {"ep": 2}
    two = [
        dict(name="ep2", model="m", mesh=ep2, engine=MIXED, ops=STAGGER),
        dict(name="one", model="m", mesh=None, engine=MIXED, ops=STAGGER),
        dict(name="ep2_prefix", model="m", mesh=ep2, engine=PREFIX,
             ops=PREFIX_OPS),
        dict(name="ep2_w8", model="m", mesh=ep2,
             engine=dict(MIXED, weight_quant="int8"), ops=STAGGER),
        dict(name="one_w8", model="m", mesh=None,
             engine=dict(MIXED, weight_quant="int8"), ops=STAGGER),
    ]
    four = [
        dict(name="ep2_tp2", model="m", mesh={"ep": 2, "tp": 2},
             engine=MIXED, ops=STAGGER),
        dict(name="tp4", model="l4", mesh={"tp": 4}, engine=MIXED,
             ops=STAGGER),
    ]
    run = dict(device="cpu", backend="gloo", models=models)
    env = {"OMP_NUM_THREADS": "1"}
    # the port's worlds run in their own processes while the reference
    # serves here
    pool = ThreadPoolExecutor(2)
    f2 = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                     "serve_cases", 2, dict(run, cases=two), timeout=300,
                     env=env)
    f4 = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                     "serve_cases", 4, dict(run, cases=four), timeout=300,
                     env=env)
    c0 = _ref_ep_counters()
    e2, t2 = _ref_serve(mix, STAGGER, mesh=ref_spmd.ep_mesh(2), **MIXED)
    c1 = _ref_ep_counters()
    _, w8 = _ref_serve(mix, STAGGER, weight_quant="int8", **MIXED)
    _, pre = _ref_serve(mix, PREFIX_OPS, **PREFIX)
    _, l4 = _ref_serve(llama4, STAGGER, **MIXED)
    out = {c["name"]: r for c, r in zip(two + four,
                                        f2.result() + f4.result())}
    pool.shutdown()
    oracle = dict(ep2=t2, eager=_eager(mix, PROMPTS, BUDGET), w8=w8,
                  prefix=pre, llama4=l4,
                  ep2_counters={k: c1[k] - c0[k] for k in c0},
                  bank_bytes=_np(mix.state_dict()[BANK]).nbytes)
    return out, oracle, mix


def test_ep2_mixed_parity_expert_shard_and_metrics(worlds):
    out, ora, _ = worlds
    assert ora["ep2"] == ora["eager"]
    r = out["ep2"]
    assert r["tokens"] == ora["eager"]
    assert out["one"]["tokens"] == ora["eager"]
    f = r["facts"]
    assert f["ep_degree"] == 2 and f["tp_degree"] == 1
    assert f["mixed_compiles"] <= 4
    assert f["specs"][BANK] == ("ep",) or \
        (f["specs"][BANK][0] == "ep"
         and all(a is None for a in f["specs"][BANK][1:]))
    assert all(a is None for a in f["specs"][ROUTER])
    # per-rank expert bytes exactly 1/ep; the pools are whole on each rank
    whole = out["one"]["ranks"][0]
    for rk in r["ranks"]:
        assert 2 * rk["expert_bytes"] == whole["expert_bytes"]
        assert rk["pool_bytes"] == whole["pool_bytes"]
    m = r["metrics"]
    assert m["serving_ep_degree"] == 2.0
    assert m["serving_mesh_shape{ep}"] == 2.0
    assert m["serving_moe_dispatch_tokens_total{routed}"] > 0
    assert m["serving_moe_dispatch_tokens_total{dropped}"] == 0
    ref = ora["ep2_counters"]
    assert m["serving_ep_collective_bytes_total{all_to_all}"] \
        == ref["all_to_all"] > 0
    assert m["serving_ep_collective_bytes_total{all_gather}"] \
        == ref["all_gather"] > 0


def test_ep2_tp2_composed_parity(worlds):
    out, ora, _ = worlds
    r = out["ep2_tp2"]
    assert r["tokens"] == ora["eager"]
    f = r["facts"]
    assert f["ep_degree"] == 2 and f["tp_degree"] == 2
    assert "tp" in f["specs"]["mixtral.layers.0.self_attn.q_proj.weight"]
    assert f["specs"]["mixtral.layers.0.block_sparse_moe.w_up"][0] == "ep"
    whole = out["one"]["ranks"][0]
    for rk in r["ranks"]:
        assert 2 * rk["expert_bytes"] == whole["expert_bytes"]
        assert 2 * rk["pool_bytes"] == whole["pool_bytes"]


def test_tp4_mixed_parity(worlds):
    out, ora, _ = worlds
    r = out["tp4"]
    assert r["tokens"] == ora["llama4"]
    assert len({rk["pool_bytes"] for rk in r["ranks"]}) == 1


def test_ep_prefix_cache_cow_parity_and_leak_free(worlds):
    out, ora, _ = worlds
    r = out["ep2_prefix"]
    assert r["tokens"] == ora["prefix"]
    f = r["facts"]
    assert f["cached_refcounts_one"]
    assert f["free"] + f["cached"] == f["num_blocks"]


def test_ep2_int8_expert_ptq_equals_one_card_int8(worlds):
    out, ora, _ = worlds
    assert out["one_w8"]["tokens"] == ora["w8"]
    assert out["ep2_w8"]["tokens"] == ora["w8"]
    specs = out["ep2_w8"]["facts"]["specs"]
    assert specs[BANK + "::scale"][0] == "ep"


@pytest.fixture(scope="module")
def port_mixtral():
    ref = _ref_mixtral()
    port = MixtralForCausalLM(MixtralConfig(**_cfg_dict(ref, MixtralConfig)),
                              device="cpu")
    load_paddle_tpu_weights(port, {k: _np(v)
                                   for k, v in ref.state_dict().items()})
    return ref, port.eval()


def test_ep_validation_errors_at_construction(port_mixtral):
    _, model = port_mixtral
    base = dict(max_batch_size=2, num_blocks=16, block_size=4, device="cpu")
    three = MixtralForCausalLM(MixtralConfig(**dict(
        _cfg_dict(port_mixtral[0], MixtralConfig), num_local_experts=3)),
        device="cpu")
    with pytest.raises(ValueError, match="divide"):
        ContinuousBatchingEngine(three, mixed_step=True, prefill_chunk_size=4,
                                 mesh=spmd.ep_mesh(2), **base)
    with pytest.raises(ValueError, match="mixed"):
        ContinuousBatchingEngine(model, mesh=spmd.ep_mesh(2), **base)
    with pytest.raises(ValueError, match="budget"):
        ContinuousBatchingEngine(model, mixed_step=True, prefill_chunk_size=4,
                                 token_budgets=(3, 8), mesh=spmd.ep_mesh(2),
                                 **base)
    with pytest.raises(ValueError, match="speculative"):
        spmd.validate_ep_serving(4, 2, spec_decode=True)
    eng = ContinuousBatchingEngine(model, mixed_step=True,
                                   mesh=spmd.ep_mesh(1), **base)
    assert eng.tp is None and eng.ep_degree == 1
    blk = model.mixtral.layers[0].block_sparse_moe
    with pytest.raises(TypeError, match="AxisComm"):
        mg.moe_ffn(torch.zeros(4, 64), blk.gate.weight, blk.w_gate,
                   blk.w_up, blk.w_down, top_k=2, ep_axis="ep", ep_degree=2)


def test_ep_specs_and_collective_bytes_equal_the_reference(port_mixtral):
    ref, port = port_mixtral
    for shape, names in (([2], ["ep"]), ([2, 2], ["ep", "tp"])):
        pctx = spmd.tp_serving_context(port, ProcessMesh(shape, names))
        rctx = ref_spmd.tp_serving_context(ref, RefMesh(shape=shape,
                                                        dim_names=names))
        assert {k: tuple(v) for k, v in pctx.specs.items()} \
            == {k: tuple(v) for k, v in rctx.specs.items()}
        for dtype in ("float32", "bfloat16"):
            cfg = ref_tiny_config(dtype=dtype)
            for n in (4, 8, 16):
                assert pctx.collective_bytes(cfg, n, 4) \
                    == rctx.collective_bytes(cfg, n, 4)
