"""Context-parallel serving in the port against the JAX reference, on the
CPU.

The port's ranks run as two gloo worlds started once for this module
(``paddle_tpu_torch.distributed.launch.run_world`` over
``paddle_tpu_torch.testing.sharded.serve_cases``): two ranks for cp = 2,
four for cp = 4 and cp2 x tp2.  Each rank builds its shard of the
reference's weights (under pure cp the whole model: no spec names cp) and
serves every case in turn.  The reference's engines run here, on the
conftest's 8-device CPU mesh.  The gates are ``tests/test_serving_cp.py``'s:
tokens byte-identical to the reference's cp engine and to the one-rank
twin (mixed and split, cp 2 and 4, cp x tp, a prompt chunked across page
and stripe boundaries, the prefix cache's copy-on-write), per-rank pool
bytes exactly 1/cp (1/(cp·tp)), each rank's pools its slot stripe of the
one-rank pools (layer 0 bitwise), the stripe-merge bytes equal to the
reference registry's, the construction errors with the reference's
messages, Mixtral under cp; and the stripe partials, ``merge_partials`` and
``_cp_local_dest`` against the reference's functions.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.jit import serving_step as ref_step
from paddle_tpu.jit import spmd as ref_spmd
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.models.mixtral import MixtralForCausalLM as RefMixtral
from paddle_tpu.models.mixtral import mixtral_tiny_config
from paddle_tpu.observability import default_registry as ref_registry
from paddle_tpu.ops import online_softmax as ref_os
from paddle_tpu.ops import paged_attention as ref_pa

from paddle_tpu_torch.distributed.launch import run_world
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit import spmd
from paddle_tpu_torch.jit.serving_step import _cp_local_dest
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     MixtralConfig)
from paddle_tpu_torch.ops import online_softmax as pos
from paddle_tpu_torch.ops import paged_attention as ppa
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
# tests/test_serving_cp.py's prefix workload: the last request is a
# whole-prompt hit, so its last shared page is copied (copy-on-write)
P = [5, 17, 42, 7, 99, 3, 11, 23]
PREFIX = dict(max_batch_size=2, num_blocks=32, block_size=4,
              mixed_step=True, prefill_chunk_size=4,
              enable_prefix_cache=True)
PREFIX_OPS = [["add", P, 4], ["run"], ["add", P + [77, 8], 4],
              ["add", P, 4], ["run"]]
# a 20-token prompt: chunks cross page and stripe boundaries
LONG_OPS = [["add", [t % 120 for t in range(1, 21)], 4], ["run"]]
CP_BYTES = "serving_cp_collective_bytes_total{all_gather}"
FP32_REL = 1e-6


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _ref_model():
    paddle.seed(0)
    model = RefLlama(ref_tiny_config(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=128, intermediate_size=128))
    model.eval()
    return model


def _cfg_dict(ref, cls=LlamaConfig):
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


def _ref_cp_bytes():
    c = ref_registry().get("serving_cp_collective_bytes_total")
    return c.labels(op="all_gather").value if c else 0.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp_world")
    ref = _ref_model()
    path = str(tmp / "m.npz")
    np.savez(path, **{k: _np(v) for k, v in ref.state_dict().items()})
    paddle.seed(0)
    mix = RefMixtral(mixtral_tiny_config(num_hidden_layers=2,
                                         vocab_size=128))
    mix.eval()
    xpath = str(tmp / "x.npz")
    np.savez(xpath, **{k: _np(v) for k, v in mix.state_dict().items()})
    models = {"m": dict(family="llama", config=_cfg_dict(ref), state=path),
              "x": dict(family="mixtral", state=xpath,
                        config=_cfg_dict(mix, MixtralConfig))}
    cp2 = {"cp": 2}
    two = [
        dict(name="one", model="m", mesh=None, engine=MIXED, ops=STAGGER,
             return_pools=True),
        dict(name="one_split", model="m", mesh=None, engine=SPLIT,
             ops=STAGGER),
        dict(name="one_long", model="m", mesh=None, engine=MIXED,
             ops=LONG_OPS),
        dict(name="cp2", model="m", mesh=cp2, engine=MIXED, ops=STAGGER,
             return_pools=True),
        dict(name="cp2_split", model="m", mesh=cp2, engine=SPLIT,
             ops=STAGGER),
        dict(name="cp2_prefix", model="m", mesh=cp2, engine=PREFIX,
             ops=PREFIX_OPS),
        dict(name="x_cp2", model="x", mesh=cp2, engine=MIXED, ops=STAGGER),
    ]
    four = [
        dict(name="cp4", model="m", mesh={"cp": 4}, engine=MIXED,
             ops=STAGGER),
        dict(name="cp4_long", model="m", mesh={"cp": 4}, engine=MIXED,
             ops=LONG_OPS),
        dict(name="cp2_tp2", model="m", mesh={"cp": 2, "tp": 2},
             engine=MIXED, ops=STAGGER),
    ]
    run = dict(device="cpu", backend="gloo", models=models)
    env = {"OMP_NUM_THREADS": "1"}
    pool = ThreadPoolExecutor(2)
    f2 = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                     "serve_cases", 2, dict(run, cases=two), timeout=300,
                     env=env)
    f4 = pool.submit(run_world, "paddle_tpu_torch.testing.sharded:"
                     "serve_cases", 4, dict(run, cases=four), timeout=300,
                     env=env)
    b0 = _ref_cp_bytes()
    _, cp2_t = _ref_serve(ref, STAGGER, mesh=ref_spmd.cp_mesh(2), **MIXED)
    b1 = _ref_cp_bytes()
    _, cp2_split = _ref_serve(ref, STAGGER, mesh=ref_spmd.cp_mesh(2),
                              **SPLIT)
    b2 = _ref_cp_bytes()
    _, cp2_prefix = _ref_serve(ref, PREFIX_OPS, mesh=ref_spmd.cp_mesh(2),
                               **PREFIX)
    _, x_cp2 = _ref_serve(mix, STAGGER, mesh=ref_spmd.cp_mesh(2), **MIXED)
    _, x_one = _ref_serve(mix, STAGGER, **MIXED)
    out = {c["name"]: r for c, r in zip(two + four,
                                        f2.result() + f4.result())}
    pool.shutdown()
    oracle = dict(cp2=cp2_t, cp2_split=cp2_split, cp2_prefix=cp2_prefix,
                  cp2_bytes=b1 - b0, cp2_split_bytes=b2 - b1, x_cp2=x_cp2,
                  x_one=x_one)
    return out, oracle


def test_cp2_mixed_and_split_byte_identical(worlds):
    out, ora = worlds
    assert out["cp2"]["tokens"] == ora["cp2"] == out["one"]["tokens"]
    assert out["cp2_split"]["tokens"] == ora["cp2_split"] \
        == out["one_split"]["tokens"]
    f = out["cp2"]["facts"]
    assert f["cp_degree"] == 2 and f["tp_degree"] == 1
    assert f["mixed_compiles"] <= 4 and f["decode_compiles"] == 0
    assert f["free"] == 64
    s = out["cp2_split"]["facts"]
    assert s["decode_compiles"] == 1 and s["prefill_compiles"] <= 3


def test_cp_pool_bytes_exactly_one_over_cp(worlds):
    out, _ = worlds
    whole = out["one"]["ranks"][0]["pool_bytes"]
    for name, part in (("cp2", 2), ("cp2_split", 2), ("cp4", 4),
                       ("cp2_tp2", 4)):
        for rk in out[name]["ranks"]:
            assert rk["pool_bytes"] * part == whole, (name, rk["rank"])


def test_cp_pools_hold_each_ranks_slot_stripe(worlds):
    """Each rank's pools are its stripe of the one-rank engine's (the sink
    excluded: under cp it absorbs the stripes' unowned writes): layer 0 —
    written from the same embeddings — bitwise, deeper layers, whose
    inputs crossed the merge, to float tolerance."""
    out, _ = worlds
    full = out["one"]["ranks"][0]["pools"]
    for rk in out["cp2"]["ranks"]:
        r = rk["rank"]
        for li, pair in enumerate(rk["pools"]):
            for got, want in zip(pair, full[li]):
                bsl = got.shape[1]
                assert bsl * 2 == want.shape[1]
                want = want[:-1, r * bsl:(r + 1) * bsl]
                if li == 0:
                    np.testing.assert_array_equal(got[:-1], want)
                else:
                    np.testing.assert_allclose(got[:-1], want, rtol=2e-5,
                                               atol=2e-6)


def test_cp4_and_cp_x_tp_parity(worlds):
    out, ora = worlds
    assert out["cp4"]["tokens"] == out["one"]["tokens"] == ora["cp2"]
    assert out["cp2_tp2"]["tokens"] == out["one"]["tokens"]
    f = out["cp2_tp2"]["facts"]
    assert f["cp_degree"] == 2 and f["tp_degree"] == 2
    assert out["cp4"]["facts"]["mixed_compiles"] <= 4


def test_mixtral_under_cp(worlds):
    """The MoE layers replicate over cp (no spec names it); the dropless
    dispatch runs on every rank as on one card."""
    out, ora = worlds
    assert out["x_cp2"]["tokens"] == ora["x_cp2"] == ora["x_one"]
    m = out["x_cp2"]["metrics"]
    assert m["serving_moe_dispatch_tokens_total{routed}"] > 0
    assert m["serving_moe_dispatch_tokens_total{dropped}"] == 0


def test_cp_chunked_long_prompt_parity(worlds):
    out, _ = worlds
    assert out["cp4_long"]["tokens"] == out["one_long"]["tokens"]


def test_cp_prefix_cache_cow_parity_and_leak_free(worlds):
    out, ora = worlds
    r = out["cp2_prefix"]
    assert r["tokens"] == ora["cp2_prefix"]
    f = r["facts"]
    assert f["prefix_hits"][2] == 7            # the COW-capped hit
    assert f["cached_refcounts_one"]
    assert f["free"] + f["cached"] == f["num_blocks"]


def test_cp_metrics_equal_the_reference_registry(worlds):
    out, ora = worlds
    m = out["cp2"]["metrics"]
    assert m["serving_cp_degree"] == 2.0
    assert m["serving_mesh_shape{cp}"] == 2.0
    assert m[CP_BYTES] == ora["cp2_bytes"] > 0
    assert out["cp2_split"]["metrics"][CP_BYTES] == ora["cp2_split_bytes"] \
        > 0
    # cp x tp: the merge moves 1/tp of the heads
    top = out["cp2_tp2"]["facts"]["collective_bytes_top"]
    assert top["cp_merge"] * 2 == out["cp2"]["facts"][
        "collective_bytes_top"]["cp_merge"]


@pytest.fixture(scope="module")
def whole():
    ref = _ref_model()
    port = LlamaForCausalLM(LlamaConfig(**_cfg_dict(ref)), device="cpu")
    load_paddle_tpu_weights(port, {k: _np(v)
                                   for k, v in ref.state_dict().items()})
    return ref, port.eval()


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_cp_validation_messages_equal_the_reference(whole):
    for kw in (dict(block_size=6), dict(block_size=4, quantized_kv=True),
               dict(block_size=4, dense_prefill=True),
               dict(block_size=4, spec_decode=True)):
        assert _message(spmd.validate_cp_serving, 4, **kw) \
            == _message(ref_spmd.validate_cp_serving, 4, **kw)
    spmd.validate_cp_serving(1, 6, quantized_kv=True)
    _, model = whole
    base = dict(max_batch_size=2, num_blocks=16, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        ContinuousBatchingEngine(model, block_size=6, mixed_step=True,
                                 prefill_chunk_size=4, mesh=spmd.cp_mesh(4),
                                 **base)
    with pytest.raises(ValueError, match="dense"):
        ContinuousBatchingEngine(model, block_size=4, mesh=spmd.cp_mesh(2),
                                 **base)
    with pytest.raises(ValueError, match="int8"):
        ContinuousBatchingEngine(model, block_size=4, mixed_step=True,
                                 prefill_chunk_size=4, kv_dtype="int8",
                                 mesh=spmd.cp_mesh(2), **base)
    eng = ContinuousBatchingEngine(model, block_size=4, mixed_step=True,
                                   mesh=spmd.cp_mesh(1), **base)
    assert eng.tp is None and eng.cp_degree == 1
    with pytest.raises(ValueError, match="degree"):
        spmd.cp_mesh(0)


def test_cp_mesh_and_context_match_the_reference(whole):
    ref, port = whole
    for cp, tp in ((2, 1), (2, 2), (4, 1)):
        pm, rm = spmd.cp_mesh(cp, tp=tp), ref_spmd.cp_mesh(cp, tp=tp)
        assert pm.shape == list(rm.shape)
        assert pm.dim_names == list(rm.dim_names)
        pctx = spmd.tp_serving_context(port, pm)
        rctx = ref_spmd.tp_serving_context(ref, rm)
        assert (pctx.cp_degree, pctx.degree, pctx.cp_axis) \
            == (rctx.cp_degree, rctx.degree, rctx.cp_axis)
        assert tuple(pctx.layout.kv_pool()) == tuple(rctx.layout.kv_pool())
        assert {k: tuple(v) for k, v in pctx.specs.items()} \
            == {k: tuple(v) for k, v in rctx.specs.items()}
        for n in (4, 8, 16):
            assert pctx.collective_bytes(ref.config, n, 4) \
                == rctx.collective_bytes(ref.config, n, 4)


# ---------------------------------------------------------------------------
# the stripe partials, the merge and the destinations against the
# reference's functions
# ---------------------------------------------------------------------------
BS, CP, HKV, H, D = 4, 2, 2, 4, 16
BSL = BS // CP


def _pools(rng, phys):
    k = rng.standard_normal((phys, BS, HKV, D)).astype(np.float32)
    v = rng.standard_normal((phys, BS, HKV, D)).astype(np.float32)
    return k, v


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    scale = max(float(np.abs(want[fin]).max()), 1.0) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=FP32_REL * scale)


def _stripe(a, r):
    return np.ascontiguousarray(a[:, r * BSL:(r + 1) * BSL])


def test_ragged_partials_match_the_reference_and_merge_to_the_full():
    rng = np.random.default_rng(0)
    T, W, phys = 16, 5, 21
    k, v = _pools(rng, phys)
    # spans: two decodes, a chunk, one decode whose kv fits rank 0's
    # stripe alone (rank 1's stripe is empty for it), a padding span
    q_off = np.array([0, 1, 2, 9, T], np.int32)
    q_len = np.array([1, 1, 7, 1, 0], np.int32)
    kv_len = np.array([9, 3, 17, 2, 1], np.int32)
    bt = np.stack([rng.permutation(phys - 1)[:W] for _ in range(5)]
                  ).astype(np.int32)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    scale = D ** -0.5
    rows = np.concatenate([np.arange(o, o + n)
                           for o, n in zip(q_off, q_len) if n])
    parts = []
    for r in range(CP):
        ks, vs = _stripe(k, r), _stripe(v, r)
        got = ppa.ragged_attention_partial(
            torch.from_numpy(q), torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(bt), q_off, q_len, kv_len, scale, r * BSL, BS)
        want = ref_pa._ragged_attention_xla_partial(
            jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(bt), jnp.asarray(q_off), jnp.asarray(q_len),
            jnp.asarray(kv_len), scale, jnp.int32(r * BSL), BS)
        for g, w in zip(got, want):
            _close(g.numpy()[rows], np.asarray(w)[rows])
        parts.append(got)
    # the empty stripe: rank 1 holds nothing of span 3's two keys, exactly
    o1, m1, l1 = (t.numpy() for t in parts[1])
    assert (o1[9] == 0).all() and np.isneginf(m1[9]).all() \
        and (l1[9] == 0).all()
    # the two stripes merge to the one-rank plain attention
    merged = pos.merge_partials(torch.stack([p[1] for p in parts]),
                                torch.stack([p[2] for p in parts]),
                                torch.stack([p[0] for p in parts]), axis=0)
    full = ppa._ragged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bt), torch.from_numpy(q_off),
        torch.from_numpy(q_len), torch.from_numpy(kv_len), scale)
    _close(merged.numpy()[rows], full.numpy()[rows])


def test_decode_and_chunk_partials_match_the_reference():
    rng = np.random.default_rng(1)
    B, W, phys = 5, 6, 31
    k, v = _pools(rng, phys)
    bt = np.stack([rng.permutation(phys - 1)[:W] for _ in range(B)]
                  ).astype(np.int32)
    seen = np.array([1, 7, 2, 21, 13], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    C, start = 6, 9
    qc = rng.standard_normal((1, C, H, D)).astype(np.float32)
    scale = D ** -0.5
    for r in range(CP):
        ks, vs = _stripe(k, r), _stripe(v, r)
        # the host's longest sequence bounds the pages read; the whole
        # block-table row gives the same partials
        for max_len in (int(seen.max()), W * BS):
            got = ppa.paged_attention_partial(
                torch.from_numpy(q), torch.from_numpy(ks),
                torch.from_numpy(vs), torch.from_numpy(bt),
                torch.from_numpy(seen), scale, r * BSL, BS, max_len)
            want = ref_pa._paged_attention_xla_partial(
                jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                jnp.asarray(bt), jnp.asarray(seen), scale,
                jnp.int32(r * BSL), BS)
            for g, w in zip(got, want):
                _close(g.numpy(), np.asarray(w))
        got = ppa.chunk_prefill_attention_partial(
            torch.from_numpy(qc), torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(bt[:1]), start, scale, r * BSL, BS)
        want = ref_pa.chunk_prefill_attention_partial(
            jnp.asarray(qc), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(bt[:1]), jnp.int32(start), scale,
            jnp.int32(r * BSL), BS)
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w))
    # slot 0 sees one key, at rank 0: rank 1's stripe is empty, exactly
    o, m, l = ppa.paged_attention_partial(
        torch.from_numpy(q), torch.from_numpy(_stripe(k, 1)),
        torch.from_numpy(_stripe(v, 1)), torch.from_numpy(bt),
        torch.from_numpy(seen), scale, BSL, BS, int(seen.max()))
    assert (o[0] == 0).all() and torch.isneginf(m[0]).all() \
        and (l[0] == 0).all()


def test_merge_partials_matches_the_reference():
    rng = np.random.default_rng(2)
    n, T, Hh, Dd = 3, 7, 4, 8
    m = rng.standard_normal((n, T, Hh)).astype(np.float32) * 3
    l = rng.random((n, T, Hh)).astype(np.float32) * 5 + 0.1
    o = rng.standard_normal((n, T, Hh, Dd)).astype(np.float32)
    m[1, 2] = -np.inf                       # one empty partial
    l[1, 2] = 0
    o[1, 2] = 0
    m[:, 4] = -np.inf                       # an all-empty row
    l[:, 4] = 0
    o[:, 4] = 0
    got = pos.merge_partials(torch.from_numpy(m), torch.from_numpy(l),
                             torch.from_numpy(o), axis=0).numpy()
    want = np.asarray(ref_os.merge_partials(jnp.asarray(m), jnp.asarray(l),
                                            jnp.asarray(o), axis=0))
    _close(got, want)
    assert (got[4] == 0).all()
    # the empty partial drops out exactly
    keep = pos.merge_partials(torch.from_numpy(m[[0, 2], 2]),
                              torch.from_numpy(l[[0, 2], 2]),
                              torch.from_numpy(o[[0, 2], 2]), axis=0)
    assert torch.equal(keep, torch.from_numpy(got[2]))


def test_cp_local_dest_is_the_reference_exactly():
    rng = np.random.default_rng(3)
    for cp, bs in ((2, 4), (4, 4), (2, 16)):
        bsl, sink, n = bs // cp, 63, 40
        blocks = rng.integers(0, 63, n).astype(np.int32)
        offs = rng.integers(0, bs, n).astype(np.int32)
        ref = jax.vmap(lambda _r: ref_step._cp_local_dest(
            jnp.asarray(blocks), jnp.asarray(offs), bsl, "cp", sink),
            axis_name="cp")(jnp.zeros(cp))
        for r in range(cp):
            blk, off = _cp_local_dest(torch.from_numpy(blocks).long(),
                                      torch.from_numpy(offs).long(), bsl, r,
                                      sink)
            assert np.array_equal(blk.numpy(), np.asarray(ref[0][r]))
            assert np.array_equal(off.numpy(), np.asarray(ref[1][r]))
