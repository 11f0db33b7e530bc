"""The port's Mixtral (sparse MoE) against the JAX reference, on the CPU.

``ops/moe_gate.py``'s functions against the reference's on the same
numpy inputs (a planted tie included), the eager capacity block's drops
and aux loss, the tiny model's logits and eager tokens, the mixed and
bucketed split engines against the reference's engines and eager
``generate`` with equal ``serving_moe_dispatch_tokens_total``, the
expert-bank PTQ tree and the w8 engine, and a five-step ``TrainStep``
trajectory against the reference's eager AdamW loop.  The engines hold
the eager model only where the eager block drops nothing: at
``mixtral_tiny_config``'s E = 4, k = 2 and factor 2.0 an expert's
capacity is ``N``, so no assignment can drop (``expert_capacity_factor >=
E / k``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import observability as ref_obs
from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.models.mixtral import MixtralForCausalLM as RefMixtral
from paddle_tpu.models.mixtral import \
    MixtralPretrainingCriterion as RefMixtralCriterion
from paddle_tpu.models.mixtral import MixtralSparseMoeBlock as RefBlock
from paddle_tpu.models.mixtral import \
    mixtral_tiny_config as ref_tiny_config
from paddle_tpu.ops import moe_gate as ref_mg
from paddle_tpu.quantization import functional as ref_qf

from paddle_tpu_torch import observability as port_obs
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit.train_step import TrainStep
from paddle_tpu_torch.models import (MixtralConfig, MixtralForCausalLM,
                                     MixtralPretrainingCriterion,
                                     MixtralSparseMoeBlock)
from paddle_tpu_torch.ops import dequant as dq
from paddle_tpu_torch.ops import moe_gate as mg
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.quantization import functional as qf
from paddle_tpu_torch.testing.parity import (load_paddle_tpu_weights,
                                             ptq_tree_from_paddle_tpu)
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

# fp32, same algorithm, other summation order: rounding only
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
SUFFIX = qf.WEIGHT_SCALE_SUFFIX
# tests/test_serving_moe.py's prompts (the last one chunks) and budget
PROMPTS = [np.array([7, 9, 2], np.int64),
           np.array([3, 14, 15, 92, 65], np.int64),
           np.arange(1, 11, dtype=np.int64)]
BUDGET = 4
ENGINES = {"mixed": dict(mixed_step=True, prefill_chunk_size=4),
           "split": dict(prefill_buckets="auto", prefill_chunk_size=4)}


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _pair(seed=0, **kw):
    """(reference Mixtral, the port's with the reference's weights), both
    ``mixtral_tiny_config(**kw)``."""
    paddle.seed(seed)
    ref_cfg = ref_tiny_config(**kw)
    ref = RefMixtral(ref_cfg)
    ref.eval()
    cfg = MixtralConfig(**{f: getattr(ref_cfg, f)
                           for f in MixtralConfig.__dataclass_fields__})
    port = MixtralForCausalLM(cfg, device="cpu")
    load_paddle_tpu_weights(port, {k: _np(v)
                                   for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def pair():
    return _pair()


# ---------------------------------------------------------------------------
# ops/moe_gate.py
# ---------------------------------------------------------------------------
def _gate_inputs(seed, n=24, e=4, k=2, d=16, tie=False):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, e).astype(np.float32)
    if tie:
        logits[::3] = 0.0          # a zero router row: uniform probs
        logits[1::3, 1] = logits[1::3, 3]
    x = rng.randn(n, d).astype(np.float32)
    return logits, x


@pytest.mark.parametrize("tie", [False, True], ids=["random", "planted_tie"])
def test_topk_gate_and_slots_match_reference(tie):
    """Weights within fp32 rounding, indices exact: ties (a zero logit row,
    two equal logits) go to the lower expert index, as jax.lax.top_k
    orders them; the slots and one-hots exact."""
    logits, _ = _gate_inputs(0, tie=tie)
    rw, ri, rp = ref_mg.topk_gate(jnp.asarray(logits), 2)
    w, i, p = mg.topk_gate(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), **FP32_TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), **FP32_TOL)
    if tie:
        assert (i.numpy()[::3] == [0, 1]).all()
    rs, roh = ref_mg.assignment_slots(ri, 4)
    s, oh = mg.assignment_slots(i, 4)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(oh.numpy(), np.asarray(roh))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [None, 5], ids=["dropless", "cap5"])
def test_dispatch_swiglu_combine_match_reference(dtype, capacity):
    """The capacity buffers bitwise (an exact scatter), the grouped SwiGLU
    and the combine within rounding, dropless and at a capacity of 5 of
    24 tokens (drops)."""
    logits, x = _gate_inputs(1)
    E, k, D, M = 4, 2, 16, 24
    rng = np.random.RandomState(2)
    banks = [rng.randn(E, D, M).astype(np.float32) * 0.2,
             rng.randn(E, D, M).astype(np.float32) * 0.2,
             rng.randn(E, M, D).astype(np.float32) * 0.2]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    C = x.shape[0] * k if capacity is None else capacity
    rw, ri, _ = ref_mg.topk_gate(jnp.asarray(logits), k)
    rs, _ = ref_mg.assignment_slots(ri, E)
    rkeep = None if capacity is None else rs < C
    rx = jnp.asarray(x, jdt)
    rdisp = ref_mg.dispatch_to_buffers(rx, ri, rs, rkeep, E, C)
    reo = ref_mg.grouped_expert_swiglu(
        rdisp, *[jnp.asarray(b, jdt) for b in banks])
    rout = ref_mg.combine_from_buffers(reo, ri, rs, rw, rkeep)

    w, i, _ = mg.topk_gate(torch.from_numpy(logits), k)
    s, _ = mg.assignment_slots(i, E)
    keep = None if capacity is None else s < C
    tx = torch.from_numpy(x).to(tdt)
    disp = mg.dispatch_to_buffers(tx, i, s, keep, E, C)
    assert torch.equal(disp.float(),
                       torch.from_numpy(np.array(rdisp, np.float32)))
    eo = mg.grouped_expert_swiglu(
        disp, *[torch.from_numpy(b).to(tdt) for b in banks])
    out = mg.combine_from_buffers(eo, i, s, w, keep)
    tol = FP32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(eo.float().numpy(),
                               np.asarray(reo, np.float32), **tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **tol)
    if capacity is not None:
        assert not keep.all()


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_reference_and_dense_dispatch(k):
    """The port's grouped ``moe_ffn`` (each expert over its rows only)
    against the reference's dense-dispatch ``moe_ffn`` and against the
    port's own dense dispatch (``N k`` capacity buffers) within fp32
    rounding; a planted tie routes alike."""
    _, x = _gate_inputs(3, n=20, d=16)
    E, D, M = 4, 16, 24
    rng = np.random.RandomState(4)
    gate_t = rng.randn(D, E).astype(np.float32)      # reference: [D, E]
    gate_t[:, 2] = gate_t[:, 0]                     # experts 0, 2 tie
    banks = [rng.randn(E, D, M).astype(np.float32) * 0.2,
             rng.randn(E, D, M).astype(np.float32) * 0.2,
             rng.randn(E, M, D).astype(np.float32) * 0.2]
    want = ref_mg.moe_ffn(jnp.asarray(x), jnp.asarray(gate_t),
                          *map(jnp.asarray, banks), top_k=k)
    tx = torch.from_numpy(x)
    tb = [torch.from_numpy(b) for b in banks]
    gate_w = torch.from_numpy(np.ascontiguousarray(gate_t.T))
    got = mg.moe_ffn(tx, gate_w, *tb, top_k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    w, i, _ = mg.topk_gate(tx @ gate_w.t(), k)
    s, _ = mg.assignment_slots(i, E)
    dense = mg.combine_from_buffers(mg.grouped_expert_swiglu(
        mg.dispatch_to_buffers(tx, i, s, None, E, x.shape[0] * k), *tb),
        i, s, w)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **FP32_TOL)
    # the transposed-view banks the int8 serving path passes
    tv = [b.transpose(1, 2).contiguous().transpose(1, 2) for b in tb]
    assert torch.equal(mg.moe_ffn(tx, gate_w, *tv, top_k=k), got)


def test_expert_parallel_and_sharding_raise(pair):
    """Expert-parallel serving is ported (``tests/test_torch_ep_serving.
    py``): ``moe_ffn``'s ep path takes a rank's ``AxisComm`` and an engine
    mesh a ``ProcessMesh``, anything else raises ``TypeError``; so does
    the sharded ``TrainStep`` (ported: ZeRO over dp, fsdp x tp).
    ``shard_mixtral`` is ported (``tests/test_torch_sharded_moe.py``
    trains it over ranks)."""
    _ref, port = pair
    x = torch.zeros(4, 64)
    blk = port.mixtral.layers[0].block_sparse_moe
    with pytest.raises(TypeError, match="AxisComm"):
        mg.moe_ffn(x, blk.gate.weight, blk.w_gate, blk.w_up, blk.w_down,
                   top_k=2, ep_axis="ep", ep_degree=2)
    for option, kind in (("mesh", "ProcessMesh"),
                         ("sharding", "ShardingConfig")):
        with pytest.raises(TypeError, match=kind):
            ContinuousBatchingEngine(port, max_batch_size=2, num_blocks=8,
                                     block_size=4, device="cpu",
                                     mixed_step=True, **{option: object()})
        with pytest.raises(TypeError, match=kind):
            TrainStep(port, MixtralPretrainingCriterion(port),
                      AdamW(1e-3, parameters=port.named_parameters()),
                      **{option: object()})


# ---------------------------------------------------------------------------
# the eager block and model
# ---------------------------------------------------------------------------
def _block_pair(seed, **kw):
    paddle.seed(seed)
    ref_cfg = ref_tiny_config(**kw)
    ref = RefBlock(ref_cfg)
    cfg = MixtralConfig(**{f: getattr(ref_cfg, f)
                           for f in MixtralConfig.__dataclass_fields__})
    port = MixtralSparseMoeBlock(cfg, device="cpu")
    state = {k: _np(v) for k, v in ref.state_dict().items()}
    with torch.no_grad():
        port.gate.weight.copy_(
            torch.from_numpy(np.array(state["gate.weight"].T)))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(port, name).copy_(
                torch.from_numpy(np.array(state[name])))
    return ref, port


@pytest.mark.parametrize("factor", [0.1, 2.0], ids=["drops", "ample"])
def test_capacity_block_drops_and_aux_match_reference(factor):
    """``tests/test_mixtral.py:107``'s setting (capacity factor 0.1: 3
    slots an expert for 64 tokens) and the default 2.0: the block's output
    and its aux term against the reference's (fp32, 1e-5); at 0.1 most
    assignments drop, and tokens whose both assignments dropped come out
    zero in both."""
    ref, port = _block_pair(5, expert_capacity_factor=factor)
    x = np.random.RandomState(6).randn(2, 32, 64).astype(np.float32)
    want = _np(ref(paddle.to_tensor(x)))
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **FP32_TOL)
    np.testing.assert_allclose(port.l_aux.item(), float(_np(ref.l_aux)),
                               **FP32_TOL)
    assert port.l_aux.item() > 0
    zero_rows = (np.abs(want.reshape(-1, 64)).max(-1) == 0)
    assert zero_rows.any() == (factor < 1)
    assert port.capacity(64) == (3 if factor < 1 else 64)


@pytest.fixture(scope="module")
def eager_tokens(pair):
    """The reference's eager ``generate`` on each prompt."""
    ref, _port = pair
    return [_np(ref.generate(paddle.to_tensor(p[None, :]),
                             max_new_tokens=BUDGET))[0, len(p):].tolist()
            for p in PROMPTS]


def test_tiny_logits_and_eager_tokens_match_reference(pair, eager_tokens):
    """The training forward's logits (1e-5) and the eager ``generate``'s
    tokens (byte-identical) on the reference's prompts."""
    ref, port = pair
    ids = np.random.RandomState(7).randint(0, 256, (2, 24))
    want = _np(ref(paddle.to_tensor(ids)))
    got = port(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert [port.generate(torch.from_numpy(p[None, :]),
                          max_new_tokens=BUDGET)[0, len(p):].tolist()
            for p in PROMPTS] == eager_tokens


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
def _routed(obs):
    fam = obs.default_registry().get("serving_moe_dispatch_tokens_total")
    if fam is None:
        return 0.0, 0.0
    return (fam.labels(fate="routed").value,
            fam.labels(fate="dropped").value)


def _serve(cls, model, **kw):
    """``tests/test_serving_moe.py``'s ``_run``: the first prompt decodes
    alone for a step, then the other two admit."""
    eng = cls(model, max_batch_size=4, num_blocks=64, block_size=4, **kw)
    rids = []
    for i, p in enumerate(PROMPTS):
        rids.append(eng.add_request(p, BUDGET))
        if i == 0:
            eng.step()
    eng.run_to_completion()
    return eng, [list(eng.result(r)) for r in rids]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_tokens_and_dispatch_count_match_reference(pair, eager_tokens,
                                                          engine):
    """Mixed and bucketed split engines: tokens byte-identical to the
    reference's engine and to eager ``generate``; the routed assignments
    the same in both registries (tokens x k x layers on the mixed engine,
    none on the split one, as in the reference), none dropped; the health
    payload the reference's on each of its keys (its engine id aside; the
    port's adds ``weight_quant_bytes``)."""
    ref, port = pair
    kw = ENGINES[engine]
    r0, p0 = _routed(ref_obs), _routed(port_obs)
    ref_eng, want = _serve(RefEngine, ref, **kw)
    r1 = _routed(ref_obs)
    eng, got = _serve(ContinuousBatchingEngine, port, device="cpu", **kw)
    p1 = _routed(port_obs)
    assert got == want == eager_tokens
    assert p1[0] - p0[0] == r1[0] - r0[0]
    if engine == "mixed":
        n_tok = sum(len(p) + BUDGET - 1 for p in PROMPTS)
        assert p1[0] - p0[0] == n_tok * 2 * 2
    assert p1[1] == p0[1] == 0
    mine, theirs = eng.health_payload(), ref_eng.health_payload()
    assert {k: mine[k] for k in theirs if k != "engine_id"} \
        == {k: v for k, v in theirs.items() if k != "engine_id"}


def test_dense_split_engine_matches_eager(pair, eager_tokens):
    """The split engine with the dense prefill runs the eager block
    (capacity N here: nothing drops) and equals eager ``generate``."""
    _ref, port = pair
    _eng, got = _serve(ContinuousBatchingEngine, port, device="cpu")
    assert got == eager_tokens


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bank_ptq_codes_and_scales_bitwise(dtype):
    """An expert bank ``[E, in, out]`` with an all-zero output channel of
    one expert: codes and ``[E, 1, out]`` scales equal the reference's bit
    for bit, and the dequantized bank too."""
    rng = np.random.RandomState(9)
    bank = rng.randn(3, 16, 12).astype(np.float32) * 0.3
    bank[1, :, 5] = 0.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    key = "mixtral.layers.0.block_sparse_moe.w_up"
    want = ref_qf.quantize_param_tree({key: jnp.asarray(bank, jdt)})
    got = qf.quantize_param_tree({key: torch.from_numpy(bank).to(tdt)})
    assert set(got) == set(want)
    assert got[key].dtype == torch.int8
    assert torch.equal(got[key], torch.from_numpy(np.asarray(want[key])))
    assert got[key + SUFFIX].shape == (3, 1, 12)
    assert torch.equal(got[key + SUFFIX],
                       torch.from_numpy(np.asarray(want[key + SUFFIX])))
    assert float(got[key + SUFFIX][1, 0, 5]) == 0.0
    deq = ref_qf.dequantize_param_tree(want, jdt)[key]
    mine = qf.dequantize_weight(got[key], got[key + SUFFIX], tdt)
    assert torch.equal(mine.float(),
                       torch.from_numpy(np.asarray(deq, np.float32)))


def test_engine_int8_tree_and_layer_dequant_bitwise(pair):
    """The engine's int8 tree (each bank's experts transposed in the
    buffer) is the carried reference PTQ tree key for key; each layer's
    one dequant (7 segments: 4 projections and 3 banks, the plain version
    here) equals the reference's whole-tree dequant bit for bit; the
    router stays fp."""
    ref, port = pair
    qtree = ref_qf.quantize_param_tree({k: v._value for k, v in
                                        ref.state_dict().items()})
    carried = ptq_tree_from_paddle_tpu({k: np.asarray(v)
                                        for k, v in qtree.items()})
    want = ref_qf.dequantize_param_tree(qtree, jnp.float32)
    w8 = dq.Int8Weights(port)
    tree = w8.tree()
    assert "mixtral.layers.0.block_sparse_moe.gate.weight" not in tree
    for k, v in tree.items():
        assert torch.equal(v, carried[k]), k
    assert w8.nbytes == sum(v.numel() * v.element_size()
                            for v in tree.values())
    for i in range(port.config.num_hidden_layers):
        assert len(w8.layers[i].segments) == 7
        ws = w8.layer(i)
        for suffix, _w in dq.layer_weights(port.mixtral.layers[i]):
            k = "mixtral.layers.%d.%s" % (i, suffix)
            name = suffix.split(".")[1]
            exp = torch.from_numpy(np.asarray(want[k]))
            assert torch.equal(ws[name], exp if exp.ndim == 3 else exp.T), k
    assert torch.equal(w8.lm_head(),
                       torch.from_numpy(np.asarray(want["lm_head.weight"])).T)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_w8_engine_matches_reference_w8_engine(pair, engine):
    """``weight_quant="int8"``: tokens byte-identical to the reference's
    w8 engine on the same weights; the model's parameters untouched."""
    ref, port = pair
    before = {k: v.clone() for k, v in port.state_dict().items()}
    kw = dict(ENGINES[engine], weight_quant="int8")
    _r, want = _serve(RefEngine, ref, **kw)
    eng, got = _serve(ContinuousBatchingEngine, port, device="cpu", **kw)
    assert got == want
    assert eng.weight_quant_bytes == eng.weight_qtree.nbytes > 0
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
STEPS, LR = 5, 1e-3


def test_train_step_trajectory_matches_reference_eager_loop():
    """``tests/test_mixtral.py:64-86``'s loop (AdamW 1e-3, defaults; CE +
    the router aux of the same forward), five steps on one batch: the
    port's ``TrainStep`` losses within 1e-5 of the reference's eager
    loop, the loss falling, the expert banks moved."""
    ref, port = _pair(seed=0)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (2, 64)).astype(np.int32)
    labels = rs.randint(0, 256, (2, 64)).astype(np.int64)
    crit = RefMixtralCriterion(ref)
    opt = paddle.optimizer.AdamW(LR, parameters=ref.parameters())
    ref.train()
    want = []
    for _ in range(STEPS):
        loss = crit(ref(paddle.to_tensor(ids)), paddle.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss.item()))
    w0 = port.mixtral.layers[0].block_sparse_moe.w_down.detach().clone()
    port.train()
    step = TrainStep(port, MixtralPretrainingCriterion(port),
                     AdamW(LR, parameters=port.named_parameters()))
    got = [step(torch.from_numpy(ids).long(),
                torch.from_numpy(labels)).item() for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    w1 = port.mixtral.layers[0].block_sparse_moe.w_down.detach()
    assert (w1 - w0).abs().max() > 1e-5
    aux = port.router_aux_loss()
    assert torch.isfinite(aux) and aux.item() > 0
