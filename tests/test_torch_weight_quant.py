"""The port's weight PTQ (``weight_quant="int8"``) against the JAX
reference, on the CPU.

The PTQ tree (``quantization.functional.quantize_param_tree``) must give
the reference's codes and scales bit for bit, transposed to the port's
``[out, in]`` layout; the dequant expression and the engine's per-layer
dequant (``ops/dequant.py``, the kernel's plain version on the CPU) the
reference's whole-tree ``dequantize_param_tree`` bit for bit.  The w8
engines' fp32 greedy tokens equal the reference engine's with
``weight_quant="int8"`` on the same weights (``testing/parity.py``); over
int8 pools, where the port reads pages through the int8 kernels' math and
the reference's CPU engine dequantizes them, they equal the port's own
engine on the dequantized weights exactly and the reference's at the kv8
gate.  The model's parameters stay untouched.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.quantization import functional as ref_qf

from test_torch_split_serving import KV8_THRESHOLD, _match_rate, _pair
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.ops import dequant as dq
from paddle_tpu_torch.quantization import functional as qf
from paddle_tpu_torch.testing.parity import (ptq_tree_from_paddle_tpu,
                                             state_from_paddle_tpu)
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

SUFFIX = qf.WEIGHT_SCALE_SUFFIX
ENGINES = {"mixed": dict(mixed_step=True, prefill_chunk_size=8),
           "split": dict(prefill_buckets="auto", prefill_chunk_size=8)}


@pytest.fixture(scope="module")
def pair():
    """The reference quantization tests' model (``llama_tiny_config()``),
    on which int8 weights move greedy tokens."""
    return _pair()


def _ref_tree(ref_model):
    return {k: t._value for k, t in ref_model.state_dict().items()}


def _np_state(rng, dtype):
    """A small serving state dict in the reference's layout: projections
    ``[in, out]`` (one all-zero output channel), an embedding and a
    norm."""
    w = rng.randn(16, 12).astype(np.float32) * 0.05
    w[:, 3] = 0.0
    st = {"llama.layers.0.self_attn.q_proj.weight": w,
          "llama.layers.0.mlp.down_proj.weight":
              rng.randn(12, 16).astype(np.float32) * 3.0,
          "lm_head.weight": rng.randn(16, 40).astype(np.float32),
          "llama.embed_tokens.weight": rng.randn(40, 16).astype(np.float32),
          "llama.norm.weight": rng.rand(16).astype(np.float32)}
    return {k: jnp.asarray(v, dtype) for k, v in st.items()}


def _to_torch(a):
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ptq_codes_and_scales_bitwise(dtype):
    """Codes and scales equal the reference's, transposed, including an
    all-zero channel (zero codes, zero scale); 1-D and embedding entries
    pass through unchanged."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    st = _np_state(np.random.RandomState(0), jdt)
    want = ref_qf.quantize_param_tree(st)
    port_in = {k: (_to_torch(v).T.contiguous() if qf.ptq_quantizable(k, v)
                   else _to_torch(v)).to(tdt) for k, v in st.items()}
    got = qf.quantize_param_tree(port_in)
    assert set(got) == set(want)
    for k, v in want.items():
        if qf.is_weight_scale_key(k):
            assert got[k].dtype == torch.float32
            assert torch.equal(got[k], torch.from_numpy(np.array(v))), k
        elif k + SUFFIX in want:
            assert got[k].dtype == torch.int8
            assert torch.equal(got[k].T, torch.from_numpy(np.array(v))), k
        else:
            assert got[k] is port_in[k], k
    q = "llama.layers.0.self_attn.q_proj.weight"
    assert float(got[q + SUFFIX][3]) == 0.0
    assert not got[q][3].any()
    # the carried reference tree is the port's tree
    carried = ptq_tree_from_paddle_tpu(
        {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                       else v) for k, v in want.items()})
    for k, v in got.items():
        assert torch.equal(carried[k].to(v.dtype), v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_param_tree_bitwise(dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    st = _np_state(np.random.RandomState(1), jnp.float32)
    want = ref_qf.dequantize_param_tree(ref_qf.quantize_param_tree(st), jdt)
    port_in = {k: (_to_torch(v).T.contiguous() if qf.ptq_quantizable(k, v)
                   else _to_torch(v)) for k, v in st.items()}
    got = qf.dequantize_param_tree(qf.quantize_param_tree(port_in), tdt)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        w = _to_torch(v)
        if k.endswith("proj.weight") or k == "lm_head.weight":
            assert g.dtype == tdt
            w = w.T
        assert torch.equal(g.float(), w.float()), k


def test_per_layer_dequant_bitwise_to_the_reference_tree(pair):
    """The engine's int8 tree (built one layer at a time) is the carried
    reference PTQ tree, and each layer's dequant (the kernel's plain
    version, one call a layer into the reused scratch) and the LM head's
    equal the reference's whole-tree dequant bit for bit."""
    ref, port = pair
    qtree = ref_qf.quantize_param_tree(_ref_tree(ref))
    carried = ptq_tree_from_paddle_tpu({k: np.asarray(v)
                                        for k, v in qtree.items()})
    want = ref_qf.dequantize_param_tree(qtree, jnp.float32)
    w8 = dq.Int8Weights(port)
    tree = w8.tree()
    for k, v in tree.items():
        assert torch.equal(v, carried[k]), k
    assert w8.nbytes == sum(v.numel() * v.element_size()
                            for v in tree.values())
    before = dq.dequant_int8.launches
    scratch = w8._scratch.data_ptr()
    for i in range(port.config.num_hidden_layers):
        ws = w8.layer(i)
        assert ws["q_proj"].data_ptr() == scratch     # the one scratch
        for mod, name in dq.LAYER_PROJECTIONS:
            k = "llama.layers.%d.%s.%s.weight" % (i, mod, name)
            assert torch.equal(ws[name], _to_torch(want[k]).T), k
    assert torch.equal(w8.lm_head(), _to_torch(want["lm_head.weight"]).T)
    assert dq.dequant_int8.launches == before


def test_dequant_plain_odd_width_and_bad_inputs():
    """The plain version at a width that is no multiple of the vector
    (``[37, 100]``) beside a second segment, against the expression; the
    wrapper's checks."""
    g = torch.Generator().manual_seed(0)
    segs = [(37, 100), (5, 16)]
    n = sum(r * c for r, c in segs)
    codes = torch.randint(-127, 128, (n,), generator=g).to(torch.int8)
    scales = torch.rand(42, generator=g) * 3
    for dt in (torch.float32, torch.bfloat16):
        out = dq.dequant_int8(codes, scales, segs,
                              torch.empty(n + 7, dtype=dt))
        a = (codes[:3700].view(37, 100).float()
             * (scales[:37] / 127)[:, None]).to(dt)
        b = (codes[3700:].view(5, 16).float()
             * (scales[37:] / 127)[:, None]).to(dt)
        assert torch.equal(out[:n], torch.cat([a.reshape(-1),
                                               b.reshape(-1)]))
    with pytest.raises(ValueError, match="scales"):
        dq.dequant_int8(codes, scales[:-1], segs, torch.empty(n))
    with pytest.raises(ValueError, match="int8"):
        dq.dequant_int8(codes.float(), scales, segs, torch.empty(n))


def _staggered(eng, prompts, budgets):
    rids = [eng.add_request(prompts[0], budgets[0])]
    eng.step()
    rids += [eng.add_request(p, b) for p, b in zip(prompts[1:], budgets[1:])]
    eng.run_to_completion()
    return [eng.result(r) for r in rids]


PROMPT_LENS = (5, 3, 8, 11)
BUDGETS = (12, 12, 12, 12)


def _prompts(vocab):
    rng = np.random.RandomState(7)
    return [rng.randint(1, vocab, (n,)).astype(np.int64)
            for n in PROMPT_LENS]


def _twin(port, eng):
    """The dequantized twin: a copy of the model whose projection weights
    are the engine's dequantized int8 tree."""
    twin = copy.deepcopy(port)
    deq = qf.dequantize_param_tree(eng.weight_qtree.tree(),
                                   port.config.torch_dtype)
    with torch.no_grad():
        for k, p in twin.named_parameters():
            if k in deq:
                p.copy_(deq[k])
    return twin


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_w8_engine_tokens_equal_the_reference_engine(pair, engine):
    """fp32 greedy tokens of the w8 engine byte-identical to the reference
    engine's with ``weight_quant="int8"`` and to the port's fp engine on
    the dequantized twin; int8 weights move at least one token against the
    fp engine (the tree is really used).  ``weight_quant_bytes`` counts
    codes and scales and rides the health payload."""
    ref, port = pair
    prompts = _prompts(port.config.vocab_size)
    kw = dict(max_batch_size=4, num_blocks=64, block_size=4,
              **ENGINES[engine])
    want = _staggered(RefEngine(ref, weight_quant="int8", **kw), prompts,
                      BUDGETS)
    eng = ContinuousBatchingEngine(port, device="cpu", weight_quant="int8",
                                   **kw)
    got = _staggered(eng, prompts, BUDGETS)
    assert got == want
    twin = _staggered(ContinuousBatchingEngine(_twin(port, eng),
                                               device="cpu", **kw),
                      prompts, BUDGETS)
    assert got == twin
    fp = _staggered(ContinuousBatchingEngine(port, device="cpu", **kw),
                    prompts, BUDGETS)
    assert got != fp
    cfg = port.config
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    kv = cfg.num_key_value_heads * h // cfg.num_attention_heads
    codes = L * (2 * h * h + 2 * h * kv + 3 * h * i) + cfg.vocab_size * h
    scales = L * (2 * h + 2 * kv + 2 * i + h) + cfg.vocab_size
    assert eng.weight_quant_bytes == codes + 4 * scales
    assert eng.health_payload()["weight_quant_bytes"] == codes + 4 * scales


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_w8_kv8_engine(pair, engine):
    """w8 over int8 pools: byte-identical to the port's kv8 engine on the
    dequantized twin; against the reference's w8 + kv8 engine (which
    dequantizes its pages on the CPU) at the kv8 gate."""
    ref, port = pair
    prompts = _prompts(port.config.vocab_size)
    kw = dict(max_batch_size=4, num_blocks=64, block_size=4,
              kv_dtype="int8", **ENGINES[engine])
    eng = ContinuousBatchingEngine(port, device="cpu", weight_quant="int8",
                                   **kw)
    got = _staggered(eng, prompts, BUDGETS)
    twin = _staggered(ContinuousBatchingEngine(_twin(port, eng),
                                               device="cpu", **kw),
                      prompts, BUDGETS)
    assert got == twin
    want = _staggered(RefEngine(ref, weight_quant="int8", **kw), prompts,
                      BUDGETS)
    assert _match_rate(got, want) >= KV8_THRESHOLD


def test_w8_prefix_cache_cow(pair):
    """``test_serving_quant.py::test_w8_kv8_prefix_cow_end_to_end``'s
    flow over fp32 pools: a whole-prompt hit (copy-on-write) and a
    suffix hit on the w8 prefix engine, token for token the reference's
    w8 prefix engine, with its counters."""
    ref, port = pair
    P = np.array([5, 17, 42, 7, 99, 3, 11, 23], np.int64)
    B = np.concatenate([P, [77, 8]])

    def script(eng):
        ra = eng.add_request(P, 6)
        eng.run_to_completion()
        rb = eng.add_request(B, 6)
        rc = eng.add_request(P, 6)
        eng.run_to_completion()
        pc = eng.prefix_cache
        return ([eng.result(r) for r in (ra, rb, rc)],
                (pc.hits, pc.misses, pc.hit_tokens))
    kw = dict(max_batch_size=2, num_blocks=32, block_size=4,
              enable_prefix_cache=True, weight_quant="int8",
              mixed_step=True, prefill_chunk_size=4)
    want = script(RefEngine(ref, **kw))
    got = script(ContinuousBatchingEngine(port, device="cpu", **kw))
    assert got == want
    assert got[1] == (2, 1, 8 + 7)


def test_quant_construction_errors(pair):
    """``test_serving_quant.py::test_quant_construction_errors`` on the
    port: the same errors, at construction."""
    _ref, model = pair
    base = dict(max_batch_size=4, num_blocks=64, block_size=4, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatchingEngine(model, kv_dtype="int4", mixed_step=True,
                                 **base)
    with pytest.raises(ValueError, match="compiled prefill"):
        ContinuousBatchingEngine(model, kv_dtype="int8", **base)
    with pytest.raises(ValueError, match="compiled prefill"):
        ContinuousBatchingEngine(model, weight_quant="int8", **base)
    with pytest.raises(ValueError, match="weight_quant"):
        ContinuousBatchingEngine(model, weight_quant="fp8",
                                 mixed_step=True, **base)
    with pytest.raises(ValueError, match="single-chip"):
        ContinuousBatchingEngine(model, quant_collectives=True,
                                 mixed_step=True, **base)


def test_model_untouched_and_eager_generate_unchanged(pair):
    """A w8 engine never writes the model's parameters: after it served,
    every parameter is bitwise what it was and an eager ``generate``
    equals one before it."""
    _ref, port = pair
    prompts = _prompts(port.config.vocab_size)
    ids = torch.from_numpy(prompts[3])[None]
    before_gen = port.generate(ids, 8)
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    eng = ContinuousBatchingEngine(port, device="cpu", weight_quant="int8",
                                   max_batch_size=4, num_blocks=64,
                                   block_size=4, mixed_step=True)
    _staggered(eng, prompts, BUDGETS)
    for k, p in port.named_parameters():
        assert torch.equal(p, before[k]), k
    assert torch.equal(port.generate(ids, 8), before_gen)


def test_expert_bank_ptq_not_ported():
    """A 3-D expert bank (no longer refused: the port serves Mixtral)
    quantizes per expert and output channel, as the reference does: an
    all-zero bank gives zero codes and zero ``[E, 1, out]`` scales
    (``tests/test_torch_mixtral.py`` holds the codes bitwise to the
    reference's); the reference's rule for what is quantizable otherwise
    holds."""
    bank = torch.zeros(2, 4, 6)
    key = "llama.layers.0.block_sparse_moe.w_up"
    assert qf.ptq_quantizable(key, bank)
    assert not qf.ptq_quantizable("llama.embed_tokens.weight",
                                  torch.zeros(4, 4))
    assert not qf.ptq_quantizable("lm_head.weight" + SUFFIX,
                                  torch.zeros(4))
    tree = qf.quantize_param_tree({key: bank})
    assert tree[key].dtype == torch.int8 and not tree[key].any()
    assert tree[key + SUFFIX].shape == (2, 1, 6)
    assert not tree[key + SUFFIX].any()


def test_carried_state_round_trip(pair):
    """``ptq_tree_from_paddle_tpu`` keeps the fp entries as
    ``state_from_paddle_tpu`` maps them."""
    ref, _port = pair
    st = {k: np.asarray(v) for k, v in _ref_tree(ref).items()}
    qtree = {k: np.asarray(v)
             for k, v in ref_qf.quantize_param_tree(st).items()}
    carried = ptq_tree_from_paddle_tpu(qtree)
    fp = state_from_paddle_tpu(st)
    assert torch.equal(carried["llama.embed_tokens.weight"],
                       fp["llama.embed_tokens.weight"])
    assert carried["lm_head.weight"].shape == fp["lm_head.weight"].shape
