"""The port's serving slice against the JAX reference, on the CPU.

The tiny models carry the reference's weights (``load_paddle_tpu_weights``),
so the eager forward, greedy ``generate`` and the mixed-step engine can be
compared with ``paddle_tpu`` token for token.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import (
    ContinuousBatchingEngine as RefEngine,
    GenerationRequest as RefRequest)
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config

from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                GenerationRequest)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           param_count)
from paddle_tpu_torch.testing.parity import (load_paddle_tpu_weights,
                                             state_from_paddle_tpu)
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

# the reference serving tests' _tiny_model (tests/test_serving.py)
TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=128, intermediate_size=128)
# the churn workload of test_mixed_step_parity_compile_bound_under_churn
CHURN_PROMPTS = [np.array([7, 9, 2], np.int64),
                 np.array([3, 14, 15, 92, 65], np.int64),
                 np.arange(1, 11, dtype=np.int64)]
CHURN_BUDGETS = [4, 4, 4]


def _ref_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def _pair(seed=0, **kw):
    """(reference model, port model with the reference's weights)."""
    paddle.seed(seed)
    ref_cfg = ref_tiny_config(**kw)
    ref = RefLlama(ref_cfg)
    ref.eval()
    cfg = LlamaConfig(**{f: getattr(ref_cfg, f)
                         for f in LlamaConfig.__dataclass_fields__})
    port = LlamaForCausalLM(cfg, device="cpu")
    load_paddle_tpu_weights(port, _ref_state(ref))
    return ref, port


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair(**TINY)


def _ref_generate(ref, prompt, n):
    out = ref.generate(paddle.to_tensor(prompt[None, :]), max_new_tokens=n)
    return np.asarray(out._value)[0, len(prompt):].tolist()


def _port_generate(port, prompt, n):
    return port.generate(torch.from_numpy(prompt)[None], n)[
        0, len(prompt):].tolist()


def test_tiny_logits_match_reference(tiny_pair):
    """The forward without caches (the training path: rope fused into
    flash attention) returns the logits alone, as the reference does."""
    ref, port = tiny_pair
    ids = np.random.RandomState(0).randint(0, 128, (2, 11)).astype(np.int64)
    want = np.asarray(ref(paddle.to_tensor(ids))._value)
    got = port(torch.from_numpy(ids))
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5)
    assert param_count(port.config) == sum(p.numel()
                                           for p in port.parameters())


def test_tiny_logits_with_cache_match_reference(tiny_pair):
    """The cache path (prefill, then one token at an offset)."""
    ref, port = tiny_pair
    ids = np.random.RandomState(1).randint(0, 128, (1, 7)).astype(np.int64)
    caches = [(None, None)] * 2
    want, rc = ref(paddle.to_tensor(ids), caches=caches)
    got, pc = port(torch.from_numpy(ids), [(None, None)] * 2)
    nxt = np.asarray([[5]], np.int64)
    want2, _ = ref(paddle.to_tensor(nxt), caches=rc, position_offset=7)
    got2, _ = port(torch.from_numpy(nxt), pc, position_offset=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2._value),
                               rtol=0, atol=1e-5)


def test_weight_loader_checks_keys_both_ways(tiny_pair):
    ref, port = tiny_pair
    state = _ref_state(ref)
    mapped = state_from_paddle_tpu(state)
    assert set(mapped) == set(port.state_dict())
    w = state["llama.layers.0.self_attn.k_proj.weight"]
    assert tuple(mapped["llama.layers.0.self_attn.k_proj.weight"].shape) \
        == w.T.shape
    missing = dict(state)
    missing.pop("llama.norm.weight")
    with pytest.raises(KeyError, match="llama.norm.weight"):
        load_paddle_tpu_weights(port, missing)
    extra = dict(state, **{"llama.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="llama.extra.weight"):
        load_paddle_tpu_weights(port, extra)


@pytest.mark.parametrize("idx", range(len(CHURN_PROMPTS)))
def test_greedy_generate_byte_identical_to_reference(tiny_pair, idx):
    ref, port = tiny_pair
    p = CHURN_PROMPTS[idx]
    assert _port_generate(port, p, 6) == _ref_generate(ref, p, 6)


def _run_churn(eng, add):
    r0 = add(CHURN_PROMPTS[0], CHURN_BUDGETS[0])
    eng.step()                          # r0 decoding alone
    r1 = add(CHURN_PROMPTS[1], CHURN_BUDGETS[1])
    r2 = add(CHURN_PROMPTS[2], CHURN_BUDGETS[2])
    eng.run_to_completion()             # chunks packed WITH r0's decode
    return [eng.result(r) for r in (r0, r1, r2)]


def test_engine_churn_matches_eager_and_reference_engine(tiny_pair):
    """Staggered admission, a chunked long prompt riding along with a
    running decode: tokens byte-identical to the port's eager generate
    AND to the reference's mixed-step engine; budgets seen bounded by the
    budget set; a second wave adds none; no page leaked."""
    ref, port = tiny_pair
    want = [_port_generate(port, p, n)
            for p, n in zip(CHURN_PROMPTS, CHURN_BUDGETS)]
    kw = dict(max_batch_size=4, num_blocks=64, block_size=4,
              mixed_step=True, prefill_chunk_size=4)
    eng = ContinuousBatchingEngine(port, device="cpu", **kw)
    assert eng.token_budgets == (4, 8)
    got = _run_churn(eng, eng.add_request)
    ref_eng = RefEngine(ref, **kw)
    ref_got = _run_churn(ref_eng, ref_eng.add_request)
    assert got == want
    assert got == ref_got
    assert eng.mixed.total_compiles <= len(eng.token_budgets)
    pre = eng.mixed.total_compiles
    r3 = eng.add_request(CHURN_PROMPTS[0], CHURN_BUDGETS[0])
    eng.run_to_completion()
    assert eng.result(r3) == want[0]
    assert eng.mixed.total_compiles == pre
    cache = eng.caches[0]
    assert sorted(cache._free + [cache.sink]) == list(range(65))


def test_engine_slot_reuse_and_eos(tiny_pair):
    """More requests than slots cycle through a small pool; an EOS token
    ends its request early; every page returns."""
    _, port = tiny_pair
    prompts = [np.array([i + 1, i + 2, i + 3], np.int64) for i in range(4)]
    want = [_port_generate(port, p, 6) for p in prompts]
    eng = ContinuousBatchingEngine(port, max_batch_size=2, num_blocks=8,
                                   block_size=4, prefill_chunk_size=4,
                                   mixed_step=True, device="cpu")
    eos = want[3][2]
    rids = [eng.add_request(p, 6) for p in prompts[:3]]
    rids.append(eng.add_request(prompts[3], 6, eos_token_id=eos))
    eng.run_to_completion()
    for rid, w in zip(rids[:3], want[:3]):
        assert eng.result(rid) == w
    last = eng.result(rids[3])
    assert last == want[3][:want[3].index(eos) + 1]
    assert len(eng.caches[0]._free) == 8


def _span_fill(eng, Req, block_ids, spans_spec):
    """Span tuples for ``_fill_mixed_pack`` from (tokens, start, page)
    specs, with the given engine's request class: ``(req, tokens, start,
    n_draft, seed_xor, masked)`` in both engines."""
    out = []
    for i, (toks, start) in enumerate(spans_spec):
        r = Req(req_id=i, prompt_ids=np.zeros(1, np.int64))
        r.block_ids = list(block_ids[i])
        toks = np.asarray(toks, np.int32)
        out.append((r, toks, start, 0, 0, False))
    return out


def test_pack_layout_equals_reference(tiny_pair):
    """The one packed int32 host operand (4T + S*(W+4)) is filled
    identically by both engines for the same spans."""
    ref, port = tiny_pair
    kw = dict(max_batch_size=4, num_blocks=32, block_size=4,
              max_seq_len=24, mixed_step=True, prefill_chunk_size=4)
    eng = ContinuousBatchingEngine(port, device="cpu", **kw)
    ref_eng = RefEngine(ref, **kw)
    pages = [[3, 7], [0, 1, 2, 9], [5]]
    spec = [([11], 5), ([4, 5, 6, 7], 9), ([1, 2, 3], 0)]
    got, B = eng._fill_mixed_pack(eng.mixed, eng.token_budgets,
                                  _span_fill(eng, GenerationRequest,
                                             pages, spec))
    want, B_ref = ref_eng._fill_mixed_pack(
        ref_eng.mixed, ref_eng.token_budgets,
        _span_fill(ref_eng, RefRequest, pages, spec))
    assert B == B_ref == 8
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape == (4 * 8 + 4 * (6 + 4),)
    np.testing.assert_array_equal(got, want)
    for T in eng.token_budgets:
        a = eng.mixed.new_pack(T)
        b = ref_eng.mixed.new_pack(T)
        assert [x.shape for x in a] == [x.shape for x in b]
