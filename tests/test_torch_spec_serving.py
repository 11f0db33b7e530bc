"""The port's sampling and speculative engines against the reference's,
on the CPU.

The engines carry the reference's weights (``testing/parity.py``), and a
draft made by ``llama_truncated_draft`` on each side copies its target,
so the two drafts carry the same weights too.  The sampling epilogue
draws the reference's random bits (``tests/test_torch_sampling.py``), so
sampled token streams are compared byte for byte: the mixed and split
engines, and the speculative engine greedy and sampled.  Also mirrored
from ``tests/test_serving_sampling.py``'s tier-1 tests: the pack layout
and the construction-time errors, seeded replay under batching churn,
and greedy speculative output equal to non-speculative greedy with the
pool whole afterwards.
"""
import pytest
import torch

from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine
from paddle_tpu.models.llama import llama_truncated_draft as ref_draft

from test_torch_split_serving import (CHURN_PROMPTS, TINY, _leak_free,
                                      _pair)
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit.serving_step import MixedStep
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           llama_truncated_draft)

BUDGET = 6
# per request of the churn: a filtered sampled one, a greedy one (both
# branches share a step) and a temperature-only one
KNOBS = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1),
         dict(temperature=0.0),
         dict(temperature=1.0, seed=3)]
MIXED = dict(max_batch_size=4, num_blocks=64, block_size=4,
             mixed_step=True, prefill_chunk_size=4)
SPLIT = dict(max_batch_size=4, num_blocks=64, block_size=4,
             prefill_buckets="auto", prefill_chunk_size=4)


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair(**TINY)


def _churn(eng, knobs, budget=BUDGET):
    """r0 alone for a step, then r1 and r2 (the long prompt chunks while
    the others decode), run to completion."""
    r0 = eng.add_request(CHURN_PROMPTS[0], budget, **knobs[0])
    eng.step()
    r1 = eng.add_request(CHURN_PROMPTS[1], budget, **knobs[1])
    r2 = eng.add_request(CHURN_PROMPTS[2], budget, **knobs[2])
    eng.run_to_completion()
    return [eng.result(r) for r in (r0, r1, r2)]


def _port(port, draft=False, **kw):
    if draft:
        kw["draft_model"] = llama_truncated_draft(port, 1)
    return ContinuousBatchingEngine(port, device="cpu", **kw)


def _ref(ref, draft=False, **kw):
    if draft:
        kw["draft_model"] = ref_draft(ref, 1)
    return RefEngine(ref, **kw)


@pytest.mark.parametrize("engine", ["mixed", "split"])
def test_sampled_streams_byte_identical_to_reference(tiny_pair, engine):
    """The sampled mixed and split engines give the reference engine's
    tokens, request for request, with sampled and greedy requests
    sharing steps; both engines give the same streams (the counter is
    the sampled token's position in either)."""
    ref, port = tiny_pair
    kw = dict(MIXED if engine == "mixed" else SPLIT, sampling=True)
    got = _churn(_port(port, **kw), KNOBS)
    assert got == _churn(_ref(ref, **kw), KNOBS)
    other = dict(SPLIT if engine == "mixed" else MIXED, sampling=True)
    assert got == _churn(_port(port, **other), KNOBS)


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_spec_streams_byte_identical_to_reference(tiny_pair, sampled):
    """The speculative engine (a 1-layer truncated draft, spec_k 2) gives
    the reference's speculative engine's tokens, greedy and sampled, with
    the same count of accepted drafts; the pools come back whole."""
    ref, port = tiny_pair
    kw = dict(MIXED, sampling=sampled, spec_k=2)
    knobs = KNOBS if sampled else [{}] * 3
    eng = _port(port, draft=True, **kw)
    got = _churn(eng, knobs)
    assert got == _churn(_ref(ref, draft=True, **kw), knobs)
    assert _leak_free(eng)
    assert 0 < eng.spec_accepted <= eng.spec_proposed


def test_greedy_spec_equals_non_spec_greedy(tiny_pair):
    """Greedy speculative output equals the port's non-speculative greedy
    output byte for byte (staggered admission, a chunked prompt riding
    along, spec_k 1..3), with the budgets seen bounded by each step's set
    and every page back in the pool; the draft pools share the page ids
    and hold no allocator of their own."""
    _, port = tiny_pair
    want = _churn(_port(port, **MIXED), [{}] * 3)
    assert want == _churn(_port(port), [{}] * 3)       # the split engine
    for k in (1, 2, 3):
        eng = _port(port, draft=True, spec_k=k, **MIXED)
        assert _churn(eng, [{}] * 3) == want
        assert eng.mixed.total_compiles <= len(eng.token_budgets)
        assert eng.draft_step.total_compiles <= len(eng.draft_budgets)
        assert eng.decode_step.compile_count == 0
        assert _leak_free(eng)
        assert len(eng.draft_caches[0]._free) == 64


def test_seeded_request_replays_alone_and_batched(tiny_pair):
    """A sampled request's tokens depend on its seed and positions only:
    alone, batched with churn (other requests admitted and finishing
    around it) and through the other engine, the same stream; another
    seed diverges; greedy requests in a sampling engine equal eager
    ``generate``."""
    _, port = tiny_pair
    p, knobs = CHURN_PROMPTS[1], dict(temperature=0.7, top_k=20,
                                      top_p=0.9, seed=5)
    alone = _port(port, sampling=True, **MIXED)
    rid = alone.add_request(p, 8, **knobs)
    alone.run_to_completion()
    want = alone.result(rid)
    for kw in (MIXED, SPLIT):
        eng = _port(port, sampling=True, **kw)
        r0 = eng.add_request(CHURN_PROMPTS[2], 3, temperature=1.0, seed=9)
        eng.step()
        r1 = eng.add_request(p, 8, **knobs)
        eng.step()
        rg = eng.add_request(CHURN_PROMPTS[0], 4)
        r2 = eng.add_request(p, 8, **dict(knobs, seed=6))
        eng.run_to_completion()
        assert eng.result(r1) == want
        assert eng.result(r2) != want
        assert eng.result(rg) == port.generate(
            torch.from_numpy(CHURN_PROMPTS[0])[None], 4)[0, 3:].tolist()
        assert len(eng.result(r0)) == 3
    spec = _port(port, draft=True, sampling=True, **MIXED)
    rid = spec.add_request(p, 8, **knobs)
    spec.run_to_completion()
    assert len(spec.result(rid)) == 8 and _leak_free(spec)


def test_lazy_spec_rolls_back_rejected_pages(tiny_pair):
    """Lazy allocation under speculation: the pages grown for draft
    positions the verifier rejects go back to the pool after every round
    (each running request holds exactly the pages its tokens need), the
    tokens equal the reference's lazy speculative engine's, and the pool
    is whole afterwards."""
    ref, port = tiny_pair
    kw = dict(MIXED, lazy_alloc=True, spec_k=3)
    eng = _port(port, draft=True, **kw)
    held = []
    r0 = eng.add_request(CHURN_PROMPTS[0], 9)
    r1 = eng.add_request(CHURN_PROMPTS[1], 9)
    while eng.has_work():
        eng.step()
        for r in eng.slots:
            if r is not None and r.state == "running":
                need = eng.caches[0].blocks_needed(r.seq_len + 1)
                held.append(len(r.block_ids) - need)
    assert held and all(h == 0 for h in held)
    assert eng.spec_proposed > eng.spec_accepted    # some pages rolled back
    got = [eng.result(r0), eng.result(r1)]
    re = _ref(ref, draft=True, **kw)
    rr = [re.add_request(CHURN_PROMPTS[0], 9),
          re.add_request(CHURN_PROMPTS[1], 9)]
    re.run_to_completion()
    assert got == [re.result(r) for r in rr]
    assert _leak_free(eng)


def test_sampling_defaults_and_validation(tiny_pair):
    """The pack layout (4 descriptor columns by default, + 4 knob columns
    under sampling, + 1 n_draft column under spec) and the reference's
    construction-time errors."""
    _, port = tiny_pair
    eng = _port(port, **MIXED)
    assert eng.mixed.row_extra == 4
    _, _, span = eng.mixed.new_pack(eng.token_budgets[0])
    assert span.shape[1] == eng.bt_width + 4
    assert _port(port, sampling=True, **MIXED).mixed.row_extra == 8
    spec = _port(port, draft=True, sampling=True, **MIXED)
    assert spec.mixed.row_extra == 9 and spec.draft_step.row_extra == 8
    assert spec.token_budgets[0] >= MIXED["max_batch_size"] * 3
    with pytest.raises(ValueError, match="compiled prefill"):
        _port(port, sampling=True, max_batch_size=2, num_blocks=8,
              block_size=4)
    with pytest.raises(ValueError, match="mixed_step=True"):
        _port(port, draft=True, **SPLIT)
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        _port(port, draft=True, spec_k=0, **MIXED)
    other = LlamaForCausalLM(llama_tiny_config(**dict(TINY, vocab_size=96,
                                                      num_hidden_layers=1)),
                             device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        _port(port, draft_model=other, **MIXED)
    with pytest.raises(ValueError, match="sampling engine"):
        eng.add_request(CHURN_PROMPTS[0], 2, temperature=0.5)
    with pytest.raises(ValueError, match="n must be >= 1"):
        eng.add_request(CHURN_PROMPTS[0], 2, n=0)
    caches = eng.caches
    with pytest.raises(ValueError, match="return_probs"):
        MixedStep(port, caches, eng.bt_width, 2, 4, return_probs=True)
    with pytest.raises(ValueError, match="verifier"):
        MixedStep(port, caches, eng.bt_width, 2, 4, sampling=True,
                  spec_k=2, return_probs=True)
    with pytest.raises(ValueError, match="span_q=2"):
        MixedStep(port, caches, eng.bt_width, 2, 2, spec_k=2)
    with pytest.raises(ValueError, match="strict layer truncation"):
        llama_truncated_draft(port, 2)
