"""KV page migration and the disaggregated router on the port's engines,
on the CPU (``test_serving_migration.py``'s engine tests, at tier-1 size).

``extract_request`` / ``inject_request`` move a running request's pages
between engines as one host ``KVPageBuffer``: the migrated greedy stream
must be byte-identical to the uninterrupted run (fp32 and int8 pools),
both pools leak-free, the injected full pages hit on the target, and
``inject_request``'s errors raised before any side effect.  The wire
format is the reference's: a buffer extracted from the reference's engine
resumes on the port's, and one from the port's on the reference's, on the
same carried weights, byte-identical to the reference's uninterrupted
run.  The router over a prefill and a decode engine (disaggregation) and
a drain after an engine loss resume through inject, with streams equal to
eager ``generate`` and valid span chains.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import ContinuousBatchingEngine as RefEngine

from test_torch_split_serving import _pair
from paddle_tpu_torch.inference.router import ServingRouter
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit import serving_step as ss
from paddle_tpu_torch.observability.request_trace import validate_span_chain
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)

BUDGET = 8


@pytest.fixture(scope="module")
def pair():
    """``llama_tiny_config()``, the reference migration tests' model."""
    return _pair()


def _kw(**kw):
    base = dict(max_batch_size=2, num_blocks=64, block_size=4,
                mixed_step=True, prefill_chunk_size=8,
                enable_prefix_cache=True)
    base.update(kw)
    return base


def _engine(model, **kw):
    return ContinuousBatchingEngine(model, device="cpu", **_kw(**kw))


def _leak_free(eng):
    c0 = eng.caches[0]
    cached = eng.prefix_cache.cached_blocks()
    return (len(c0._free) + len(cached) == c0.num_blocks
            and all(c0.refcount(b) == 1 for b in cached))


def _prompt(model, seed, n=9):
    rng = np.random.RandomState(seed)
    return rng.randint(1, model.config.vocab_size, (n,)).astype(np.int64)


def _generate(model, prompt, n):
    ids = torch.from_numpy(np.asarray(prompt, np.int64))[None]
    return model.generate(ids, n)[0, len(prompt):].tolist()


def _extract_midway(eng, prompt, steps=4):
    rid = eng.add_request(prompt, max_new_tokens=BUDGET)
    for _ in range(steps):
        eng.step()
    p, gen, buf = eng.extract_request(rid)
    assert buf is not None and 0 < len(gen) < BUDGET
    assert buf.n_tokens == len(p) + len(gen) - 1
    return np.concatenate([p, np.asarray(gen, np.int64)]), gen, buf


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_migrated_resume_stream_parity(pair, kv_dtype):
    """extract_request -> inject_request across two engines: the migrated
    stream equals the uninterrupted run, each move is one d2h and one h2d
    copy per dtype, both pools end leak-free, and the injected pages
    re-registered under the digest chain (a same-prefix admission on the
    target hits)."""
    _ref, model = pair
    prompt = _prompt(model, 5)
    e_ref = _engine(model, kv_dtype=kv_dtype)
    rid = e_ref.add_request(prompt, max_new_tokens=BUDGET)
    want = e_ref.run_to_completion()[rid]

    ea = _engine(model, kv_dtype=kv_dtype)
    eb = _engine(model, kv_dtype=kv_dtype)
    t0 = ss.migration_transfers()
    resume, gen, buf = _extract_midway(ea, prompt)
    rid2 = eb.inject_request(resume, buf, max_new_tokens=BUDGET - len(gen))
    t1 = ss.migration_transfers()
    copies = 2 if kv_dtype == "int8" else 1
    assert (t1["d2h"] - t0["d2h"], t1["h2d"] - t0["h2d"]) == (copies,
                                                              copies)
    out = eb.run_to_completion()[rid2]
    assert gen + out == want
    assert eb.prefill_tokens == 0          # zero re-prefill on the target
    assert _leak_free(ea) and _leak_free(eb)
    assert ea.counters["preempts"] == 1
    h0 = eb.prefix_cache.hits
    eb.add_request(resume[:8], max_new_tokens=2)
    eb.run_to_completion()
    assert eb.prefix_cache.hits == h0 + 1


def test_inject_request_validation(pair):
    """ValueError for a request the engine can never hold, RuntimeError
    for transient capacity, both before any side effect; a speculative
    engine extracts nothing and refuses injects."""
    _ref, model = pair
    ea = _engine(model)
    resume, _gen, buf = _extract_midway(ea, _prompt(model, 6), steps=3)

    e8 = _engine(model, kv_dtype="int8")
    free_before = len(e8.caches[0]._free)
    with pytest.raises(ValueError, match="kv_dtype"):
        e8.inject_request(resume, buf, max_new_tokens=4)
    assert len(e8.caches[0]._free) == free_before

    eb = _engine(model)
    with pytest.raises(ValueError, match="n_tokens"):
        eb.inject_request(resume[:-1], buf, max_new_tokens=4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eb.inject_request(resume, buf, max_new_tokens=0)
    with pytest.raises(ValueError, match="KVPageBuffer"):
        eb.inject_request(resume, None, max_new_tokens=4)
    with pytest.raises(ValueError, match="sampling"):
        eb.inject_request(resume, buf, max_new_tokens=4, temperature=0.7)
    assert len(eb.caches[0]._free) == eb.caches[0].num_blocks

    ec = _engine(model, max_batch_size=1)
    ec.add_request(_prompt(model, 7), max_new_tokens=16)
    ec.step()
    free_before = len(ec.caches[0]._free)
    with pytest.raises(RuntimeError, match="free slot"):
        ec.inject_request(resume, buf, max_new_tokens=4)
    assert len(ec.caches[0]._free) == free_before

    from paddle_tpu_torch.models.llama import llama_truncated_draft
    es = _engine(model, draft_model=llama_truncated_draft(model, 1),
                 enable_prefix_cache=False)
    assert es.migration_geometry() is None
    with pytest.raises(ValueError, match="speculative"):
        es.inject_request(resume, buf, max_new_tokens=4)
    rid = es.add_request(_prompt(model, 8), max_new_tokens=8)
    es.step()
    es.step()
    _p, gen, none = es.extract_request(rid)
    assert none is None and gen


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_buffer_migrates_between_the_two_packages(pair, direction):
    """The wire format is the reference's: a request extracted mid-decode
    from one package's engine resumes on the other's, on the same carried
    weights, byte-identical to the reference's uninterrupted run."""
    ref, port = pair
    prompt = _prompt(port, 5)
    e_ref = RefEngine(ref, **_kw())
    rid = e_ref.add_request(prompt, max_new_tokens=BUDGET)
    want = e_ref.run_to_completion()[rid]
    if direction == "reference_to_port":
        src, dst = RefEngine(ref, **_kw()), _engine(port)
    else:
        src, dst = _engine(port), RefEngine(ref, **_kw())
    resume, gen, buf = _extract_midway(src, prompt)
    rid2 = dst.inject_request(resume, buf, max_new_tokens=BUDGET - len(gen))
    assert gen + dst.run_to_completion()[rid2] == want
    assert _leak_free(src) and _leak_free(dst)


def test_int8_pages_cross_bitwise(pair):
    """Over int8 pools the codes and scale rows a reference buffer carries
    land in the port's pool unchanged, and extracting them again gives the
    reference's buffer back bit for bit."""
    ref, port = pair
    src = RefEngine(ref, **_kw(kv_dtype="int8"))
    resume, gen, buf = _extract_midway(src, _prompt(port, 5))
    dst = _engine(port, kv_dtype="int8")
    rid = dst.inject_request(resume, buf, max_new_tokens=BUDGET - len(gen))
    req = next(r for r in dst.slots if r is not None and r.req_id == rid)
    back = ss.extract_blocks(dst.caches, req.block_ids[:buf.n_pages],
                             buf.n_tokens)
    assert back.geometry() == buf.geometry()
    assert np.array_equal(back.codes, np.asarray(buf.codes))
    assert np.array_equal(back.scales, np.asarray(buf.scales))


def test_disagg_router_prefill_to_decode_migration(pair):
    """A prefill engine and a decode engine behind the router: fresh
    prompts start on the prefill engine, their pages migrate after the
    first token, the decode engine prefills nothing, streams equal eager
    ``generate``, span chains hold across the hop, both pools end
    leak-free and the health payloads carry the roles."""
    _ref, model = pair
    pe = _engine(model, max_batch_size=4, role="prefill", engine_id=1900)
    de = _engine(model, max_batch_size=4, role="decode", engine_id=1901)
    router = ServingRouter([pe, de])
    prompts = [_prompt(model, 20 + i) for i in range(3)]
    rids = [router.submit(p, max_new_tokens=BUDGET) for p in prompts]
    out = router.run_to_completion()
    for rid, p in zip(rids, prompts):
        assert out[rid] == _generate(model, p, BUDGET)
        rr = router.finished[rid]
        assert rr.engines_visited() == [1900, 1901]
        assert rr.migrations == 1 == rr.summary["migrations"]
        ok, why = validate_span_chain(router.tracer.events(rid))
        assert ok, (rid, why)
    assert de.prefill_tokens == 0
    assert pe.counters["preempts"] == 3
    assert de.counters["requests_admitted"] == 3
    assert _leak_free(pe) and _leak_free(de)
    assert pe.health_payload()["role"] == "prefill"
    assert de.health_payload()["role"] == "decode"


def test_router_drain_resumes_via_inject(pair):
    """Engine loss mid-decode: the drain extracts the victims' pages and
    the re-dispatch injects them (the dispatch span says migrated=True):
    no drops, streams equal eager ``generate``."""
    _ref, model = pair
    e1 = _engine(model, engine_id=1910)
    e2 = _engine(model, engine_id=1911)
    router = ServingRouter([e1, e2])
    prompts = [_prompt(model, 30 + i) for i in range(3)]
    rids = [router.submit(p, max_new_tokens=BUDGET) for p in prompts]
    for _ in range(4):
        router.step()
    per = {}
    for (eid, _erid) in router._inflight:
        per[eid] = per.get(eid, 0) + 1
    victim = router.handles[max(per, key=per.get)].engine

    def _dead():
        raise RuntimeError("injected engine loss")
    victim.step = _dead
    out = router.run_to_completion()
    injected = 0
    for rid, p in zip(rids, prompts):
        assert out[rid] == _generate(model, p, BUDGET)
        for ev in router.tracer.events(rid):
            if ev[1] == "dispatch" and ev[-1].get("migrated"):
                injected += 1
        ok, why = validate_span_chain(router.tracer.events(rid))
        assert ok, (rid, why)
    assert injected >= 1
    assert _leak_free(e2 if victim is e1 else e1)


def test_preempt_request_and_engine_spans(pair):
    """preempt_request of a waiting and of a running request (KeyError
    for neither), and the engine's own span chain: admit, prefill chunk,
    first token, sampled decode steps, preempt or finish."""
    _ref, model = pair
    eng = _engine(model, max_batch_size=1)
    a = eng.add_request(_prompt(model, 40), max_new_tokens=BUDGET)
    b = eng.add_request(_prompt(model, 41), max_new_tokens=BUDGET)
    for _ in range(3):                         # two chunks, one decode
        eng.step()
    p, gen = eng.preempt_request(b)            # still waiting
    assert gen == [] and len(p) == 9
    p, gen = eng.preempt_request(a)            # running
    assert len(gen) == 2
    with pytest.raises(KeyError):
        eng.preempt_request(a)
    assert not eng.has_work() and not eng.finished
    assert _leak_free(eng)
    kinds = [e[1] for e in eng.tracer.events(a)]
    assert kinds[:4] == ["admit", "prefill_chunk", "prefill_chunk",
                         "first_token"]
    assert "decode_step" in kinds and kinds[-1] == "preempt"
    c = eng.add_request(_prompt(model, 42), max_new_tokens=3)
    eng.run_to_completion()
    assert [e[1] for e in eng.tracer.events(c)][-1] == "finish"
    assert eng.counters == dict(tokens_generated=5, requests_received=3,
                                requests_admitted=2, preempts=2)
