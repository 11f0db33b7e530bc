"""The port's router and request tracing (``inference/router.py``,
``observability``) against the reference's, on the CPU.

Each test is the reference's stub-engine test (``test_serving_router.py``
and ``test_request_trace.py``: in-process stub engines, pure host control
flow) run twice: once over the reference's modules and once over the
port's copies, the two cases of the ``m`` fixture.  The stub engines are
shared; the traced one takes its ``RequestTracer`` from the modules under
test.
"""
import functools
import json
import types

import numpy as np
import pytest

from paddle_tpu.inference import prefix_cache as ref_prefix_cache
from paddle_tpu.inference import router as ref_router
from paddle_tpu.observability import MetricsServer as RefMetricsServer
from paddle_tpu.observability import exporters as ref_exporters
from paddle_tpu.observability import request_trace as ref_trace

from paddle_tpu_torch.inference import prefix_cache as port_prefix_cache
from paddle_tpu_torch.inference import router as port_router
from paddle_tpu_torch.observability import MetricsServer as PortMetricsServer
from paddle_tpu_torch.observability import exporters as port_exporters
from paddle_tpu_torch.observability import request_trace as port_trace


# ---------------------------------------------------------------------------
# stub engines: the minimal engine protocol, deterministic, no device
# ---------------------------------------------------------------------------
class _StubReq:
    def __init__(self, rid, prompt, budget):
        self.req_id = rid
        self.prompt_ids = np.asarray(prompt, np.int64)
        self.output_ids = []
        self.max_new_tokens = budget
        self.t_first_token = 0.0
        self.truncated = False
        self.slot = -1                # -1 while waiting (engine parity)


class _StubEngine:
    """Admits up to `slots` requests, emits one fixed token per running
    request per step; prefix table + free pages are plain knobs so
    routing decisions are directly controllable."""
    block_size = 4

    def __init__(self, engine_id, slots=1, prefix_keys=(),
                 free_pages=100, max_prompt=None):
        self.engine_id = engine_id
        self.max_batch_size = slots
        self.max_prompt = max_prompt
        self.waiting = []
        self.running = []
        self.finished = {}
        self.admitted = []            # req_ids in admission order
        self.free_pages = free_pages
        self.prefix_cache = types.SimpleNamespace(
            table={k: 0 for k in prefix_keys})
        self._next = 0

    def add_request(self, prompt_ids, max_new_tokens=16,
                    eos_token_id=None):
        if self.max_prompt is not None \
                and len(prompt_ids) > self.max_prompt:
            raise ValueError("prompt too long for this engine")
        r = _StubReq(self._next, prompt_ids, max_new_tokens)
        self._next += 1
        self.waiting.append(r)
        return r.req_id

    def has_work(self):
        return bool(self.waiting or self.running)

    def step(self):
        while self.waiting and len(self.running) < self.max_batch_size:
            r = self.waiting.pop(0)
            r.slot = len(self.running)
            self.running.append(r)
            self.admitted.append(r.req_id)
        done = []
        for r in list(self.running):
            r.output_ids.append(7)
            if len(r.output_ids) >= r.max_new_tokens:
                self.running.remove(r)
                self.finished[r.req_id] = r
                done.append(r.req_id)
        return done

    def preempt_request(self, rid):
        for q in (self.waiting, self.running):
            for r in list(q):
                if r.req_id == rid:
                    q.remove(r)
                    r.slot = -1
                    return r.prompt_ids, list(r.output_ids)
        raise KeyError(rid)

    def health_payload(self):
        return {"engine_id": self.engine_id,
                "occupancy": len(self.running),
                "slots": self.max_batch_size,
                "waiting": len(self.waiting),
                "free_pages": self.free_pages, "total_pages": 100,
                "chunk_queue_depth": 0}


class _TracedStubEngine:
    """``test_request_trace.py``'s stub: the same protocol with a tracer
    of its own (the real engine's default-on contract), so fleet_trace
    has engine lanes to merge."""
    block_size = 4

    def __init__(self, engine_id, slots=1, tracer_cls=None):
        self.engine_id = engine_id
        self.max_batch_size = slots
        self.waiting = []
        self.running = []
        self.finished = {}
        self.prefix_cache = None
        self.tracer = tracer_cls()
        self._next = 0

    def add_request(self, prompt_ids, max_new_tokens=16,
                    eos_token_id=None):
        r = _StubReq(self._next, prompt_ids, max_new_tokens)
        self._next += 1
        self.waiting.append(r)
        self.tracer.event(r.req_id, "enqueue")
        return r.req_id

    def has_work(self):
        return bool(self.waiting or self.running)

    def step(self):
        import time
        while self.waiting and len(self.running) < self.max_batch_size:
            r = self.waiting.pop(0)
            r.slot = len(self.running)
            self.running.append(r)
        done = []
        t = time.perf_counter()
        for r in list(self.running):
            r.output_ids.append(7)
            if len(r.output_ids) == 1:
                r.t_first_token = t
            self.tracer.sample_span(r.req_id, "decode_step",
                                    t - 1e-4, t, every=1)
            if len(r.output_ids) >= r.max_new_tokens:
                self.running.remove(r)
                self.finished[r.req_id] = r
                self.tracer.event(r.req_id, "finish",
                                  tokens=len(r.output_ids))
                done.append(r.req_id)
        return done

    def preempt_request(self, rid):
        for q in (self.waiting, self.running):
            for r in list(q):
                if r.req_id == rid:
                    q.remove(r)
                    r.slot = -1
                    self.tracer.event(rid, "preempt",
                                      tokens=len(r.output_ids))
                    return r.prompt_ids, list(r.output_ids)
        raise KeyError(rid)

    def health_payload(self):
        return {"engine_id": self.engine_id,
                "occupancy": len(self.running),
                "slots": self.max_batch_size,
                "waiting": len(self.waiting),
                "free_pages": 100, "total_pages": 100,
                "chunk_queue_depth": 0}


def _modules(router, trace, exporters, prefix_cache, server):
    return types.SimpleNamespace(
        ServingRouter=router.ServingRouter,
        EngineHandle=router.EngineHandle,
        RouterQueueFull=router.RouterQueueFull,
        load_score=router.load_score, routing_keys=router.routing_keys,
        RequestTracer=trace.RequestTracer, NULL_TRACER=trace.NULL_TRACER,
        resolve_tracer=trace.resolve_tracer,
        LatencyReservoir=trace.LatencyReservoir,
        fleet_trace=trace.fleet_trace,
        validate_span_chain=trace.validate_span_chain,
        healthz_payload=exporters.healthz_payload,
        _prefix_key=prefix_cache._prefix_key, MetricsServer=server,
        TracedStub=functools.partial(_TracedStubEngine,
                                     tracer_cls=trace.RequestTracer))


@pytest.fixture(params=["reference", "port"])
def m(request):
    """The modules under test: the reference's or the port's."""
    if request.param == "reference":
        return _modules(ref_router, ref_trace, ref_exporters,
                        ref_prefix_cache, RefMetricsServer)
    return _modules(port_router, port_trace, port_exporters,
                    port_prefix_cache, PortMetricsServer)


# ---------------------------------------------------------------------------
# test_serving_router.py's stub tests
# ---------------------------------------------------------------------------
def test_routing_key_and_load_score(m):
    """routing_keys == the PrefixPageCache digest chain; load_score is
    monotone in each pressure axis."""
    P = np.arange(1, 11, dtype=np.int64)          # 10 tokens, bs 4
    keys = m.routing_keys(P, 4)
    assert keys == [m._prefix_key(P, 4), m._prefix_key(P, 8)]
    idle = {"occupancy": 0, "slots": 4, "waiting": 0,
            "free_pages": 100, "total_pages": 100,
            "chunk_queue_depth": 0}
    assert m.load_score(idle) == 0.0
    for k, v in (("occupancy", 2), ("waiting", 1),
                 ("free_pages", 10), ("chunk_queue_depth", 3)):
        assert m.load_score({**idle, k: v}) > 0.0
    assert m.load_score({}) == 0.0                  # thin payloads route


def test_affinity_pick_beats_load_and_falls_back_least_loaded(m):
    """A prompt whose prefix pages live on a busier engine still routes
    there; a no-match prompt goes least-loaded."""
    P = np.arange(1, 13, dtype=np.int64)
    keys = m.routing_keys(P, 4)
    e0 = _StubEngine(0, slots=4, prefix_keys=keys[:2], free_pages=20)
    e1 = _StubEngine(1, slots=4, free_pages=100)   # emptier, no prefix
    router = m.ServingRouter([e0, e1])
    a = router.submit(P, max_new_tokens=1)
    router.step()
    assert e0.admitted and not e1.admitted        # affinity won
    assert router.finished[a].routed_by_prefix
    # no-match prompt: least-loaded fallback picks the emptier engine
    q = np.arange(50, 62, dtype=np.int64)
    b = router.submit(q, max_new_tokens=1)
    router.step()
    assert e1.admitted
    assert not router.finished[b].routed_by_prefix


def test_affinity_holds_for_full_engine_then_spills(m):
    """A matching request HOLDS while its affinity target is full
    (bounded), instead of instantly recomputing the prefix elsewhere."""
    P = np.arange(1, 13, dtype=np.int64)
    keys = m.routing_keys(P, 4)
    e0 = _StubEngine(0, slots=1, prefix_keys=keys)
    e1 = _StubEngine(1, slots=1)
    router = m.ServingRouter([e0, e1], affinity_wait_steps=100)
    blocker = router.submit(np.arange(90, 94, dtype=np.int64),
                            max_new_tokens=5)
    router.step()                                  # blocker runs on e0?
    # force the blocker onto e0 regardless of tie-breaks
    if not e0.running:
        e0, e1 = e1, e0
    hit = router.submit(P, max_new_tokens=1)
    router.step()
    assert router.pending and router.pending[0].rid == hit  # holding
    assert not e1.admitted or e1.admitted == []   # never spilled
    router.run_to_completion()
    assert router.finished[hit].routed_by_prefix
    assert router.finished[blocker].requeues == 0  # equal pri: no preempt


def test_priority_order_and_preempt_requeue(m):
    """Admission drains highest-priority-first; a high-priority request
    preempts a strictly-lower-priority running one through the public
    preempt API, and the victim resumes with its tokens re-prefixed."""
    e = _StubEngine(0, slots=1)
    router = m.ServingRouter([e])
    lo = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=6,
                       priority=0)
    router.step()                                 # lo runs, has 1 token
    mid = router.submit(np.arange(8, 12, dtype=np.int64),
                        max_new_tokens=1, priority=2)
    hi = router.submit(np.arange(20, 24, dtype=np.int64),
                       max_new_tokens=1, priority=5)
    router.step()
    # hi preempted lo (never mid: it outranks lo only), lo is pending
    assert [rr.rid for rr in router.pending if rr.rid == lo]
    assert all(rr.rid != hi for rr in router.pending)   # hi dispatched
    out = router.run_to_completion()
    f_lo = router.finished[lo]
    assert f_lo.requeues == 1
    # the victim's pre-preemption token was re-prefixed, not lost:
    # total output still exactly its budget
    assert len(out[lo]) == 6
    assert len(out[hi]) == 1 and len(out[mid]) == 1
    # hi admitted before mid, mid before lo's re-admission
    order = e.admitted
    assert order.index(router.finished[hi].engine_req_id) \
        < order.index(router.finished[mid].engine_req_id)


def test_tpot_target_shields_victim_and_ttft_zero_is_urgent(m):
    """Among equal-priority victims the one WITHOUT a TPOT target is
    preempted; ttft_target=0.0 means maximal urgency, not 'no
    deadline'."""
    e = _StubEngine(0, slots=2)
    router = m.ServingRouter([e])
    slo = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=8,
                        priority=0, tpot_target=0.01)
    free = router.submit(np.arange(8, 12, dtype=np.int64),
                         max_new_tokens=8, priority=0)
    router.step()
    hi = router.submit(np.arange(20, 24, dtype=np.int64),
                       max_new_tokens=1, priority=5)
    router.step()
    # the no-target request was the victim, the TPOT-target one kept
    # its slot
    reqs = {rr.rid: rr for rr in router.pending}
    assert free in reqs and slo not in reqs
    router.run_to_completion()
    assert len(router.result(free)) == 8 and len(router.result(slo)) == 8
    assert len(router.result(hi)) == 1
    # ttft_target=0.0 sorts AHEAD of an unconstrained equal-priority
    # peer (deadline=now vs inf)
    a = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=1)
    b = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=1,
                      ttft_target=0.0)
    router.run_to_completion()
    order = e.admitted
    assert order.index(router.finished[b].engine_req_id) \
        < order.index(router.finished[a].engine_req_id)


def test_bounded_queue_and_health_gauge(m):
    e = _StubEngine(0, slots=1)
    router = m.ServingRouter([e], max_pending=1)
    router.submit(np.arange(4, dtype=np.int64), max_new_tokens=2)
    with pytest.raises(m.RouterQueueFull):
        router.submit(np.arange(4, dtype=np.int64), max_new_tokens=2)
    router.step()          # dispatch + first token, request in flight
    # probe failure (payload raises) drains the engine and zeroes the
    # health gauge; recover_engine re-admits
    def _boom():
        raise OSError("probe down")
    e.health_payload = _boom
    router.step()
    h = router.handles[0]
    assert not h.healthy
    assert router.pending and router.pending[0].requeues == 1
    e.health_payload = lambda: {"slots": 1}
    router.recover_engine(0)
    assert router.handles[0].healthy
    out = router.run_to_completion()
    assert all(len(v) == 2 for v in out.values())


def test_out_of_band_completion_surfaces_in_next_step(m):
    """A request completed during a drain (engine died with the final
    token already in its host state) must show up in step()'s returned
    rid list — never silently land only in `finished`."""
    e = _StubEngine(0, slots=1)
    router = m.ServingRouter([e])
    a = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=2)
    router.step()                       # one token, in flight
    rr = next(iter(router._inflight.values()))
    rr.engine_req.output_ids.append(7)  # budget met inside the dying step
    def _dead():
        raise RuntimeError("boom")
    def _gone(rid):
        raise KeyError(rid)             # raced with completion
    e.step = _dead
    e.preempt_request = _gone
    done = router.step()                # drain -> out-of-band complete
    assert done == [a]
    assert router.result(a) == [7, 7]


def test_unplaceable_request_never_preempts(m):
    """A request no engine's geometry can hold must not churn running
    victims through pointless preemptions; run_to_completion fails
    loudly once nothing else is in flight."""
    e0 = _StubEngine(0, slots=1, max_prompt=4)
    e1 = _StubEngine(1, slots=1, max_prompt=4)
    router = m.ServingRouter([e0, e1])
    lo = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=3,
                       priority=0)
    router.step()
    big = router.submit(np.arange(10, dtype=np.int64), max_new_tokens=2,
                        priority=9)
    for _ in range(2):
        router.step()
    assert router.finished.get(lo) is None \
        or router.finished[lo].requeues == 0
    out_lo = router.finished.get(lo)
    with pytest.raises(RuntimeError, match="fit no engine"):
        router.run_to_completion()
    assert router.finished[lo].requeues == 0      # victim untouched
    assert len(router.finished[lo].output_ids) == 3
    assert big not in router.finished
    del out_lo


def test_affinity_geometry_rejection_reranks_before_preempting(m):
    """The affinity engine matching a prompt rejects it on geometry:
    the request must re-rank onto another engine's FREE slot, never
    preempt a victim while open capacity exists."""
    P = np.arange(1, 13, dtype=np.int64)
    a = _StubEngine(0, slots=2, prefix_keys=m.routing_keys(P, 4),
                    max_prompt=4)          # matches, but can't hold P
    b = _StubEngine(1, slots=2)            # free slot + a running victim
    router = m.ServingRouter([a, b])
    lo = router.submit(np.arange(90, 94, dtype=np.int64),
                       max_new_tokens=6, priority=0)
    router.step()
    hi = router.submit(P, max_new_tokens=2, priority=5)
    out = router.run_to_completion()
    assert len(out[hi]) == 2 and len(out[lo]) == 6
    assert router.finished[lo].requeues == 0     # victim untouched
    assert router.finished[hi].engine_id == 1    # spilled to b's slot


def test_finished_retention_pop_result_and_anonymous_engines(m):
    """finished is a bounded record (oldest evicted past max_finished,
    pop_result consumes); engines without an engine_id attribute get
    distinct fallback ids instead of colliding at 0."""
    class _Anon(_StubEngine):
        def __init__(self, slots):
            super().__init__(0, slots=slots)
            del self.engine_id         # protocol-minimal pool member

        def health_payload(self):
            return {"occupancy": len(self.running),
                    "slots": self.max_batch_size,
                    "waiting": len(self.waiting),
                    "free_pages": 100, "total_pages": 100,
                    "chunk_queue_depth": 0}
    e0, e1 = _Anon(slots=2), _Anon(slots=2)
    router = m.ServingRouter([e0, e1], max_finished=2)
    assert len(router.handles) == 2    # distinct fallback ids
    rids = [router.submit(np.arange(4, dtype=np.int64),
                          max_new_tokens=1) for _ in range(3)]
    router.run_to_completion()
    assert len(router.finished) == 2
    assert rids[0] not in router.finished      # oldest evicted
    assert router.pop_result(rids[2]) == [7]
    assert rids[2] not in router.finished
    # the router consumed the ENGINE-side records too — neither layer
    # retains per-request state without bound
    assert not e0.finished and not e1.finished


def test_healthz_payload_merge_keeps_bare_contract(m):
    """/healthz body: status ok always; provider dict merged; a broken
    provider degrades to the bare payload instead of failing a probe."""
    assert m.healthz_payload() == {"status": "ok"}
    body = m.healthz_payload(lambda: {"engine_id": 3, "occupancy": 1,
                                    "status": "evil"})
    assert body["status"] == "ok"                 # liveness field ours
    assert body["engine_id"] == 3 and body["occupancy"] == 1
    def _boom():
        raise RuntimeError("stats broke")
    assert m.healthz_payload(_boom) == {"status": "ok"}


def test_engine_handle_scrapes_healthz_http(m):
    """EngineHandle(health_url=...) reads load from the upgraded
    /healthz JSON body — no Prometheus text parsing."""
    e = _StubEngine(0, slots=3)
    e.add_request(np.arange(4, dtype=np.int64), max_new_tokens=99)
    e.step()
    # numpy scalars in the payload must not break the endpoint (the
    # handler serializes with default=str and falls back to bare-ok)
    provider = lambda: {**e.health_payload(),          # noqa: E731
                        "np_field": np.int64(3)}
    srv = m.MetricsServer(port=0, addr="127.0.0.1",
                        health_provider=provider).start()
    try:
        h = m.EngineHandle(e, health_url="http://127.0.0.1:%d/healthz"
                                       % srv.port)
        p = h.payload()
        assert p["status"] == "ok" and p["occupancy"] == 1
        assert p["slots"] == 3 and p["engine_id"] == 0
        assert h.probe() and m.load_score(p) > 0.0
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# test_request_trace.py's stub tests
# ---------------------------------------------------------------------------


def test_tracer_bounds_sampling_and_stub(m):
    tr = m.RequestTracer(max_requests=3, max_events_per_request=20)
    for rid in range(5):
        tr.event(rid, "enqueue", ts=1.0)
    # oldest REQUESTS evicted at the cap
    assert tr.request_ids() == [2, 3, 4]
    # per-request cap with a LIFECYCLE RESERVE: bulk spans stop at
    # max_events - 16 total entries (here 4), so after a span flood
    # the finish/preempt instants still land; past the FULL cap even
    # instants drop — counted, never appended
    for i in range(10):
        tr.span(4, "decode_step", 1.0 + i, 1.1 + i)
    assert len(tr.events(4)) == 4             # enqueue + 3 spans
    assert tr.dropped() == 7
    tr.event(4, "finish", ts=99.0)            # lifecycle: still records
    kinds = [e[1] for e in tr.events(4)]
    assert kinds[-1] == "finish"
    for i in range(40):                       # flood instants to the cap
        tr.event(4, "requeue", ts=float(i))
    assert len(tr.events(4)) == 20            # hard cap holds
    # sample_span records every Nth but counts every call
    tr2 = m.RequestTracer()
    for i in range(10):
        tr2.sample_span(0, "decode_step", float(i), float(i) + 0.5,
                        every=4)
    assert tr2.kind_count(0, "decode_step") == 10
    recorded = [e for e in tr2.events(0) if e[1] == "decode_step"]
    assert len(recorded) == 3                 # samples 0, 4, 8
    assert [e[4]["sample_index"] for e in recorded] == [0, 4, 8]
    # entries carry chrome phases and args
    ph, kind, t0, t1, args = recorded[0]
    assert ph == "X" and t1 - t0 == pytest.approx(0.5)
    # the no-op stub swallows everything and resolve_tracer wires it
    assert m.resolve_tracer(False) is m.NULL_TRACER
    assert not m.NULL_TRACER.enabled
    m.NULL_TRACER.event(0, "enqueue")
    m.NULL_TRACER.span(0, "x", 0.0, 1.0)
    assert m.NULL_TRACER.events(0) == [] and m.NULL_TRACER.request_ids() == []
    shared = m.RequestTracer()
    assert m.resolve_tracer(shared) is shared
    with pytest.raises(TypeError):
        m.resolve_tracer("yes")


def test_latency_reservoir_bounded_and_deterministic(m):
    res = m.LatencyReservoir(capacity=8, seed=3)
    for v in range(100):
        res.add(float(v))
    assert res.count == 100
    d = res.digest()
    assert d["count"] == 100 and d["window"] == 8
    assert 0.0 <= d["p50"] <= 99.0 and d["p50"] <= d["p95"] <= d["p99"]
    # deterministic for a fixed insertion order (seeded Algorithm R)
    res2 = m.LatencyReservoir(capacity=8, seed=3)
    for v in range(100):
        res2.add(float(v))
    assert res2.digest() == d
    assert m.LatencyReservoir(capacity=4).digest()["p50"] is None


def test_span_chain_across_preempt_requeue_and_slo_arithmetic(m):
    """The tentpole contract on stubs: a preempted-and-requeued victim
    keeps a gap-free chain (pending/on_engine spans tile submit..done,
    every hop re-dispatched), and for each SLO kind the attainment
    outcomes sum to completed admissions."""
    e = m.TracedStub(0, slots=1)
    router = m.ServingRouter([e])
    lo = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=6,
                       priority=0, ttft_target=10.0, tpot_target=10.0)
    router.step()                             # lo runs, has 1 token
    hi = router.submit(np.arange(20, 24, dtype=np.int64),
                       max_new_tokens=1, priority=5,
                       ttft_target=0.0)       # deadline=now: missed
    no_slo = router.submit(np.arange(30, 34, dtype=np.int64),
                           max_new_tokens=1)
    out = router.run_to_completion()
    assert len(out[lo]) == 6                  # preempted, zero loss
    f_lo = router.finished[lo]
    assert f_lo.requeues == 1

    # --- chains: every dispatched request validates gap-free ---------
    for rid in (lo, hi, no_slo):
        ok, why = m.validate_span_chain(router.tracer.events(rid))
        assert ok, f"rid {rid}: {why}"
    kinds = [ev[1] for ev in router.tracer.events(lo)]
    assert kinds.count("dispatch") == 2       # the requeue hop re-dispatched
    assert kinds.count("requeue") == 1
    assert kinds.count("on_engine") == 2
    req_ev = next(ev for ev in router.tracer.events(lo)
                  if ev[1] == "requeue")
    assert req_ev[4]["reason"] == "preempt" and req_ev[4]["engine"] == 0

    # --- the validator actually rejects holes ------------------------
    broken = [ev for ev in router.tracer.events(lo)
              if ev[1] != "on_engine"]
    ok, why = m.validate_span_chain(broken)
    assert not ok and "on_engine" in why
    ok, why = m.validate_span_chain([])
    assert not ok

    # --- SLO arithmetic ----------------------------------------------
    snap = router.slo_snapshot()
    for kind in ("ttft", "tpot"):
        total = sum(snap[kind][o]
                    for o in ("attained", "missed", "no_target"))
        assert total == 3                     # = completed admissions
    assert snap["ttft"]["missed"] >= 1        # the 0.0-deadline request
    assert snap["ttft"]["attained"] >= 1      # the 10s-target victim
    assert snap["tpot"]["no_target"] == 2     # hi (1 token) + no_slo
    assert router.finished[hi].summary["slo"]["ttft"] == "missed"
    assert router.finished[lo].summary["slo"]["ttft"] == "attained"
    # digests live in the health payload
    hp = router.health_payload()
    assert hp["slo"]["ttft"]["count"] == 3
    assert hp["slo"]["ttft"]["p50"] is not None


def test_summary_on_finished_records_and_pop_record(m):
    """streaming callers read ttft/tpot/requeues/engines off
    the finished record; pop_result keeps its tokens-only contract."""
    e = m.TracedStub(0, slots=2)
    router = m.ServingRouter([e])
    a = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=3)
    router.run_to_completion()
    rr = router.finished[a]
    s = rr.summary
    assert s["tokens"] == 3 and s["requeues"] == 0
    assert s["engines_visited"] == [0]
    assert s["ttft"] is not None and s["ttft"] >= 0
    assert s["mean_tpot"] is not None and s["mean_tpot"] >= 0
    assert s["slo"] == {"ttft": "no_target", "tpot": "no_target"}
    # pop_record consumes the full record, pop_result just the tokens
    rec = router.pop_record(a)
    assert rec is rr and a not in router.finished
    b = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=2)
    router.run_to_completion()
    assert router.pop_result(b) == [7, 7]
    assert b not in router.finished


def test_finished_eviction_keeps_summaries_bounded(m):
    """Regression: the bounded-`finished` eviction still
    holds with summaries attached — old records (and their summaries)
    leave, recent ones keep theirs."""
    e = m.TracedStub(0, slots=2)
    router = m.ServingRouter([e], max_finished=3)
    rids = [router.submit(np.arange(4, dtype=np.int64),
                          max_new_tokens=1) for _ in range(7)]
    router.run_to_completion()
    assert len(router.finished) == 3
    assert list(router.finished) == rids[-3:]
    assert all(router.finished[r].summary is not None
               for r in rids[-3:])


def test_tracer_off_router_and_engine_still_serve(m):
    """tracer=False drops to the no-op stub everywhere: identical
    results, zero recorded events (the overhead bench's control arm)."""
    e = m.TracedStub(0, slots=1)
    router = m.ServingRouter([e], tracer=False)
    assert router.tracer is m.NULL_TRACER
    a = router.submit(np.arange(4, dtype=np.int64), max_new_tokens=2)
    out = router.run_to_completion()
    assert out[a] == [7, 7]
    assert router.tracer.events(a) == []
    # SLO accounting is independent of the tracer
    snap = router.slo_snapshot()
    assert sum(snap["ttft"].get(o, 0)
               for o in ("attained", "missed", "no_target")) == 1


def test_fleet_trace_merges_groups_and_flow_links(m, tmp_path):
    """fleet_trace writes ONE valid chrome JSON: router + one track
    group per engine, request lanes renamed to fleet rids, and a flow
    s/f pair chaining a lost-engine requeue across engines."""
    e0, e1 = m.TracedStub(0, slots=2), m.TracedStub(1, slots=2)
    router = m.ServingRouter([e0, e1])
    rids = [router.submit(np.arange(i, i + 6, dtype=np.int64),
                          max_new_tokens=4) for i in range(4)]
    router.step()
    # kill whichever engine holds work so its requests hop across
    victim = next(h.engine for h in router.handles.values()
                  if any(k[0] == h.engine_id for k in router._inflight))

    def _dead():
        raise RuntimeError("boom")
    victim.step = _dead
    victim_id = next(h.engine_id for h in router.handles.values()
                     if h.engine is victim)
    router.mark_unhealthy(victim_id)      # drain: requests now PENDING
    # mid-incident trace — drained requests sit in router.pending with
    # closed hops; their engine lanes must already be renamed to rids
    mid = m.fleet_trace(str(tmp_path / "mid.json"), router)
    assert mid["requests"] == len(rids)
    mid_data = json.load(open(str(tmp_path / "mid.json")))
    drained = [rr.rid for rr in router.pending if rr.hops]
    assert drained
    lanes = {e["args"]["name"] for e in mid_data["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "req %d" % drained[0] in lanes
    out = router.run_to_completion()
    assert all(len(out[r]) == 4 for r in rids)
    hopped = [r for r in rids
              if len(set(router.finished[r].engines_visited())) > 1]
    assert hopped                               # >=1 cross-engine hop

    path = str(tmp_path / "fleet.json")
    stats = m.fleet_trace(path, router)
    assert stats["engine_groups"] == 2
    assert stats["cross_engine_links"] >= 1
    data = json.load(open(path))
    assert data["displayTimeUnit"] == "ms"
    evs = data["traceEvents"]
    groups = {e["args"]["name"] for e in evs
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert "router" in groups
    assert {"engine 0", "engine 1"} <= groups
    # flow pair: same id/name, "s" and "f", different pids
    flows = [e for e in evs if e.get("cat") == "flow"]
    assert flows
    by_id = {}
    for f in flows:
        by_id.setdefault(f["id"], []).append(f)
    linked = [fs for fs in by_id.values()
              if {f["ph"] for f in fs} == {"s", "f"}
              and len({f["pid"] for f in fs}) == 2]
    assert linked
    s_ev = next(f for f in linked[0] if f["ph"] == "s")
    f_ev = next(f for f in linked[0] if f["ph"] == "f")
    assert f_ev["ts"] >= s_ev["ts"]             # arrow points forward
    assert f_ev.get("bp") == "e"
    # a hopped request keeps ONE lane id (the fleet rid) on BOTH
    # engine pids: its engine-local ids were renamed
    rid = hopped[0]
    pids_with_lane = {e["pid"] for e in evs
                      if e.get("ph") == "M" and e.get("name") == "thread_name"
                      and e["args"]["name"] == "req %d" % rid}
    assert len(pids_with_lane) >= 3             # router + both engines
