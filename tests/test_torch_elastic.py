"""The port's elastic actuator (``paddle_tpu_torch/inference/
elastic.py``) against the reference's, on the CPU.

The reference's stub tests (``test_elastic_serving.py``: a
migration-capable stub engine behind the real router and capacity plane;
which action fires, in what order things drain, what the fates and
gauges say) each run twice, over the reference's modules and over the
port's copies — the two cases of the ``m`` fixture.  Then the drill of
``tools/bench_elastic.py``'s ``bench_elastic_drill`` on real tiny port
engines in process: overload -> ``scale_up`` from a warmed standby, idle
-> ``scale_down``, then a forced drain with every request mid-decode:
zero drops, every fate ``"migrated"``, no prompt token prefilled twice,
streams byte-identical to eager ``generate``.
"""
import functools
import time
import types

import numpy as np
import pytest
import torch

from paddle_tpu.inference import elastic as ref_elastic
from paddle_tpu.inference import prefix_cache as ref_prefix_cache
from paddle_tpu.inference import router as ref_router
from paddle_tpu import observability as ref_obs
from paddle_tpu.observability import capacity as ref_capacity

from paddle_tpu_torch.inference import elastic as port_elastic
from paddle_tpu_torch.inference import prefix_cache as port_prefix_cache
from paddle_tpu_torch.inference import router as port_router
from paddle_tpu_torch import observability as port_obs
from paddle_tpu_torch.observability import capacity as port_capacity
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)


@pytest.fixture(params=["reference", "port"])
def m(request):
    """The modules under test: the reference's or the port's."""
    el, pc, rt, obs, cap = (
        (ref_elastic, ref_prefix_cache, ref_router, ref_obs, ref_capacity)
        if request.param == "reference" else
        (port_elastic, port_prefix_cache, port_router, port_obs,
         port_capacity))
    return types.SimpleNamespace(
        ElasticController=el.ElasticController,
        ServingRouter=rt.ServingRouter,
        CapacityConfig=cap.CapacityConfig,
        FleetCapacityMonitor=cap.FleetCapacityMonitor,
        default_registry=obs.default_registry,
        Stub=functools.partial(_MigStubEngine, tier_cls=pc.HostPageTier))


GEO = (2, 4, 1, 8, "f32")


class _Req:
    def __init__(self, rid, prompt, budget, eos=None):
        self.req_id = rid
        self.prompt_ids = np.asarray(prompt, np.int64)
        self.output_ids = []
        self.max_new_tokens = budget
        self.eos_token_id = eos
        self.t_first_token = 0.0
        self.truncated = False
        self.slot = -1
        self.state = "waiting"


class _Buf:
    """Stand-in for a host KVPageBuffer: geometry + token coverage."""

    def __init__(self, geometry, n_tokens):
        self._geo = tuple(geometry)
        self.n_tokens = int(n_tokens)
        self.nbytes = 16 * max(1, self.n_tokens)

    def geometry(self):
        return self._geo


class _MigStubEngine:
    """The capacity-test stub plus the migration protocol; its host tier
    is the ``HostPageTier`` of the package under test."""
    block_size = 4

    def __init__(self, engine_id, slots=2, geometry=GEO,
                 tier_cls=None):
        self.engine_id = engine_id
        self.max_batch_size = slots
        self.geometry_tuple = tuple(geometry) if geometry else None
        self.waiting = []
        self.running = []
        self.slots_list = self.running      # _dispatch scans .slots
        self.finished = {}
        self.prefix_cache = None
        self.host_tier = tier_cls(capacity_bytes=1 << 20)
        self.tokens = 0
        self.injected = 0
        self._next = 0

    # _dispatch looks the injected live request up on engine.slots
    @property
    def slots(self):
        return self.running

    def add_request(self, prompt_ids, max_new_tokens=16,
                    eos_token_id=None):
        r = _Req(self._next, prompt_ids, max_new_tokens,
                 eos=eos_token_id)
        self._next += 1
        self.waiting.append(r)
        return r.req_id

    def inject_request(self, prompt_ids, buffer, max_new_tokens=16,
                       eos_token_id=None):
        if buffer is None or buffer.geometry() != self.geometry_tuple:
            raise ValueError("pool geometry mismatch")
        if len(self.running) >= self.max_batch_size:
            raise RuntimeError("no free slot")
        r = _Req(self._next, prompt_ids, max_new_tokens,
                 eos=eos_token_id)
        self._next += 1
        r.state = "running"
        r.slot = len(self.running)
        self.running.append(r)
        self.injected += 1
        return r.req_id

    def migration_geometry(self):
        return self.geometry_tuple

    def extract_request(self, req_id):
        for r in list(self.running):
            if r.req_id == req_id:
                self.running.remove(r)
                r.slot = -1
                buf = _Buf(self.geometry_tuple,
                           len(r.prompt_ids) + len(r.output_ids) - 1) \
                    if self.geometry_tuple else None
                return r.prompt_ids, list(r.output_ids), buf
        raise KeyError(req_id)

    def has_work(self):
        return bool(self.waiting or self.running)

    def step(self):
        while self.waiting and len(self.running) < self.max_batch_size:
            r = self.waiting.pop(0)
            r.slot = len(self.running)
            r.state = "running"
            self.running.append(r)
        done = []
        for r in list(self.running):
            r.output_ids.append(int(r.prompt_ids[-1]) + len(r.output_ids))
            self.tokens += 1
            if len(r.output_ids) >= r.max_new_tokens:
                self.running.remove(r)
                r.state = "finished"
                self.finished[r.req_id] = r
                done.append(r.req_id)
        return done

    def health_payload(self):
        return {"engine_id": self.engine_id,
                "occupancy": len(self.running),
                "slots": self.max_batch_size,
                "waiting": len(self.waiting),
                "free_pages": 100, "total_pages": 100,
                "chunk_queue_depth": 0,
                "counters": {"tokens_generated": self.tokens,
                             "requests_admitted": self._next}}


def _pool(m, n=2, slots=1, capacity=None, **kw):
    cfg = capacity or m.CapacityConfig(min_dwell=2, halflife_s=0.001,
                                       sample_every=1)
    engines = [m.Stub(i, slots=slots) for i in range(n)]
    return m.ServingRouter(engines, capacity=cfg, **kw), engines


def _plan_stub(router, action, **extra):
    """Pin the router's committed plan — decision→action tests drive
    the actuator, not the (separately tested) planner."""
    evals = router.capacity.planner.evaluations
    plan = {"action": action, "evaluations": evals + 1}
    plan.update(extra)
    router.capacity_plan = lambda: plan
    return plan


def test_controller_requires_capacity_plane(m):
    engines = [m.Stub(0)]
    router = m.ServingRouter(engines, capacity=None)
    with pytest.raises(ValueError):
        m.ElasticController(router)


def test_steady_plan_is_a_no_op(m):
    router, _ = _pool(m)
    ctl = m.ElasticController(router, cooldown_steps=0)
    _plan_stub(router, "steady")
    assert ctl.step() is None
    assert ctl.actions == []
    assert len(router.handles) == 2


def test_scale_up_admits_warms_and_sheds(m):
    """Overload → real planner says scale_up → the controller admits
    the standby engine, copies hot host-tier pages into it, and sheds
    decode work off the hottest peer so pages migrate over."""
    router, engines = _pool(m, n=2, slots=1)
    # hot prefix families live on the (about to be hottest) peer
    for i in range(4):
        engines[0].host_tier.put(b"k%d" % i, _Buf(GEO, 4))
    cold = m.Stub(7, slots=4)
    ctl = m.ElasticController(router, standby=[cold], cooldown_steps=2,
                            warm_pages=3)
    rng = np.random.RandomState(0)
    for _ in range(8):
        router.submit(rng.randint(1, 50, (8,)).astype(np.int64),
                      max_new_tokens=8)
    for _ in range(3):
        router.step()
        if router.capacity_plan()["action"] == "scale_up":
            break
    assert router.capacity_plan()["action"] == "scale_up"
    assert ctl.step() == "scale_up"
    assert set(router.handles) == {0, 1, 7}
    # warmed: capped at warm_pages, keys identical, hottest first
    assert len(cold.host_tier.entries) == 3
    assert set(cold.host_tier.entries) <= set(engines[0].host_tier.entries)
    _evals, action, detail = ctl.actions[-1]
    assert action == "scale_up" and detail["engine"] == 7
    assert detail["warmed_pages"] == 3
    # cooldown: the very next calls are holds, no double-admit
    assert ctl.step() is None and ctl.step() is None
    # the pool drains to completion through the newcomer — zero drops
    out = router.run_to_completion()
    assert len(out) == 8
    assert all(len(toks) == 8 for toks in out.values())
    snap = m.default_registry().snapshot()
    series = snap["elastic_actions_total"]["series"]
    acted = {s["labels"]["action"]: s["value"] for s in series}
    assert acted.get("scale_up", 0) >= 1
    pool = snap["router_engine_pool_size"]["series"][0]["value"]
    assert pool == 3.0


def test_scale_down_drains_with_migrated_fates(m):
    """The victim's in-flight requests travel with their KV (fate=
    migrated for every extractable request), the pool shrinks, and
    every stream still completes its full budget — zero drops."""
    router, engines = _pool(m, n=3, slots=2)
    rids = [router.submit(np.arange(1, 9, dtype=np.int64) * (i + 1),
                          max_new_tokens=6) for i in range(4)]
    router.step()            # dispatch + first token everywhere
    victims = {eid for eid, _ in router._inflight}
    assert victims           # something is actually in flight
    ctl = m.ElasticController(router, cooldown_steps=0, min_engines=1)
    # pin the victim choice deterministic: drain engine 0
    ctl._by_saturation = lambda descending: sorted(
        h.engine_id for h in router.handles.values())
    n_on_victim = sum(1 for (eid, _e) in router._inflight if eid == 0)
    _plan_stub(router, "scale_down")
    assert ctl.step() == "scale_down"
    assert set(router.handles) == {1, 2}
    assert len(router.handles) == 2
    _evals, action, detail = ctl.actions[-1]
    assert action == "scale_down" and detail["engine"] == 0
    assert detail["fates"]["migrated"] == n_on_victim
    assert detail["fates"]["re_prefilled"] == 0
    # the drained engine parks in standby for the next scale_up
    assert ctl.standby and ctl.standby[0] is engines[0]
    out = router.run_to_completion()
    assert sorted(out) == sorted(rids)
    assert all(len(toks) == 6 for toks in out.values())
    # the migrated resumes were INJECTED, not re-prefilled
    assert sum(e.injected for e in engines[1:]) == n_on_victim
    assert len(router.handles) == 2


def test_scale_down_respects_min_engines(m):
    router, _ = _pool(m, n=2)
    ctl = m.ElasticController(router, cooldown_steps=0, min_engines=2)
    _plan_stub(router, "scale_down")
    assert ctl.step() is None
    assert len(router.handles) == 2


def test_scale_up_without_source_is_a_no_op(m):
    router, _ = _pool(m, n=2)
    ctl = m.ElasticController(router, cooldown_steps=0)
    _plan_stub(router, "scale_up")
    assert ctl.step() is None            # no standby, no spawn
    assert len(router.handles) == 2
    # max_engines also gates
    ctl2 = m.ElasticController(router, standby=[m.Stub(9)],
                             cooldown_steps=0, max_engines=2)
    assert ctl2.step() is None
    assert len(router.handles) == 2


def test_rebalance_moves_along_named_pairs(m):
    """The plan's (source, target) pairs drive the sweep: running
    decode work leaves the named source and the ranked dispatch lands
    it — with its pages — on the engine with spare capacity."""
    router, engines = _pool(m, n=2, slots=4)
    for i in range(3):
        router.submit(np.arange(1, 9, dtype=np.int64) + i,
                      max_new_tokens=8)
    # strand all work on engine 0: engine 1 sits out the dispatch
    # step, then comes back healthy with spare capacity
    router.mark_unhealthy(1)
    router.step()
    router.recover_engine(1)
    router.step()
    on_src = sum(1 for (eid, _e) in router._inflight if eid == 0)
    assert on_src == 3
    ctl = m.ElasticController(router, cooldown_steps=0,
                            max_moves_per_action=2)
    _plan_stub(router, "rebalance", rebalance_pairs=[
        {"source_engine": 0, "target_engine": 1, "spread": 0.9}])
    assert ctl.step() == "rebalance"
    assert ctl.actions[-1][1] == "rebalance"
    assert ctl.actions[-1][2]["moved"] == 2          # capped
    moved_pending = [rr for rr in router.pending
                     if rr.kv_buffer is not None]
    assert len(moved_pending) == 2
    router.step()            # dispatch INJECTS them (zero re-prefill);
    # placement stays the ranked dispatch's call, and the drained-down
    # source may win one back — but the spare-capacity target gets work
    assert engines[0].injected + engines[1].injected == 2
    assert engines[1].injected >= 1
    out = router.run_to_completion()
    assert len(out) == 3
    assert all(len(toks) == 8 for toks in out.values())


def test_rebalance_skips_unmovable_sources(m):
    """No target with matching geometry/room ⇒ nothing moves and no
    action is recorded (the plan recommendation alone is not an act)."""
    router, engines = _pool(m, n=2, slots=2)
    engines[1].geometry_tuple = (99,) + GEO[1:]       # incompatible
    router.submit(np.arange(1, 9, dtype=np.int64), max_new_tokens=8)
    router.step()
    ctl = m.ElasticController(router, cooldown_steps=0)
    _plan_stub(router, "rebalance", rebalance_pairs=[
        {"source_engine": 0, "target_engine": 1, "spread": 0.5}])
    assert ctl.step() is None
    assert ctl.actions == []
    router.run_to_completion()


def test_one_actuation_per_planner_evaluation(m):
    """The same committed evaluation never double-executes, even with
    cooldown_steps=0; a NEW evaluation may act again."""
    router, engines = _pool(m, n=2, slots=1)
    ctl = m.ElasticController(router, standby=[m.Stub(7),
                                             m.Stub(8)],
                            cooldown_steps=0, max_engines=4)
    plan = {"action": "scale_up",
            "evaluations": router.capacity.planner.evaluations + 1}
    router.capacity_plan = lambda: plan
    assert ctl.step() == "scale_up"
    assert ctl.step() is None                 # same evaluation: held
    plan["evaluations"] += 1
    assert ctl.step() == "scale_up"           # new evaluation: acts
    assert set(router.handles) == {0, 1, 7, 8}


def test_capacity_plan_names_rebalance_pairs(m):
    """Satellite 2: the plan dict ranks concrete (source, target)
    pairs by saturation spread — hottest paired with coolest."""
    mon = m.FleetCapacityMonitor(m.CapacityConfig(min_dwell=1,
                                              halflife_s=10.0,
                                              sample_every=1))
    t = 100.0
    sats = {0: (4, 4), 1: (0, 4), 2: (2, 4), 3: (3, 4)}
    for eid, (occ, slots) in sats.items():
        m = mon.monitor_for(eid)
        m.sample({"slots": slots, "occupancy": occ, "waiting": 0,
                  "free_pages": 100, "total_pages": 100,
                  "counters": {"tokens_generated": 0,
                               "requests_admitted": 0}}, t)
    pairs = mon.rebalance_pairs()
    assert [ (p["source_engine"], p["target_engine"]) for p in pairs ] \
        == [(0, 1), (3, 2)]
    assert pairs[0]["spread"] > pairs[1]["spread"] > 0
    # and the plan dict carries them
    mon.planner.evaluate({"saturation": 0.5, "saturation_spread": 0.9,
                          "pending": 0.0, "queue_growth_per_s": 0.0,
                          "engines": 4})
    plan = mon.capacity_plan()
    assert plan["rebalance_pairs"] == pairs


# ---------------------------------------------------------------------------
# the drill on real tiny port engines
# ---------------------------------------------------------------------------
def elastic_drill(model, make_engine, budget=6, overload=8, drain=4,
                  seed=0):
    """``bench_elastic_drill``'s shape over engines from ``make_engine(
    engine_id)``: two pooled engines and one warmed standby behind a
    ``capacity=`` router and an ``ElasticController``; an overload wave
    run to completion with the controller stepping (scale_up), idle steps
    until the planner commits scale_down and the controller acts, then
    ``drain`` requests brought mid-decode everywhere and a forced
    scale_down.  Returns the router, the controller, the engines, the
    prompts and budgets by rid, and the forced drain's fates."""
    from paddle_tpu_torch.inference.elastic import ElasticController
    from paddle_tpu_torch.inference.router import ServingRouter
    from paddle_tpu_torch.observability.capacity import CapacityConfig
    vocab = model.config.vocab_size
    engines = [make_engine(60 + i) for i in range(3)]
    rng = np.random.RandomState(seed)
    for eng in engines:                      # warm every engine
        eng.add_request(rng.randint(1, vocab, (5,)).astype(np.int64), 2)
        eng.run_to_completion()
        eng.finished.clear()
    cold = engines[-1]
    router = ServingRouter(engines[:2], capacity=CapacityConfig(
        min_dwell=2, halflife_s=0.05, sample_every=1))
    ctl = ElasticController(router, standby=[cold], min_engines=1,
                            max_engines=3, cooldown_steps=4)
    prompts, budgets = {}, {}

    def submit(n, b):
        for _ in range(n):
            p = rng.randint(1, vocab, (int(rng.randint(5, 12)),))
            rid = router.submit(p.astype(np.int64), max_new_tokens=b)
            prompts[rid], budgets[rid] = p.astype(np.int64), b

    submit(overload, budget)
    while router.has_work():
        router.step()
        ctl.step()
    for _ in range(300):                     # bounded: fail, don't spin
        router.step()
        ctl.step()
        if any(a[1] == "scale_down" for a in ctl.actions):
            break
        time.sleep(0.01)
    submit(drain, 3 * budget)
    for _ in range(80):                      # until all are extractable
        router.step()
        live = [router._inflight[k] for k in list(router._inflight)]
        if len(live) == drain and all(
                rr.engine_req is not None
                and getattr(rr.engine_req, "state", "") == "running"
                and rr.engine_req.output_ids for rr in live):
            break
    fates = {}
    if ctl._scale_down() == "scale_down":
        fates = ctl.actions[-1][2]["fates"]
    router.run_to_completion()
    return router, ctl, engines, prompts, budgets, fates


def test_elastic_drill_on_port_engines():
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    model = LlamaForCausalLM(llama_tiny_config(), device="cpu",
                             generator=torch.Generator().manual_seed(0))

    def make_engine(eid):
        return ContinuousBatchingEngine(
            model, max_batch_size=2, num_blocks=64, block_size=4,
            mixed_step=True, prefill_chunk_size=8, engine_id=eid,
            device="cpu")
    router, ctl, engines, prompts, budgets, fates = elastic_drill(
        model, make_engine)
    acted = [a[1] for a in ctl.actions]
    assert "scale_up" in acted and "scale_down" in acted[:-1], acted
    assert fates and fates["re_prefilled"] == 0 and fates["migrated"] >= 1
    assert sorted(router.finished) == sorted(budgets)       # zero drops
    for rid, p in prompts.items():
        want = model.generate(torch.from_numpy(p)[None],
                              budgets[rid])[0, len(p):].tolist()
        assert router.finished[rid].output_ids == want, rid
    # every prompt prefilled once: migrated requests resumed from pages
    assert sum(e.prefill_tokens for e in engines) \
        == sum(len(p) for p in prompts.values()) + 3 * 5
    for e in engines:
        c = e.caches[0]
        assert len(c._free) == c.num_blocks
