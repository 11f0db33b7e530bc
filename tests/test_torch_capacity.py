"""The port's capacity & efficiency plane (``paddle_tpu_torch/
observability/capacity.py`` and ``telemetry.py``, the router's
``capacity=``) against the reference's, on the CPU.

The reference's stub-lane tests (``test_capacity.py``: SignalWindow math
under deterministic timestamps and concurrent writers, the planner's
hysteresis and dwell, the stub-pool router wiring and ``/healthz``, the
MFU arithmetic) each run twice, over the reference's modules and over the
port's copies — the two cases of the ``m`` fixture.  The peak-FLOPs table
test is split per package: the port's table names NVIDIA cards and gives
None on the CPU.  Then ``ContinuousBatchingEngine.efficiency_stats`` on
port engines (mixed and split, fp and int8 weights): the reference's
contract (None before a probe, cached, a failed probe latches, the env
gate) and the numbers against a count by hand.
"""
import json
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.inference import router as ref_router
from paddle_tpu import observability as ref_obs
from paddle_tpu.observability import capacity as ref_capacity

from paddle_tpu_torch.inference import router as port_router
from paddle_tpu_torch import observability as port_obs
from paddle_tpu_torch.observability import capacity as port_capacity
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config


@pytest.fixture(params=["reference", "port"])
def m(request):
    """The modules under test: the reference's or the port's."""
    if request.param == "reference":
        return types.SimpleNamespace(cap=ref_capacity, router=ref_router,
                                     obs=ref_obs)
    return types.SimpleNamespace(cap=port_capacity, router=port_router,
                                 obs=port_obs)


# ---------------------------------------------------------------------------
# m.cap.SignalWindow
# ---------------------------------------------------------------------------
def test_signal_window_rate_ewma_derivative(m):
    """Counter rate, gauge derivative and the time-decayed EWMA, on
    explicit timestamps (deterministic — no wall clock in the math)."""
    w = m.cap.SignalWindow(maxlen=8, halflife_s=1.0)
    assert w.rate() == 0.0 and w.derivative() == 0.0    # empty
    assert w.ewma() is None and w.last() is None
    for i in range(5):                    # counter: +10/s
        w.add(10.0 * i, t=100.0 + i)
    assert w.rate() == pytest.approx(10.0)
    assert w.derivative() == pytest.approx(10.0)
    assert w.span() == pytest.approx(4.0)
    # gauge going DOWN: rate clamps at 0 (counter-reset semantics),
    # derivative stays signed
    d = m.cap.SignalWindow(maxlen=8, halflife_s=1.0)
    for i in range(5):
        d.add(100.0 - 5.0 * i, t=200.0 + i)
    assert d.rate() == 0.0
    assert d.derivative() == pytest.approx(-5.0)
    # EWMA: one exact half-life step halves the distance to the target
    e = m.cap.SignalWindow(maxlen=8, halflife_s=1.0)
    e.add(0.0, t=0.0)
    e.add(1.0, t=1.0)                     # dt == halflife -> alpha 0.5
    assert e.ewma() == pytest.approx(0.5)
    # bounded: the ring keeps only maxlen samples and the rate is
    # computed over the RETAINED window
    b = m.cap.SignalWindow(maxlen=4, halflife_s=1.0)
    for i in range(100):
        b.add(float(i), t=float(i))
    assert len(b) == 4
    assert b.span() == pytest.approx(3.0)
    assert b.rate() == pytest.approx(1.0)
    with pytest.raises(ValueError):
        m.cap.SignalWindow(maxlen=1)


def test_signal_window_concurrent_writers(m):
    """N writer threads + a reader thread: every statistic stays
    finite and bounded, nothing raises, and the final window holds
    exactly maxlen samples of the written values."""
    w = m.cap.SignalWindow(maxlen=64, halflife_s=0.5)
    errors = []

    def write(base):
        try:
            for i in range(500):
                w.add(base + i)
        except Exception as e:                        # noqa: BLE001
            errors.append(e)

    def read():
        try:
            for _ in range(500):
                w.rate(), w.ewma(), w.derivative(), w.mean(), len(w)
        except Exception as e:                        # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=write, args=(1000 * k,))
               for k in range(4)] + [threading.Thread(target=read)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(w) == 64
    assert w.last() is not None and np.isfinite(w.ewma())
    assert np.isfinite(w.rate()) and np.isfinite(w.derivative())


def test_fleet_monitor_map_safe_under_concurrent_insertion(m):
    """A late engine's monitor is inserted by the step thread while a
    /healthz scrape thread iterates the map (fleet_signals /
    capacity_plan) — the locked snapshot must never raise
    'dictionary changed size during iteration'."""
    mon = m.cap.FleetCapacityMonitor(m.cap.CapacityConfig(sample_every=1))
    payload = {"occupancy": 1, "slots": 2, "waiting": 0,
               "free_pages": 50, "total_pages": 100}
    errors = []

    def insert():
        try:
            for i in range(300):
                mon.monitor_for(i).sample(payload)
        except Exception as e:                        # noqa: BLE001
            errors.append(e)

    def scrape():
        try:
            for _ in range(300):
                mon.fleet_signals()
                mon.capacity_plan()
                mon._plan = None        # force a rebuild each pass
        except Exception as e:                        # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=insert),
               threading.Thread(target=scrape)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert mon.fleet_signals()["engines"] == 300


# ---------------------------------------------------------------------------
# planner: hysteresis bands + minimum dwell
# ---------------------------------------------------------------------------
def _fleet(sat, pending=0.0, growth=0.0, spread=0.0, engines=2):
    return {"saturation": sat, "pending": pending,
            "queue_growth_per_s": growth, "saturation_spread": spread,
            "engines": engines}


def test_capacity_planner_hysteresis_dwell_and_flap(m):
    cfg = m.cap.CapacityConfig(min_dwell=3)
    p = m.cap.CapacityPlanner(cfg)
    # saturated: candidate scale_up must DWELL 3 evaluations first
    assert p.evaluate(_fleet(0.95)) == "steady"
    assert p.evaluate(_fleet(0.95)) == "steady"
    assert p.evaluate(_fleet(0.95)) == "scale_up"
    assert p.actions == ["scale_up"]
    # hysteresis: dithering around the ENTRY band (0.84 / 0.86, both
    # above high_clear=0.70) never leaves scale_up — zero flaps
    for i in range(20):
        assert p.evaluate(_fleet(0.84 if i % 2 else 0.86)) == "scale_up"
    assert p.actions == ["scale_up"]
    # clears the high band -> steady (after dwell), then idle ->
    # scale_down (after dwell); the committed sequence never reverses
    for _ in range(3):
        p.evaluate(_fleet(0.5))
    assert p.action == "steady"
    for _ in range(3):
        p.evaluate(_fleet(0.1))
    assert p.action == "scale_down"
    assert p.actions == ["scale_up", "steady", "scale_down"]
    # scale_down defends its band: dither around low_watermark (0.2 /
    # 0.3, both under low_clear=0.40) stays committed
    for i in range(20):
        assert p.evaluate(_fleet(0.2 if i % 2 else 0.3)) == "scale_down"
    assert p.actions == ["scale_up", "steady", "scale_down"]
    # pending work instantly disqualifies scale_down's defense
    for _ in range(3):
        p.evaluate(_fleet(0.3, pending=2.0))
    assert p.action == "steady"


def test_capacity_planner_rebalance_and_blips(m):
    p = m.cap.CapacityPlanner(m.cap.CapacityConfig(min_dwell=2))
    # mid-band fleet with a wide per-engine spread -> rebalance
    for _ in range(2):
        p.evaluate(_fleet(0.5, spread=0.6))
    assert p.action == "rebalance"
    # a 1-evaluation saturation blip (below min_dwell) never commits
    p.evaluate(_fleet(0.95))
    assert p.action == "rebalance"
    p.evaluate(_fleet(0.5, spread=0.6))
    assert p.action == "rebalance"
    assert p.actions == ["rebalance"]
    # growing backlog above high_clear escalates without full
    # watermark saturation
    for _ in range(2):
        p.evaluate(_fleet(0.75, pending=4.0, growth=1.0))
    assert p.action == "scale_up"
    with pytest.raises(ValueError):
        m.cap.CapacityConfig(high_watermark=0.5, high_clear=0.8)
    with pytest.raises(ValueError):
        m.cap.CapacityConfig(min_dwell=0)
    with pytest.raises(ValueError):
        m.cap.CapacityConfig(sample_every=0)


# ---------------------------------------------------------------------------
# stub engine pool: router wiring, defaults-off parity, /healthz
# ---------------------------------------------------------------------------
class _StubReq:
    def __init__(self, rid, prompt, budget):
        self.req_id = rid
        self.prompt_ids = np.asarray(prompt, np.int64)
        self.output_ids = []
        self.max_new_tokens = budget
        self.t_first_token = 0.0
        self.truncated = False
        self.slot = -1


class _StubEngine:
    """Minimal engine protocol with controllable load + counters."""
    block_size = 4

    def __init__(self, engine_id, slots=1):
        self.engine_id = engine_id
        self.max_batch_size = slots
        self.waiting = []
        self.running = []
        self.finished = {}
        self.prefix_cache = None
        self.tokens = 0
        self._next = 0

    def add_request(self, prompt_ids, max_new_tokens=16,
                    eos_token_id=None):
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
        done = []
        for r in list(self.running):
            r.output_ids.append(7)
            self.tokens += 1
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
                "free_pages": 100, "total_pages": 100,
                "chunk_queue_depth": 0,
                "counters": {"tokens_generated": self.tokens,
                             "requests_admitted": self._next}}


def _stub_router(m, n=2, slots=1, capacity=True, **kw):
    engines = [_StubEngine(i, slots=slots) for i in range(n)]
    return m.router.ServingRouter(engines, capacity=capacity, **kw), \
        engines


def test_router_capacity_plan_on_stub_pool(m):
    """The router samples per step, the plan surfaces everywhere it
    should, and an overloaded stub pool recommends scale_up."""
    cfg = m.cap.CapacityConfig(min_dwell=2, halflife_s=0.001,
                         sample_every=1)
    router, _engines = _stub_router(m, n=2, slots=1, capacity=cfg)
    rng = np.random.RandomState(0)
    for _ in range(8):                    # 8 requests onto 2 slots
        router.submit(rng.randint(1, 50, (8,)).astype(np.int64),
                      max_new_tokens=4)
    for _ in range(3):
        router.step()
    plan = router.capacity_plan()
    assert plan["action"] == "scale_up"
    assert plan["fleet"]["saturation"] > 0.8
    assert plan["fleet"]["pending"] > 0
    assert set(plan["engines"]) == {"0", "1"}
    for sig in plan["engines"].values():
        assert sig["samples"] >= 1
        assert sig["tokens_per_s"] >= 0.0
    assert plan["bands"]["min_dwell"] == 2
    # the plan rides health_payload, is JSON-serializable as-is, and
    # the recommendation gauges are one-hot on the committed action
    hp = router.health_payload()
    assert hp["capacity"]["action"] == "scale_up"
    json.dumps(hp["capacity"])
    snap = m.obs.default_registry().snapshot()
    reco = {s["labels"]["action"]: s["value"]
            for s in snap["router_capacity_recommendation"]["series"]}
    assert reco["scale_up"] == 1.0
    assert sum(reco.values()) == 1.0
    assert set(reco) == set(m.cap.CAPACITY_ACTIONS)
    router.run_to_completion()


def test_lost_engine_leaves_the_fleet_rollup(m):
    """An unhealthy engine's frozen (typically saturated) windows must
    not pin the fleet saturation/spread/tokens-rate — the planner
    would otherwise chase a ghost engine forever."""
    cfg = m.cap.CapacityConfig(min_dwell=1, halflife_s=0.001, sample_every=1)
    router, _engines = _stub_router(m, n=2, slots=1, capacity=cfg)
    rng = np.random.RandomState(1)
    for _ in range(6):
        router.submit(rng.randint(1, 50, (8,)).astype(np.int64),
                      max_new_tokens=3)
    for _ in range(2):
        router.step()            # both engines sampled under load
    import time as _time
    router.mark_unhealthy(1)     # engine 1's windows freeze here
    router.run_to_completion()
    for _ in range(30):
        router.step()            # idle: the survivor's EWMA decays
        _time.sleep(0.001)       # stub steps are µs — give the
                                 # 1ms-halflife EWMA real wall time
    plan = router.capacity_plan()
    assert plan["engines"]["1"]["healthy"] is False
    assert plan["engines"]["0"]["healthy"] is True
    assert plan["fleet"]["engines"] == 1       # rollup = survivors only
    assert plan["fleet"]["saturation"] < 0.2
    assert plan["fleet"]["saturation_spread"] == 0.0
    # recovery puts the engine (and its resumed history) back in
    router.recover_engine(1)
    router.step()
    assert router.capacity_plan()["engines"]["1"]["healthy"] is True


def test_router_capacity_defaults_off_and_knob(m):
    """No monitor configured: no capacity key, capacity_plan raises,
    and step() takes the plain path (no monitor object at all)."""
    router, _ = _stub_router(m, capacity=None)
    router.submit(np.arange(1, 9, dtype=np.int64), max_new_tokens=1)
    router.run_to_completion()
    assert router.capacity is None
    assert "capacity" not in router.health_payload()
    with pytest.raises(ValueError):
        router.capacity_plan()
    # the one knob parser
    assert m.cap.resolve_capacity_monitor(None) is None
    assert m.cap.resolve_capacity_monitor(False) is None
    mon = m.cap.FleetCapacityMonitor()
    assert m.cap.resolve_capacity_monitor(mon) is mon
    assert isinstance(m.cap.resolve_capacity_monitor(True),
                      m.cap.FleetCapacityMonitor)
    with pytest.raises(ValueError):
        m.cap.resolve_capacity_monitor("yes")


def test_capacity_over_healthz_in_process_and_http(m):
    """The satellite contract: the capacity dict reaches /healthz on
    both the in-process and HTTP paths, and a raising provider still
    degrades to the bare-ok body on both."""
    MetricsServer, healthz_payload = m.obs.MetricsServer, \
        m.obs.healthz_payload
    router, _ = _stub_router(m, 
        capacity=m.cap.CapacityConfig(min_dwell=1, sample_every=1))
    router.submit(np.arange(1, 9, dtype=np.int64), max_new_tokens=2)
    router.step()
    # in-process
    body = healthz_payload(router.health_payload)
    assert body["status"] == "ok"
    assert body["capacity"]["action"] in m.cap.CAPACITY_ACTIONS
    def _boom():
        raise RuntimeError("stats broke")
    assert healthz_payload(_boom) == {"status": "ok"}
    # HTTP
    srv = MetricsServer(port=0, health_provider=router.health_payload)
    srv.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=10) as r:
            scraped = json.loads(r.read().decode("utf-8"))
        assert scraped["status"] == "ok"
        assert scraped["capacity"]["action"] in m.cap.CAPACITY_ACTIONS
        assert "fleet" in scraped["capacity"]
    finally:
        srv.stop()
    srv = MetricsServer(port=0, health_provider=_boom)
    srv.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=10) as r:
            assert json.loads(r.read().decode("utf-8")) \
                == {"status": "ok"}
    finally:
        srv.stop()
    router.run_to_completion()


# ---------------------------------------------------------------------------
# efficiency: shared peak table + MFU arithmetic
# ---------------------------------------------------------------------------
def test_efficiency_mfu_arithmetic_from_injected_source(m):
    """MFU = windowed tokens/s x flops/token / peak, computed from an
    injected efficiency source (no compile); the remote path reads the
    same block off the payload."""
    stats = {"flops_per_token": 2.0e6, "hbm_bytes_per_token": 5.0e5,
             "source": "cost_analysis"}
    eng = types.SimpleNamespace(
        efficiency_stats=lambda compute=False: stats)
    mon = m.cap.EngineCapacityMonitor(7, engine=eng)
    payload = {"occupancy": 1, "slots": 2, "waiting": 0,
               "free_pages": 50, "total_pages": 100,
               "counters": {"tokens_generated": 0}}
    for i in range(5):                    # 100 tokens/s on the window
        payload = dict(payload)
        payload["counters"] = {"tokens_generated": 100 * i}
        mon.sample(payload, t=10.0 + i)
    eff = mon.efficiency(peak_flops=1.0e9)
    assert eff["tokens_per_s"] == pytest.approx(100.0)
    assert eff["mfu"] == pytest.approx(100.0 * 2.0e6 / 1.0e9)
    assert eff["hbm_bytes_per_token"] == 5.0e5
    # unknown peak: MFU reports 0, never a made-up number
    assert mon.efficiency(peak_flops=None) is not None
    # remote twin: the stats ride the payload's efficiency block
    r = m.cap.EngineCapacityMonitor(8, engine=None)
    payload2 = dict(payload)
    payload2["efficiency"] = stats
    r.sample(payload2, t=1.0)
    assert r.efficiency(peak_flops=1.0e9)["flops_per_token"] == 2.0e6
    # saturation folds BOTH axes and caps at 1
    assert m.cap.saturation_of({"occupancy": 3, "slots": 2, "waiting": 1,
                          "free_pages": 0, "total_pages": 10}) == 1.0
    assert m.cap.saturation_of({}) == 0.0


# ---------------------------------------------------------------------------
# the peak-FLOPs table, per package
# ---------------------------------------------------------------------------
def test_reference_peak_flops_table_is_telemetrys():
    """The reference's capacity module imports telemetry's table and
    resolver (object identity, not equality)."""
    from paddle_tpu.observability import telemetry
    assert ref_capacity.PEAK_FLOPS_BY_KIND is telemetry.PEAK_FLOPS_BY_KIND
    assert ref_capacity.device_peak_flops is telemetry.device_peak_flops


def test_port_peak_flops_table_names_the_h100(monkeypatch):
    """The port's capacity module imports ITS telemetry's table (no
    third copy); the table names the H100 SXM at 989 TFLOP/s bf16 dense
    (``chip_smoke.PEAK_FLOPS``), the PCIe part by its longer prefix; the
    CPU has no peak (MFU then reads 0); the env override wins."""
    from paddle_tpu_torch.observability import telemetry
    import chip_smoke
    assert port_capacity.PEAK_FLOPS_BY_KIND is telemetry.PEAK_FLOPS_BY_KIND
    assert port_capacity.device_peak_flops is telemetry.device_peak_flops
    table = telemetry.PEAK_FLOPS_BY_KIND
    assert table["NVIDIA H100"] == chip_smoke.PEAK_FLOPS["bfloat16"]
    for name, want in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", 756e12)):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, n=name: n)
        assert telemetry.device_peak_flops() == want
    monkeypatch.undo()
    monkeypatch.delenv(telemetry.PEAK_FLOPS_ENV, raising=False)
    assert telemetry.device_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert telemetry.device_peak_flops() is None
    monkeypatch.setenv(telemetry.PEAK_FLOPS_ENV, "1e12")
    assert telemetry.device_peak_flops() == 1e12


def test_port_step_telemetry_on_the_cpu():
    """StepTelemetry over the port's registry: MFU from the stated FLOPs
    over an explicit peak, warm-up steps kept out of the rates, and no
    device-memory sample without a card."""
    from paddle_tpu_torch.observability import telemetry
    r = port_obs.MetricsRegistry()
    tel = telemetry.StepTelemetry(registry=r, peak_flops=1e9,
                                  hbm_sample_interval=1,
                                  span_markers=False)
    tel.set_flops_per_step(5e8)
    tel.on_step(2.0, loss=1.5, tokens=100, warmup=True)
    assert r.get("train_mfu_ratio").value == 0.0
    tel.on_step(1.0, loss=1.25, tokens=100)
    assert r.get("train_mfu_ratio").value == pytest.approx(0.5)
    assert r.get("train_tokens_per_second").value == pytest.approx(100.0)
    assert r.get("train_steps_total").value == 2
    assert r.get("train_loss").value == 1.25
    with pytest.raises(FloatingPointError):
        telemetry.StepTelemetry(registry=r, check_nan_inf=True,
                                span_markers=False).on_step(
                                    1.0, loss=float("nan"))


# ---------------------------------------------------------------------------
# efficiency_stats on port engines
# ---------------------------------------------------------------------------
CFG = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
           num_key_value_heads=2, intermediate_size=128, vocab_size=128)
SLOTS, CTX = 2, 32


def _engine(mixed, weight_quant):
    model = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    kw = (dict(mixed_step=True, prefill_chunk_size=8, token_budgets=(4, 8))
          if mixed else dict(prefill_buckets=(8, 16)))
    return ContinuousBatchingEngine(
        model, max_batch_size=SLOTS, num_blocks=32, block_size=4,
        max_seq_len=CTX, weight_quant=weight_quant, device="cpu", **kw)


def _by_hand(mixed, int8):
    """One launch counted from the config: the probe is the smallest
    budget (4) that holds the 2 decode spans, or the decode step at 2
    slots; every span attends CTX keys."""
    L, h, H, Hkv, I, V = 2, 64, 4, 2, 128, 128
    D = h // H
    rows = 4 if mixed else SLOTS
    proj_in_out = [(h, H * D), (h, Hkv * D), (h, Hkv * D), (H * D, h),
                   (h, I), (h, I), (I, h)]
    per_row = sum(2 * i * o for i, o in proj_in_out)
    flops = (rows * L * per_row + 2 * SLOTS * h * V
             + 4 * L * SLOTS * CTX * H * D)
    numel = L * sum(i * o for i, o in proj_in_out) + V * h
    outs = L * sum(o for _i, o in proj_in_out) + V
    w_bytes = numel + 4 * outs if int8 else 4 * numel
    kv = L * (SLOTS * CTX + rows) * Hkv * D * 4 * 2
    return rows, flops, w_bytes + kv


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "split"])
@pytest.mark.parametrize("weight_quant", [None, "int8"],
                         ids=["fp", "w8"])
def test_efficiency_stats_contract_and_count(mixed, weight_quant,
                                             monkeypatch):
    """None until probed (``compute=False`` never probes, the env gate
    turns the probe off without latching), then the analytic count of one
    launch — equal to the count by hand — cached and riding the health
    payload."""
    eng = _engine(mixed, weight_quant)
    assert eng.efficiency_stats() is None
    assert "efficiency" not in eng.health_payload()
    monkeypatch.setenv("PADDLE_TPU_MFU_COST_ANALYSIS", "0")
    assert eng.efficiency_stats(compute=True) is None
    monkeypatch.setenv("PADDLE_TPU_MFU_COST_ANALYSIS", "1")
    st = eng.efficiency_stats(compute=True)
    rows, flops, n_bytes = _by_hand(mixed, weight_quant == "int8")
    assert st["step"] == ("mixed" if mixed else "decode")
    assert st["source"] == "analytic"
    assert st["tokens_per_launch"] == rows
    assert st["flops_per_launch"] == flops
    assert st["flops_per_token"] == pytest.approx(flops / rows, rel=1e-12)
    assert st["hbm_bytes_per_token"] == pytest.approx(n_bytes / rows,
                                                      rel=1e-12)
    assert eng.efficiency_stats() is st                  # cached
    assert eng.efficiency_stats(compute=True) is st
    assert eng.health_payload()["efficiency"] == st
    json.dumps(eng.health_payload())


def test_efficiency_probe_failure_latches(monkeypatch):
    """A probe that fails is never retried, even once it would work."""
    monkeypatch.setenv("PADDLE_TPU_MFU_COST_ANALYSIS", "1")
    eng = _engine(True, None)
    good = eng.mixed.launch_stats

    def broken(*a, **kw):
        raise RuntimeError("probe failed")
    eng.mixed.launch_stats = broken
    assert eng.efficiency_stats(compute=True) is None
    eng.mixed.launch_stats = good
    assert eng.efficiency_stats(compute=True) is None
    assert "efficiency" not in eng.health_payload()


def test_efficiency_beside_the_references_cost_analysis(monkeypatch):
    """The reference's number (its compiled XLA module's cost_analysis,
    which on the CPU counts the XLA reference attention: a different
    program) printed beside the port's analytic count on the same
    configuration; not compared."""
    from paddle_tpu.inference.serving import ContinuousBatchingEngine as Ref
    from test_torch_split_serving import _pair
    monkeypatch.setenv("PADDLE_TPU_MFU_COST_ANALYSIS", "1")
    ref_model, port_model = _pair(**CFG)
    kw = dict(max_batch_size=SLOTS, num_blocks=32, block_size=4,
              max_seq_len=CTX, mixed_step=True, prefill_chunk_size=8,
              token_budgets=(4, 8))
    ref = Ref(ref_model, **kw).efficiency_stats(compute=True)
    port = ContinuousBatchingEngine(port_model, device="cpu",
                                    **kw).efficiency_stats(compute=True)
    print("efficiency: reference (cost_analysis) %s; port (analytic) %s"
          % (ref, port))
    assert port["flops_per_token"] > 0
    cap = port_capacity.FleetCapacityMonitor(peak_flops=1e12)
    mon = cap.monitor_for(0, engine=types.SimpleNamespace(
        efficiency_stats=lambda compute=False: port))
    mon.sample({"counters": {"tokens_generated": 0}}, t=0.0)
    mon.sample({"counters": {"tokens_generated": 10}}, t=1.0)
    eff = mon.efficiency(peak_flops=1e12)
    assert eff["mfu"] == pytest.approx(10 * port["flops_per_token"] / 1e12)
    assert eff["source"] == "analytic"
