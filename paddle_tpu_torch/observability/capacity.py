"""Fleet capacity & efficiency plane: windowed signals, serving-step MFU,
autoscaler-grade recommendations (a copy of
``paddle_tpu/observability/capacity.py`` over the port's engines).

Load planes publish POINT-IN-TIME snapshots (``load_score`` reads one
payload, the SLO counters are cumulative) — an autoscaler acting on a
snapshot flaps: one busy round reads as "scale up", one idle round as
"scale down".  This module turns those same counters and gauges into
DECISION-GRADE signals, pure host math on the payloads the router
already scrapes (no device work, no extra endpoint traffic):

**Windowed signals.**  :class:`SignalWindow` is a bounded, thread-safe
ring of ``(perf_counter, value)`` samples computing O(1) rolling rates
(for monotone counters: tokens/s, admission rate, preempt/requeue
rate, host-tier spill+restore pressure), signed derivatives (for
gauges: queue-depth growth, prefix-hit-rate drift) and a time-decayed
EWMA (saturation smoothing).  An :class:`EngineCapacityMonitor` feeds
one window set per engine from ``engine.health_payload()`` — sampled
once per router step off the probe-refreshed payload, so monitoring
adds no scrapes.

**Serving-step device efficiency.**
``ContinuousBatchingEngine.efficiency_stats(compute=True)`` counts one
launch of the engine's steady-state serving step (lazy, cached, one
probe ever, behind the ``PADDLE_TPU_MFU_COST_ANALYSIS`` opt-out) and
this module folds it with the windowed tokens/s into per-engine gauges:
``serving_step_mfu`` (= tokens/s x flops/token / peak),
``serving_hbm_bytes_per_token`` and ``serving_model_flops_per_token``.
The peak-FLOPs denominator is the one table of
:func:`~paddle_tpu_torch.observability.telemetry.device_peak_flops`
(imported, never copied).  Provenance: the reference reads its numbers
off the compiled XLA module's ``cost_analysis``; the port's are an
analytic count of the port's own launch (its GEMMs, the attention
kernels' work, the bytes of the weights and pages it moves) — the
``source`` field of every block says which.

**Capacity planning.**  :class:`CapacityPlanner` folds the per-engine
signals into a fleet rollup and an advisory action —
``scale_up`` / ``scale_down`` / ``rebalance`` / ``steady`` — with
HYSTERESIS bands (enter scale_up above ``high_watermark``, leave only
below ``high_clear``; mirrored low bands for scale_down) and a
MINIMUM DWELL (a new candidate must persist ``min_dwell`` consecutive
evaluations before the committed recommendation changes), so boundary
dithering never flaps the recommendation.  The committed plan surfaces
in ``ServingRouter.capacity_plan()``,
``health_payload()["capacity"]`` (and therefore ``/healthz``), and
the ``router_capacity_*`` metrics; :class:`~paddle_tpu_torch.inference.
elastic.ElasticController` acts on it.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from .metrics import MetricsRegistry, default_registry
# the ONE peak-FLOPs table — imported, never copied: StepTelemetry
# resolves peaks through these same symbols, and a test asserts the
# identity
from .telemetry import PEAK_FLOPS_BY_KIND, device_peak_flops

__all__ = ["SignalWindow", "EngineCapacityMonitor", "CapacityConfig",
           "CapacityPlanner", "FleetCapacityMonitor",
           "resolve_capacity_monitor", "CAPACITY_ACTIONS",
           "MFU_COST_ANALYSIS_ENV"]

# the reference's opt-out of its serving-step cost probe, kept by name:
# set to 0, efficiency_stats(compute=True) computes nothing
MFU_COST_ANALYSIS_ENV = "PADDLE_TPU_MFU_COST_ANALYSIS"

CAPACITY_ACTIONS = ("scale_up", "scale_down", "rebalance", "steady")


def _cost_analysis_enabled() -> bool:
    return os.environ.get(MFU_COST_ANALYSIS_ENV, "1") != "0"


class SignalWindow:
    """Bounded thread-safe ring of ``(t, value)`` samples on the shared
    ``perf_counter`` clock, with O(1) windowed statistics.

    One window holds ONE signal.  ``rate()`` reads the value as a
    monotone counter (delta value over the window span, clamped at 0 so
    a counter reset — engine restart — reads as quiescence, not a
    negative rate); ``derivative()`` reads it as a gauge (signed slope:
    queue growth, hit-rate drift); ``ewma()`` is a time-decayed
    exponential mean (half-life in seconds, so irregular sampling
    periods weight correctly).  All methods are safe under concurrent
    writers: one lock guards the ring and the EWMA state, and every
    statistic is computed from a single locked read.
    """

    def __init__(self, maxlen: int = 128, halflife_s: float = 5.0):
        if maxlen < 2:
            raise ValueError("SignalWindow maxlen must be >= 2 (rates "
                             "need two samples); got %r" % (maxlen,))
        self.maxlen = int(maxlen)
        self.halflife_s = float(halflife_s)
        self._lock = threading.Lock()
        self._buf: "deque[tuple]" = deque(maxlen=self.maxlen)
        self._ewma: Optional[float] = None
        self._ewma_t: float = 0.0

    def add(self, value, t: Optional[float] = None) -> None:
        t = time.perf_counter() if t is None else float(t)
        v = float(value)
        with self._lock:
            if self._ewma is None:
                self._ewma = v
            else:
                dt = t - self._ewma_t
                if dt > 0 and self.halflife_s > 0:
                    alpha = 1.0 - 0.5 ** (dt / self.halflife_s)
                else:
                    # zero/negative dt (same-tick samples, clock
                    # weirdness): a plain step keeps the EWMA bounded
                    alpha = 0.5
                self._ewma += alpha * (v - self._ewma)
            self._ewma_t = t
            self._buf.append((t, v))

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def last(self) -> Optional[float]:
        with self._lock:
            return self._buf[-1][1] if self._buf else None

    def span(self) -> float:
        """Seconds covered by the window (0 with < 2 samples)."""
        with self._lock:
            if len(self._buf) < 2:
                return 0.0
            return self._buf[-1][0] - self._buf[0][0]

    def _slope(self) -> float:
        # callers hold no lock; one locked snapshot of the endpoints
        with self._lock:
            if len(self._buf) < 2:
                return 0.0
            t0, v0 = self._buf[0]
            t1, v1 = self._buf[-1]
        dt = t1 - t0
        if dt <= 1e-9:
            return 0.0
        return (v1 - v0) / dt

    def rate(self) -> float:
        """Counter reading: windowed increments per second, >= 0."""
        return max(0.0, self._slope())

    def derivative(self) -> float:
        """Gauge reading: signed value change per second."""
        return self._slope()

    def ewma(self) -> Optional[float]:
        with self._lock:
            return self._ewma

    def mean(self) -> Optional[float]:
        with self._lock:
            if not self._buf:
                return None
            return sum(v for _, v in self._buf) / len(self._buf)


def _payload_counter(payload: Dict, name: str) -> float:
    try:
        return float(payload.get("counters", {}).get(name, 0) or 0)
    except (TypeError, ValueError):
        return 0.0


def saturation_of(payload: Dict) -> float:
    """Instantaneous saturation of one engine payload in [0, 1]: the
    max of slot pressure ((occupancy + waiting) / slots, capped) and
    KV-page utilization — an engine is saturated when EITHER axis is
    exhausted (a full pool stalls admission just as surely as full
    slots).  Pages the prefix cache could reclaim right now
    (``evictable_pages``) count as free: a cache-warm IDLE engine is
    headroom, not saturation — unlike ``load_score``, which
    deliberately prefers engines with genuinely free pages for
    placement.  Missing fields read unloaded."""
    try:
        slots = max(1, int(payload.get("slots", 1)))
        slot_term = (float(payload.get("occupancy", 0))
                     + float(payload.get("waiting", 0))) / slots
        total = max(1, int(payload.get("total_pages", 1)))
        free = (float(payload.get("free_pages", total))
                + float(payload.get("evictable_pages", 0)))
        kv_term = 1.0 - min(free, total) / total
    except (TypeError, ValueError):
        return 0.0
    return min(1.0, max(slot_term, kv_term, 0.0))


class EngineCapacityMonitor:
    """One engine's windowed signal set, fed from its health payload.

    ``sample(payload)`` is the ONLY per-step cost (a handful of locked
    deque appends); every derived statistic is computed on read.
    ``engine`` (optional, in-process pools only) is the efficiency
    source — :meth:`efficiency` pulls the cached serving-step numbers
    off it; remote handles instead surface them through the payload's
    ``efficiency`` block when the remote process computed them.
    """

    def __init__(self, engine_id: int, engine=None,
                 maxlen: int = 128, halflife_s: float = 5.0):
        self.engine_id = int(engine_id)
        self.engine = engine
        # flipped by the fleet monitor as the router's health view
        # changes: an unhealthy engine's windows stop updating, so its
        # last (often saturated) EWMA must not pin the fleet rollup —
        # the monitor is kept so a recovered engine resumes its history
        self.healthy = True
        mk = lambda: SignalWindow(maxlen, halflife_s)   # noqa: E731
        self.w_tokens = mk()          # counter: tokens generated
        self.w_admitted = mk()        # counter: requests admitted
        self.w_preempts = mk()        # counter: preempt/requeue pulls
        self.w_host_tier = mk()       # counter: spills + restores
        self.w_queue = mk()           # gauge: waiting depth
        self.w_saturation = mk()      # gauge: instantaneous saturation
        self.w_hit_rate = mk()        # gauge: cumulative prefix hit rate
        self.last_payload: Dict = {}

    def sample(self, payload: Dict, t: Optional[float] = None) -> None:
        t = time.perf_counter() if t is None else float(t)
        self.last_payload = payload
        self.w_tokens.add(_payload_counter(payload, "tokens_generated"), t)
        self.w_admitted.add(
            _payload_counter(payload, "requests_admitted"), t)
        self.w_preempts.add(_payload_counter(payload, "preempts"), t)
        self.w_host_tier.add(
            _payload_counter(payload, "host_tier_spills")
            + _payload_counter(payload, "host_tier_restores"), t)
        self.w_queue.add(float(payload.get("waiting", 0) or 0), t)
        self.w_saturation.add(saturation_of(payload), t)
        lookups = _payload_counter(payload, "prefix_lookups")
        hits = _payload_counter(payload, "prefix_hits")
        if lookups > 0:
            self.w_hit_rate.add(hits / lookups, t)

    def signals(self) -> Dict[str, float]:
        """The derived per-engine signal block — plain floats only (it
        rides ``/healthz`` JSON and actuators compare on it), so the
        prefix-hit fields are OMITTED until a lookup has been observed
        (an engine without a prefix cache never grows them) rather
        than published as None."""
        sat = self.w_saturation.ewma()
        out = {
            "tokens_per_s": self.w_tokens.rate(),
            "admissions_per_s": self.w_admitted.rate(),
            "preempts_per_s": self.w_preempts.rate(),
            "host_tier_per_s": self.w_host_tier.rate(),
            "queue_depth": float(self.w_queue.last() or 0.0),
            "queue_growth_per_s": self.w_queue.derivative(),
            "saturation": float(sat if sat is not None else 0.0),
            "headroom": float(1.0 - (sat if sat is not None else 0.0)),
            "samples": len(self.w_saturation),
        }
        hit = self.w_hit_rate.last()
        if hit is not None:
            out["prefix_hit_rate"] = float(hit)
            out["prefix_hit_rate_drift"] = self.w_hit_rate.derivative()
        return out

    # ---- serving-step device efficiency ---------------------------------
    def efficiency(self, compute: bool = False,
                   peak_flops: Optional[float] = None
                   ) -> Optional[Dict[str, float]]:
        """Per-engine device-efficiency block, or None when no
        serving-step numbers are available.  ``compute=True`` triggers
        the engine's lazy one-time probe (env-gated, cached on the
        engine) — never pass it from a liveness path.  MFU folds the
        WINDOWED tokens/s with the static flops/token: achieved FLOP/s
        over the per-card peak (0 when the peak is unknown: report 0,
        never invent a denominator)."""
        stats = None
        if self.engine is not None:
            fn = getattr(self.engine, "efficiency_stats", None)
            if fn is not None:
                stats = fn(compute=compute)
        if stats is None:
            stats = self.last_payload.get("efficiency")
        if not isinstance(stats, dict) or not stats.get("flops_per_token"):
            return None
        peak = peak_flops if peak_flops is not None else \
            device_peak_flops()
        tps = self.w_tokens.rate()
        flops_tok = float(stats["flops_per_token"])
        out = {
            "flops_per_token": flops_tok,
            "hbm_bytes_per_token": float(
                stats.get("hbm_bytes_per_token", 0.0)),
            "tokens_per_s": tps,
            "mfu": (tps * flops_tok / peak) if peak else 0.0,
            "peak_flops": float(peak) if peak else 0.0,
            "source": stats.get("source", "analytic"),
        }
        return out


@dataclass
class CapacityConfig:
    """Planner bands + windowing (the DECLARED hysteresis a capacity
    drill cites).  Saturations are fleet slot-weighted EWMAs in [0, 1].

    - enter ``scale_up`` at fleet saturation >= ``high_watermark`` (or
      a growing backlog while above ``high_clear``); leave only once
      saturation < ``high_clear``;
    - enter ``scale_down`` at saturation <= ``low_watermark`` with an
      empty backlog; leave once saturation > ``low_clear``;
    - ``rebalance`` when the per-engine saturation spread exceeds
      ``imbalance_threshold`` in the mid-band;
    - a NEW candidate must persist ``min_dwell`` consecutive
      evaluations before the committed recommendation changes;
    - ``sample_every``: the monitor samples + ticks every Nth router
      step (default 4).  Capacity decisions live on second-scale
      horizons (the EWMA half-life), so per-step resolution buys
      nothing — decimation is what keeps the monitor's overhead in
      the noise on sub-ms engine steps.  Tests that count ticks pass
      ``sample_every=1``.
    """
    high_watermark: float = 0.85
    high_clear: float = 0.70
    low_watermark: float = 0.25
    low_clear: float = 0.40
    imbalance_threshold: float = 0.45
    min_dwell: int = 3
    window: int = 128
    halflife_s: float = 5.0
    sample_every: int = 4

    def __post_init__(self):
        if not (0.0 <= self.low_watermark <= self.low_clear
                <= self.high_clear <= self.high_watermark <= 1.0):
            raise ValueError(
                "capacity bands must satisfy 0 <= low_watermark <= "
                "low_clear <= high_clear <= high_watermark <= 1; got "
                "%r" % (self,))
        if self.min_dwell < 1:
            raise ValueError("min_dwell must be >= 1; got %r"
                             % (self.min_dwell,))
        if self.sample_every < 1:
            raise ValueError("sample_every must be >= 1; got %r"
                             % (self.sample_every,))


class CapacityPlanner:
    """The hysteresis + dwell state machine over fleet signals.

    Pure host state, deterministic given the evaluation sequence —
    tests drive :meth:`evaluate` directly with synthetic signal dicts.
    ``actions`` records every COMMITTED transition (what a zero-flap
    gate counts); ``evaluations`` counts calls.
    """

    def __init__(self, config: Optional[CapacityConfig] = None):
        self.config = config or CapacityConfig()
        self.action = "steady"
        self.evaluations = 0
        self.since = 0                # evaluations since last commit
        self._cand = "steady"
        self._cand_streak = 0
        self.actions: List[str] = []  # committed transitions, in order

    # ---- candidate ------------------------------------------------------
    def _candidate(self, fleet: Dict[str, float]) -> str:
        c = self.config
        sat = float(fleet.get("saturation", 0.0))
        pending = float(fleet.get("pending", 0.0))
        growth = float(fleet.get("queue_growth_per_s", 0.0))
        spread = float(fleet.get("saturation_spread", 0.0))
        n_eng = int(fleet.get("engines", 1))
        # hysteresis: the current recommendation defends its band
        if self.action == "scale_up" and sat >= c.high_clear:
            return "scale_up"
        if self.action == "scale_down" and sat <= c.low_clear \
                and pending == 0:
            return "scale_down"
        if sat >= c.high_watermark or (pending > 0 and growth > 0
                                       and sat >= c.high_clear):
            return "scale_up"
        if sat <= c.low_watermark and pending == 0 and growth <= 0:
            return "scale_down"
        if n_eng >= 2 and spread >= c.imbalance_threshold:
            return "rebalance"
        return "steady"

    def evaluate(self, fleet: Dict[str, float]) -> str:
        """One planner tick: fold the fleet signal dict into the
        committed recommendation (minimum-dwell: a candidate that has
        not persisted ``min_dwell`` consecutive ticks leaves the
        committed action unchanged)."""
        self.evaluations += 1
        self.since += 1
        cand = self._candidate(fleet)
        if cand == self.action:
            self._cand = cand
            self._cand_streak = 0
            return self.action
        if cand == self._cand:
            self._cand_streak += 1
        else:
            self._cand = cand
            self._cand_streak = 1
        if self._cand_streak >= self.config.min_dwell:
            self.action = cand
            self.actions.append(cand)
            self.since = 0
            self._cand_streak = 0
        return self.action


class FleetCapacityMonitor:
    """Per-engine windows + the planner + the metric surface — what a
    ``ServingRouter(capacity=...)`` owns.  ``observe_router`` is the
    one per-step hook (samples the probe-refreshed payloads, ticks the
    planner, refreshes gauges); ``capacity_plan`` is the read API."""

    def __init__(self, config: Optional[CapacityConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 peak_flops: Optional[float] = None):
        self.config = config or CapacityConfig()
        self.planner = CapacityPlanner(self.config)
        # guards the monitor MAP (inserted into by the router's step
        # thread, iterated by /healthz scrape threads reading
        # capacity_plan through router.health_payload — an unlocked
        # insert-during-iteration raises and silently degrades the
        # scrape to the bare body); the windows below it carry their
        # own locks
        self._lock = threading.Lock()
        self.engines: Dict[int, EngineCapacityMonitor] = {}
        self.w_pending = SignalWindow(self.config.window,
                                      self.config.halflife_s)
        # resolved once: the env override / device-name table (None on
        # the CPU — MFU then publishes 0)
        self.peak_flops = peak_flops if peak_flops is not None \
            else device_peak_flops()
        self._plan: Optional[Dict] = None
        self._fleet: Optional[Dict] = None
        self._published_action: Optional[str] = None
        self._observations = 0
        r = registry or default_registry()
        self._m_reco = r.gauge(
            "router_capacity_recommendation",
            "one-hot committed capacity recommendation (hysteresis + "
            "minimum-dwell applied): the advisory action the elastic "
            "actuator consumes", labels=("action",))
        self._reco_children = {
            a: self._m_reco.labels(action=a) for a in CAPACITY_ACTIONS}
        self._m_transitions = r.counter(
            "router_capacity_transitions_total",
            "committed recommendation changes by destination action — "
            "a flap shows up here as a reversal inside one load "
            "regime, which the hysteresis bands + min_dwell forbid",
            labels=("action",))
        self._trans_children = {
            a: self._m_transitions.labels(action=a)
            for a in CAPACITY_ACTIONS}
        self._n_transitions_published = 0
        self._m_sat = r.gauge(
            "router_capacity_saturation_ratio",
            "fleet saturation: slot-weighted EWMA over per-engine "
            "max(slot pressure, KV-page utilization), in [0, 1]")
        self._m_headroom = r.gauge(
            "router_capacity_headroom_ratio",
            "1 - fleet saturation: how much of the current fleet is "
            "still spare before the scale_up band")
        self._m_tps = r.gauge(
            "router_capacity_tokens_per_second",
            "fleet-wide windowed generation rate (sum of per-engine "
            "rolling rates)")
        self._m_mfu = r.gauge(
            "serving_step_mfu",
            "per-engine serving MFU: windowed tokens/s x serving-step "
            "flops/token over the per-card peak (an analytic count of "
            "one launch; 0 when the peak is unknown)",
            labels=("engine",))
        self._m_hbm_tok = r.gauge(
            "serving_hbm_bytes_per_token",
            "serving step bytes moved per packed budget token (weights, "
            "KV pages read and written; an analytic count of one launch)",
            labels=("engine",))
        self._m_flops_tok = r.gauge(
            "serving_model_flops_per_token",
            "serving step FLOPs per packed budget token (GEMMs and "
            "attention; an analytic count of one launch)",
            labels=("engine",))

    # ---- sampling -------------------------------------------------------
    def monitor_for(self, engine_id: int,
                    engine=None) -> EngineCapacityMonitor:
        with self._lock:
            m = self.engines.get(int(engine_id))
            if m is None:
                m = self.engines[int(engine_id)] = EngineCapacityMonitor(
                    engine_id, engine=engine,
                    maxlen=self.config.window,
                    halflife_s=self.config.halflife_s)
            if engine is not None and m.engine is None:
                m.engine = engine
            return m

    def _monitors(self) -> List[EngineCapacityMonitor]:
        """One locked snapshot of the monitor map for iteration (the
        step thread may be admitting a late engine concurrently)."""
        with self._lock:
            return list(self.engines.values())

    def drop_engine(self, engine_id: int) -> None:
        """Forget an engine retired from the pool (the router's
        ``remove_engine`` calls this): its frozen windows leave the
        rollup entirely — unlike a LOST engine, whose monitor stays
        for diagnosis with ``healthy=False``."""
        with self._lock:
            self.engines.pop(int(engine_id), None)

    def observe_router(self, router, t: Optional[float] = None) -> str:
        """One router step's sampling + LIGHT planner tick.  Reads
        each healthy handle's ``last_payload`` (refreshed by the
        router's own probe pass — no extra scrapes) and the router's
        pending depth; returns the committed action.  This is the
        per-step hot path, so it deliberately stops at the rollup +
        the scalar gauges — the full plan dict (per-engine signal
        blocks, efficiency gauges) is built lazily on
        :meth:`capacity_plan` / :meth:`evaluate` reads, and the whole
        body runs only every ``sample_every``-th call — the window
        timestamps are real, so decimation changes resolution, not
        the rates."""
        self._observations += 1
        if (self._observations - 1) % self.config.sample_every:
            return self.planner.action
        t = time.perf_counter() if t is None else float(t)
        for h in router.handles.values():
            if h.healthy and h.last_payload:
                # lock-free fast path: dict.get is GIL-atomic, and
                # monitors are only ever INSERTED (under the lock in
                # monitor_for), never removed — the lock matters for
                # insert-during-iteration, not for this lookup
                m = self.engines.get(h.engine_id)
                if m is None:
                    eng = (None if getattr(h, "health_url", None)
                           else h.engine)
                    m = self.monitor_for(h.engine_id, engine=eng)
                m.healthy = True
                m.sample(h.last_payload, t)
            else:
                # a lost engine's windows freeze at their last (often
                # saturated) values — flag its monitor out of the
                # rollup or the planner would chase a ghost forever
                with self._lock:
                    m = self.engines.get(h.engine_id)
                if m is not None:
                    m.healthy = False
        self.w_pending.add(len(router.pending), t)
        return self.tick()

    # ---- rollup + plan --------------------------------------------------
    def fleet_signals(self) -> Dict[str, float]:
        """The fleet rollup, off DIRECT window reads (a few locked
        endpoint reads per engine — the per-step budget; the verbose
        per-engine dicts are plan-time only)."""
        sat_sum, w_sum, tps = 0.0, 0, 0.0
        spread_lo, spread_hi = None, None
        monitors = [m for m in self._monitors() if m.healthy]
        for m in monitors:
            s = m.w_saturation.ewma()
            if s is None:
                continue
            slots = max(1, int(m.last_payload.get("slots", 1)))
            sat_sum += s * slots
            w_sum += slots
            tps += m.w_tokens.rate()
            spread_lo = s if spread_lo is None else min(spread_lo, s)
            spread_hi = s if spread_hi is None else max(spread_hi, s)
        sat = (sat_sum / w_sum) if w_sum else 0.0
        return {
            "saturation": float(sat),
            "headroom": float(1.0 - sat),
            "saturation_spread": float((spread_hi - spread_lo)
                                       if spread_hi is not None else 0.0),
            "tokens_per_s": float(tps),
            "pending": float(self.w_pending.last() or 0.0),
            "queue_growth_per_s": self.w_pending.derivative(),
            "engines": len(monitors),
        }

    def tick(self) -> str:
        """One light planner tick: rollup -> hysteresis/dwell ->
        gauges (one-hot recommendation only rewritten on an action
        CHANGE; the scalar gauges every 16th tick and on every plan
        read, so a scrape after a read is exact).  Invalidates the
        cached plan."""
        fleet = self.fleet_signals()
        action = self.planner.evaluate(fleet)
        if action != self._published_action:
            for a, child in self._reco_children.items():
                child.set(1.0 if a == action else 0.0)
            self._published_action = action
        while self._n_transitions_published < len(self.planner.actions):
            a = self.planner.actions[self._n_transitions_published]
            self._trans_children[a].inc()
            self._n_transitions_published += 1
        if self.planner.evaluations % 16 == 1:
            self._publish_scalar_gauges(fleet)
        self._fleet = fleet
        self._plan = None
        return action

    def _publish_scalar_gauges(self, fleet: Dict) -> None:
        self._m_sat.set(fleet["saturation"])
        self._m_headroom.set(fleet["headroom"])
        self._m_tps.set(fleet["tokens_per_s"])

    def evaluate(self) -> Dict:
        """Full evaluation: one planner tick, then the complete plan
        dict (per-engine signal blocks + efficiency gauges)."""
        self.tick()
        return self.capacity_plan()

    def _build_plan(self) -> Dict:
        fleet = self._fleet if self._fleet is not None \
            else self.fleet_signals()
        # any plan read leaves the scrape exact (gauges are otherwise
        # refreshed every 16th tick)
        self._publish_scalar_gauges(fleet)
        action = self.planner.action
        engines = {}
        for m in self._monitors():
            eid = m.engine_id
            engines[str(eid)] = sig = m.signals()
            sig["healthy"] = m.healthy
            if not m.healthy:
                # frozen windows: keep the block for diagnosis, but
                # publish no rates-derived efficiency off it
                continue
            eff = m.efficiency(compute=False,
                               peak_flops=self.peak_flops)
            if eff is not None:
                sig["efficiency"] = eff
                e = str(eid)
                self._m_mfu.labels(engine=e).set(eff["mfu"])
                self._m_hbm_tok.labels(engine=e).set(
                    eff["hbm_bytes_per_token"])
                self._m_flops_tok.labels(engine=e).set(
                    eff["flops_per_token"])
        return {
            "action": action,
            "since_evaluations": self.planner.since,
            "evaluations": self.planner.evaluations,
            "transitions": list(self.planner.actions),
            "fleet": fleet,
            "engines": engines,
            # the actuator's work order — concrete
            # (source, target) engine pairs ranked by saturation
            # spread, so a rebalance recommendation names exactly
            # which engines shed to which (no re-derivation)
            "rebalance_pairs": self.rebalance_pairs(),
            "bands": {
                "high_watermark": self.config.high_watermark,
                "high_clear": self.config.high_clear,
                "low_watermark": self.config.low_watermark,
                "low_clear": self.config.low_clear,
                "imbalance_threshold": self.config.imbalance_threshold,
                "min_dwell": self.config.min_dwell,
            },
        }

    def rebalance_pairs(self) -> List[Dict]:
        """Concrete rebalance work orders: the most-saturated healthy
        engine paired with the least-saturated, second-most with
        second-least, and so on — ranked by per-pair saturation
        spread, keeping only pairs whose spread is positive.  The
        elastic actuator moves pages/requests source -> target
        verbatim; ``/healthz["capacity"]["rebalance_pairs"]`` carries
        the same list."""
        sats = []
        for m in self._monitors():
            if not m.healthy:
                continue
            s = m.w_saturation.ewma()
            if s is not None:
                sats.append((float(s), int(m.engine_id)))
        if len(sats) < 2:
            return []
        sats.sort(key=lambda t: (-t[0], t[1]))
        pairs = []
        for i in range(len(sats) // 2):
            hi_s, hi_id = sats[i]
            lo_s, lo_id = sats[-1 - i]
            spread = hi_s - lo_s
            if spread <= 0.0:
                break
            pairs.append({"source_engine": hi_id,
                          "target_engine": lo_id,
                          "spread": round(spread, 6)})
        return pairs

    def capacity_plan(self) -> Dict:
        """The committed plan, built lazily off the last tick's
        rollup (a never-ticked monitor plans ``steady`` over whatever
        has been sampled; reads never advance the planner — dwell
        counts router steps, not scrapes)."""
        if self._plan is None:
            self._plan = self._build_plan()
        return self._plan

    def refresh_efficiency(self, compute: bool = True) -> Dict[str, Dict]:
        """Force the per-engine efficiency blocks (in-process engines
        only; ``compute=True`` triggers each engine's lazy env-gated
        probe).  Returns {engine_id: block} for engines
        that produced numbers; gauges refresh on the next evaluate."""
        out = {}
        for m in self._monitors():
            eff = m.efficiency(compute=compute,
                               peak_flops=self.peak_flops)
            if eff is not None:
                out[str(m.engine_id)] = eff
        return out


def resolve_capacity_monitor(capacity) -> Optional[FleetCapacityMonitor]:
    """The one ``capacity=`` knob parser (mirrors ``resolve_tracer``):
    None/False -> no monitoring (the router runs its plain step
    loop); True -> a default-config :class:`FleetCapacityMonitor`; a
    :class:`CapacityConfig` -> a monitor with those bands; a prebuilt
    monitor passes through."""
    if capacity is None or capacity is False:
        return None
    if capacity is True:
        return FleetCapacityMonitor()
    if isinstance(capacity, CapacityConfig):
        return FleetCapacityMonitor(capacity)
    if isinstance(capacity, FleetCapacityMonitor):
        return capacity
    raise ValueError(
        "capacity= must be None/False, True, a CapacityConfig, or a "
        "FleetCapacityMonitor; got %r" % (capacity,))
