"""Multi-engine serving router: one admission plane over N engines (a
copy of ``paddle_tpu/inference/router.py`` over the port's engine,
prefix cache and observability modules).

A :class:`ServingRouter` owns a pool of :class:`ContinuousBatchingEngine`
instances — heterogeneous configs allowed (mixed-step, quantized,
speculative; anything satisfying the small engine protocol below) —
behind one front door.  Three responsibilities:

**Prefix-affinity routing.**  A request's routing key is the SAME chain
of block-granularity blake2b prompt-prefix digests the engines'
``PrefixPageCache`` registers pages under (``routing_keys``), so the
router can steer a request to the engine whose prefix set has the
longest match — its shared pages are ALREADY there, and admission turns
into a refcount bump + suffix-only prefill instead of a full prompt
recompute.  The match consults the engine's LIVE prefix table (ground
truth, eviction included) plus a bounded router-side record of prompts
recently routed there (so two same-prefix requests co-locate even while
the first is still prefilling).  No match -> least-loaded fallback: the
load score folds slot occupancy, KV-page utilization and prefill
chunk-queue depth — the same stats the observability gauges read,
scraped either in-process (``engine.health_payload()``) or over HTTP
from the round-9 ``/healthz`` endpoint (whose body now carries them as
JSON).

**SLO-aware admission.**  ``submit`` takes a per-request ``priority``
plus optional TTFT/TPOT targets — the TTFT target orders the queue
(earliest deadline first among equal priorities) and lets an
affinity-held request spill once its deadline passes; the TPOT target
shields a running request from preemption while an equal-priority
victim without one exists; the pending queue is BOUNDED
(``max_pending``, overflow raises :class:`RouterQueueFull` and counts
``outcome="rejected"``) and drains highest-priority-first (ties: the
earliest TTFT deadline, then FIFO).  When every healthy engine is full
and a pending request outranks some running one, the router preempts
the cheapest strictly-lower-priority victim through the engine's public
``preempt_request`` API — the refcounted ``free_sequence`` release
path, NOT victim truncation — and requeues it: the victim resumes on
whatever engine next has room, its already-generated tokens re-prefixed
onto the prompt.  Greedy decoding makes the resumed stream byte-
identical to an uninterrupted run (the bench gate).

**Failure handling.**  Every engine is probed each ``step()`` (payload
fetch by default, pluggable per handle); ``probe_failure_threshold``
consecutive failures — or an exception escaping ``engine.step()`` —
marks the engine unhealthy and DRAINS it: every in-flight request is
pulled off (via ``preempt_request`` while the engine's host state still
answers, else the router's own last-known token record) and requeued,
zero drops.  A recovered engine re-admits via ``recover_engine``.

**Request tracing + SLO attainment.**  The router owns a
bounded :class:`~paddle_tpu_torch.observability.RequestTracer` (default ON;
``tracer=False`` drops to the no-op stub) recording every request's
typed phase chain — enqueue, affinity-hold rounds, the route decision
(engine + prefix/least-loaded/spilled/random outcome), dispatch,
first token, preempt/requeue/engine-lost hops with the destination
engine, finish — and keeps per-hop ``(engine, engine_req_id,
t_dispatch, t_leave)`` records so
:func:`~paddle_tpu_torch.observability.fleet_trace` can merge the router's
and every engine's spans into ONE chrome trace with flow arrows
across engines.  At completion the measured TTFT (submit -> first
token, across requeues) and mean TPOT are judged against the request's
declared targets — ``router_slo_attained_total{kind,outcome}`` — and
fed into bounded reservoirs whose p50/p95/p99 digests surface in
:meth:`ServingRouter.health_payload` (wire it to ``/healthz`` via
``set_health_provider``) and the
``router_latency_quantile_seconds{kind,q}`` gauges; the same summary
is attached to each finished record (``RouterRequest.summary``) so
streaming callers read the numbers off ``pop_record`` without
scraping metrics.

**KV page migration + disaggregation.**  Requests no longer
lose their KV when they move: every preempt/drain path tries the
engine's ``extract_request`` first — the sequence's physical pages
(int8 codes + per-page scale rows) serialize to ONE host buffer per
dtype — and the next dispatch tries ``inject_request``, scattering
them into the target pool in one indexed write so the stream
resumes with ZERO re-prefill (geometry mismatch degrades to the
re-prefill resume).  Pools mixing engine ``role``\\ s get disaggregated
dispatch: fresh prompts route to ``role="prefill"`` specialists (big
token budgets), and once a request's prefill completes there the
``_migrate_ready`` sweep moves its pages to a ``role="decode"``
specialist (high slot counts, int8 KV) — TTFT is paid on the prefill
tier, TPOT is isolated on the decode tier.  All-"mixed" pools (the
default) behave exactly as before.

**Capacity & efficiency plane (``capacity=``).**  A router built with
``capacity=True`` (or a
:class:`~paddle_tpu_torch.observability.CapacityConfig`) samples every
probe-refreshed engine payload into bounded per-engine
``SignalWindow``\\ s once per step — rolling tokens/s, admission and
preempt rates, queue-depth growth, prefix-hit-rate drift, host-tier
spill/restore pressure, saturation EWMA — and folds the fleet rollup
through a hysteresis + minimum-dwell planner into an advisory action
(``scale_up`` / ``scale_down`` / ``rebalance`` / ``steady``) exposed
via :meth:`ServingRouter.capacity_plan`,
``health_payload()["capacity"]`` (hence ``/healthz``) and the
``router_capacity_*`` metrics; per-engine serving-step MFU and
HBM-bytes/token gauges ride the same plane off the engines'
``efficiency_stats``.  :class:`~paddle_tpu_torch.inference.elastic.
ElasticController` acts on the plan.  Default off: an unconfigured
router runs its plain step loop.

**Remote engines.**  A :class:`~paddle_tpu_torch.inference.fleet.
RemoteEngineClient` stands in for an engine in another process: the
router fans one ``step`` out to every remote engine before collecting
any reply, and an exhausted RPC takes the engine-lost drain.

Engine protocol (what a pool member must provide): ``add_request(
prompt_ids, max_new_tokens=, eos_token_id=)`` appending to ``waiting``,
``step() -> finished req_ids``, ``has_work()``, ``finished`` dict,
``preempt_request(req_id)``, ``health_payload()``, ``block_size``, and
optionally ``prefix_cache``/``engine_id``/``tracer``/``role``/
``extract_request``/``inject_request`` — i.e. the public surface of
``ContinuousBatchingEngine``.

All router state is host control flow: no device math.
"""
from __future__ import annotations

import itertools
import json as _json
import time
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .fleet import EngineRPCError, RetryPolicy
from .prefix_cache import _prefix_key

__all__ = ["ServingRouter", "EngineHandle", "RouterRequest",
           "RouterQueueFull", "routing_keys", "load_score"]


class RouterQueueFull(RuntimeError):
    """``submit`` refused: the bounded pending queue is at capacity."""


# fallback ids for pool members that don't carry an ``engine_id``
# attribute (the protocol lists it as optional): drawn from a high
# base so they never collide with explicit small ids
_FALLBACK_ENGINE_IDS = itertools.count(1 << 30)


def routing_keys(prompt_ids, block_size: int) -> List[bytes]:
    """The request's routing-key chain: blake2b digests of the token
    prefix up to each full page boundary — EXACTLY the keys
    ``PrefixPageCache`` registers pages under, so a key present in an
    engine's table means that engine already holds the KV pages for
    that prefix."""
    prompt_ids = np.asarray(prompt_ids, np.int64).reshape(-1)
    return [_prefix_key(prompt_ids, (i + 1) * block_size)
            for i in range(len(prompt_ids) // block_size)]


def load_score(payload: Dict) -> float:
    """Scalar load from a health payload — lower is better::

        (occupancy + waiting) / slots        # slot pressure
        + 1 - free_pages / total_pages       # KV-page utilization
        + chunk_queue_depth / slots          # prefill backlog

    Each term is O(1)-ish in [0, ~1] so no single axis dominates;
    missing fields read as unloaded (a thin healthz responder still
    routes sanely)."""
    slots = max(1, int(payload.get("slots", 1)))
    total = max(1, int(payload.get("total_pages", 1)))
    free = float(payload.get("free_pages", total))
    return ((float(payload.get("occupancy", 0))
             + float(payload.get("waiting", 0))) / slots
            + 1.0 - free / total
            + float(payload.get("chunk_queue_depth", 0)) / slots)


@dataclass
class RouterRequest:
    """One request as the ROUTER tracks it — the authoritative record
    that survives engine loss: the original prompt, every token any
    engine generated for it (``base_output`` after a requeue), and the
    SLO fields admission orders on."""
    rid: int
    prompt_ids: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    priority: int = 0
    ttft_target: Optional[float] = None
    tpot_target: Optional[float] = None
    state: str = "pending"          # pending -> dispatched -> done
    engine_id: int = -1
    engine_req_id: int = -1
    engine_req: object = field(default=None, repr=False)
    # tokens generated on PREVIOUS engines (re-prefixed on requeue);
    # output_ids is the final base + last engine's stream
    base_output: List[int] = field(default_factory=list)
    output_ids: List[int] = field(default_factory=list)
    requeues: int = 0
    truncated: bool = False
    routed_by_prefix: bool = False
    # router rounds this request was HELD for a full affinity target
    # (bounded by affinity_wait_steps before spilling to least-loaded)
    affinity_waited: int = 0
    # engines whose add_request rejected this request (ValueError:
    # pages / block-table geometry).  The rejection is static for a
    # given prompt length and only tightens as the resume prompt
    # grows, so these engines are excluded from ranking AND from
    # preemption — preempting a victim on an engine that cannot hold
    # this request would be pure churn
    rejected_engines: set = field(default_factory=set)
    # the KV pages extracted off the engine this request
    # last ran on (a host KVPageBuffer) — the next dispatch tries
    # inject_request first, resuming with ZERO re-prefill; dropped
    # after any successful dispatch (tokens then outgrow its coverage)
    kv_buffer: object = field(default=None, repr=False)
    # prefill→decode page migrations (the disaggregated-serving hop;
    # these also count one requeue each, reason="migrated")
    migrations: int = 0
    # routing-key chains memoized per block size (hashing the prompt
    # prefix chain is O(L^2/bs) bytes — computing it once per resume
    # prompt instead of per engine per round keeps ranking cheap);
    # cleared on requeue, when the resume prompt grows
    key_cache: Dict[int, List[bytes]] = field(default_factory=dict,
                                              repr=False)
    # one entry per dispatch: [engine_id, engine_req_id, t_dispatch,
    # t_leave] (t_leave None while the segment is live) — the hop
    # record fleet_trace draws cross-engine flow arrows from and the
    # summary's engines_visited reads
    hops: List[list] = field(default_factory=list, repr=False)
    # final per-request numbers (ttft, mean_tpot, requeues,
    # engines_visited, slo outcomes), set at completion — streaming
    # callers read these off the finished record instead of scraping
    # process-wide metrics
    summary: Optional[Dict] = None
    t_submit: float = 0.0
    # pending-phase start: t_submit, then each requeue mark (the
    # tracer's pending spans must tile requeue waits too)
    t_requeued: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    def engines_visited(self) -> List[int]:
        return [h[0] for h in self.hops]

    def resume_prompt(self) -> np.ndarray:
        """Prompt for (re-)admission: original tokens plus everything
        already generated — a greedy engine prefilling this emits the
        exact continuation the preempted stream would have."""
        if not self.base_output:
            return self.prompt_ids
        return np.concatenate(
            [self.prompt_ids,
             np.asarray(self.base_output, np.int64)])

    def remaining_budget(self) -> int:
        return self.max_new_tokens - len(self.base_output)

    def deadline(self) -> float:
        # `is not None`: ttft_target=0.0 is the MOST urgent deadline
        # (now), not the absence of one
        return self.t_submit + (self.ttft_target
                                if self.ttft_target is not None
                                else float("inf"))

    def routing_keys_for(self, block_size: int) -> List[bytes]:
        keys = self.key_cache.get(block_size)
        if keys is None:
            keys = routing_keys(self.resume_prompt(), block_size)
            self.key_cache[block_size] = keys
        return keys


class EngineHandle:
    """One pool member: the engine (or a URL to scrape it), health
    state, and the router-side prefix-affinity record."""

    # bounded complement of the engine's live prefix table: keys of
    # prompts ROUTED here whose prefill hasn't registered pages yet
    MAX_ROUTED_KEYS = 4096

    def __init__(self, engine, engine_id: Optional[int] = None,
                 health_url: Optional[str] = None,
                 probe: Optional[Callable[["EngineHandle"], bool]] = None,
                 probe_timeout: float = 1.0,
                 retry: Optional[RetryPolicy] = None):
        self.engine = engine
        if engine_id is None:
            engine_id = getattr(engine, "engine_id", None)
        if engine_id is None:
            engine_id = next(_FALLBACK_ENGINE_IDS)
        self.engine_id = int(engine_id)
        self.health_url = health_url
        self._probe = probe
        # remote scrapes run INSIDE the router step loop, serialized:
        # a partitioned endpoint stalls every healthy engine's round
        # for this long per probe, so keep it tight (a slow-but-alive
        # engine that misses it just accrues probe_failures and drains
        # — requests resume elsewhere, nothing is lost)
        self.probe_timeout = float(probe_timeout)
        # /healthz scraping shares the fleet RPC layer's capped-
        # backoff-with-jitter policy: one slow/lost scrape retries
        # inside the probe instead of burning a probe-failure count.
        # The whole retried scrape stays bounded (attempts x timeout
        # + backoff), so a dead endpoint still fails the probe fast.
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay=0.02, max_delay=0.25)
        self.healthy = True
        self.probe_failures = 0
        self.routed_keys: "OrderedDict[bytes, None]" = OrderedDict()
        # refreshed once per router step; dispatch adjusts it locally
        # as it places work so later picks in the same step see the load
        self.last_payload: Dict = {}

    # ---- load ----------------------------------------------------------
    def payload(self) -> Dict:
        """Fresh health/load stats: scraped from ``health_url``'s
        ``/healthz`` JSON body when remote, else read in-process."""
        if self.health_url:
            def _scrape():
                with urllib.request.urlopen(
                        self.health_url,
                        timeout=self.probe_timeout) as resp:
                    return _json.loads(resp.read().decode("utf-8"))
            # urllib.error.URLError is an OSError: the default
            # retry_on covers timeouts, refused and reset connections
            return self.retry.run(_scrape)
        return self.engine.health_payload()

    def refresh(self) -> Dict:
        self.last_payload = self.payload()
        return self.last_payload

    def load(self) -> float:
        return load_score(self.last_payload)

    def has_capacity(self) -> bool:
        p = self.last_payload
        slots = max(1, int(p.get("slots", 1)))
        return (int(p.get("occupancy", 0))
                + int(p.get("waiting", 0))) < slots

    def note_dispatched(self):
        self.last_payload["waiting"] = \
            int(self.last_payload.get("waiting", 0)) + 1

    # ---- health --------------------------------------------------------
    def probe(self) -> bool:
        """One liveness/health check.  Default: the payload fetch
        itself — an engine whose stats cannot be read cannot be routed
        to.  Pluggable per handle for deployments with richer checks;
        a passing custom probe still refreshes the load payload (the
        ranking/capacity signals live there — a routable engine must
        also be readable)."""
        if self._probe is not None:
            try:
                if not self._probe(self):
                    return False
            except Exception:                         # noqa: BLE001
                return False
        try:
            self.refresh()
            return True
        except Exception:                             # noqa: BLE001
            return False

    # ---- prefix affinity -----------------------------------------------
    def prefix_match_tokens(self, prompt_ids, keys=None) -> int:
        """Longest consecutive run of the prompt's routing keys present
        on this engine, in TOKENS (block sizes differ across a
        heterogeneous pool, so token counts are the comparable unit).
        Engines without a prefix cache never match — affinity would buy
        nothing where pages cannot be shared.  ``keys`` takes a
        precomputed chain for this engine's block size (the router
        memoizes it per request — hashing is O(L^2/bs) bytes)."""
        bs = getattr(self.engine, "block_size", 0)
        pc = getattr(self.engine, "prefix_cache", None)
        if not bs or pc is None:
            return 0
        live = pc.table
        n = 0
        for key in (keys if keys is not None
                    else routing_keys(prompt_ids, bs)):
            if key in live or key in self.routed_keys:
                n += 1
            else:
                break
        return n * bs

    def note_routed(self, prompt_ids, keys=None):
        """Record the routed prompt's keys so same-prefix requests
        co-locate before the first prefill registers pages (the live
        table takes over once it does; stale records age out FIFO)."""
        bs = getattr(self.engine, "block_size", 0)
        if not bs or getattr(self.engine, "prefix_cache", None) is None:
            return
        if keys is None:
            keys = routing_keys(prompt_ids, bs)
        for key in keys:
            self.routed_keys[key] = None
            self.routed_keys.move_to_end(key)
        while len(self.routed_keys) > self.MAX_ROUTED_KEYS:
            self.routed_keys.popitem(last=False)


class ServingRouter:
    """N continuous-batching engines behind one admission plane.

    ``engines``: iterable of engines or pre-built :class:`EngineHandle`
    (build handles yourself to attach ``health_url``/custom probes).
    ``route_policy``: ``"affinity"`` (default: prefix match, then
    least-loaded) or ``"random"`` (seeded uniform over engines with
    capacity — the bench's control arm).  ``preempt=False`` disables
    priority preemption (pending requests then only wait).

    The driving loop mirrors a single engine's: ``submit`` any time,
    ``step()`` advances every healthy engine one round, ``result`` after
    the rid shows up in a step's finished list (or ``run_to_completion``
    for batch use).
    """

    def __init__(self, engines, max_pending: int = 256,
                 preempt: bool = True,
                 probe_failure_threshold: int = 1,
                 route_policy: str = "affinity",
                 route_seed: int = 0,
                 affinity_wait_steps: int = 8,
                 max_finished: int = 4096,
                 tracer=None,
                 capacity=None):
        if route_policy not in ("affinity", "random"):
            raise ValueError(
                "route_policy must be 'affinity' or 'random'; got %r"
                % (route_policy,))
        self.handles: "OrderedDict[int, EngineHandle]" = OrderedDict()
        for e in engines:
            h = e if isinstance(e, EngineHandle) else EngineHandle(e)
            if h.engine_id in self.handles:
                raise ValueError(
                    "duplicate engine_id %d in the pool — pass distinct "
                    "engine_id= to the engines (or handles)"
                    % h.engine_id)
            self.handles[h.engine_id] = h
        if not self.handles:
            raise ValueError("ServingRouter needs at least one engine")
        self.max_pending = int(max_pending)
        self.preempt = bool(preempt)
        self.probe_failure_threshold = max(1, int(probe_failure_threshold))
        self.route_policy = route_policy
        self._route_rng = np.random.RandomState(route_seed)
        # a request whose longest prefix match sits on a FULL engine is
        # HELD (its pages are there; waiting one slot-drain usually
        # beats recomputing the prefix elsewhere) — but only this many
        # router rounds, then it spills to least-loaded, recomputes,
        # and REGISTERS the prefix there too (a hot family replicates
        # itself across the pool instead of head-of-line blocking)
        self.affinity_wait_steps = max(0, int(affinity_wait_steps))
        # disaggregated serving: pools mixing engine roles
        # get role-aware ranking (fresh prompts avoid decode
        # specialists, resumed/migrated requests avoid prefill
        # specialists), and a prefill+decode pool runs the
        # prefill→decode page-migration sweep each step.  All-"mixed"
        # pools (the default) see neither — plain behavior untouched.
        self._refresh_roles()
        self.pending: List[RouterRequest] = []
        # bounded completed-request record (a long-running admission
        # plane must not grow without bound): oldest completions are
        # evicted past ``max_finished`` — batch callers either keep
        # a wave under that, consume via pop_result, or raise the cap
        self.max_finished = max(1, int(max_finished))
        self.finished: "OrderedDict[int, RouterRequest]" = OrderedDict()
        # (engine_id, engine_req_id) -> RouterRequest for every
        # dispatched, unfinished request — the drain walks this
        self._inflight: Dict[Tuple[int, int], RouterRequest] = {}
        # every _complete lands its rid here; step() drains it as the
        # return value, so completions that happen OUT OF BAND (a
        # requeue that already met its budget, a mark_unhealthy drain
        # between steps) surface in the next step's list instead of
        # going missing
        self._done_backlog: List[int] = []
        self._next_rid = 0

        from ..observability import default_registry
        from ..observability.request_trace import (LatencyReservoir,
                                                   resolve_tracer)
        from ..observability.capacity import resolve_capacity_monitor
        # fleet capacity & efficiency plane: OFF by default — an
        # unconfigured router runs its plain step loop.  capacity=True
        # (or a CapacityConfig / prebuilt FleetCapacityMonitor) samples
        # every probe-refreshed payload into per-engine SignalWindows
        # once per step and ticks the hysteresis+dwell planner behind
        # ``capacity_plan()`` / ``health_payload()["capacity"]``.
        self.capacity = resolve_capacity_monitor(capacity)
        # bounded per-request phase tracer: default ON —
        # host-side appends only; tracer=False drops to the no-op stub
        self.tracer = resolve_tracer(tracer)
        # measured-latency reservoirs behind the p50/p95/p99 digests in
        # health_payload() and the quantile gauges
        self._ttft_res = LatencyReservoir(1024, seed=1)
        self._tpot_res = LatencyReservoir(1024, seed=2)
        # per-ROUTER attainment counts (the Prometheus counters are
        # process-wide series shared across routers; the completeness
        # gate sums THESE against this router's own admissions)
        self._slo_counts: Dict[Tuple[str, str], int] = {
            (k, o): 0 for k in ("ttft", "tpot")
            for o in ("attained", "missed", "no_target")}
        self._completions = 0
        r = default_registry()
        self._m_requests = r.counter(
            "router_requests_total",
            "requests leaving the router, by outcome (completed / "
            "truncated / rejected-at-the-bounded-queue)",
            labels=("outcome",))
        self._m_prefix_hits = r.counter(
            "router_prefix_route_hits_total",
            "dispatches steered by prefix affinity (the routed engine "
            "already held a nonzero prefix of the prompt)")
        self._m_requeues = r.counter(
            "router_requeues_total",
            "requests pulled off one engine and requeued, by reason "
            "(preempt / engine_lost / migrated — the prefill→decode "
            "disaggregation hop)", labels=("reason",))
        self._m_role_dispatch = r.counter(
            "router_role_dispatch_total",
            "dispatches by the target engine's role (prefill / decode "
            "/ mixed) — the disaggregated-serving placement split",
            labels=("role",))
        self._role_children = {
            role: self._m_role_dispatch.labels(role=role)
            for role in ("prefill", "decode", "mixed")}
        self._m_healthy = r.gauge(
            "router_engine_healthy",
            "1 while the router considers the engine routable, 0 after "
            "mark-unhealthy (probe failures or a step exception)",
            labels=("engine",))
        self._m_pending = r.gauge(
            "router_pending_depth",
            "requests admitted by the router but not yet dispatched "
            "to an engine")
        self._m_slo = r.counter(
            "router_slo_attained_total",
            "completed requests judged against their declared SLO "
            "targets, by kind (ttft / tpot) and outcome (attained / "
            "missed / no_target) — for each kind the outcomes sum to "
            "completed admissions",
            labels=("kind", "outcome"))
        # resolve the six children once (completion-path, but labels()
        # is a lock + probe and the label sets are closed anyway)
        self._slo_children = {
            (k, o): self._m_slo.labels(kind=k, outcome=o)
            for k in ("ttft", "tpot")
            for o in ("attained", "missed", "no_target")}
        self._m_latency_q = r.gauge(
            "router_latency_quantile_seconds",
            "bounded-reservoir latency digests over completed requests "
            "(kind: ttft / tpot; q: p50 / p95 / p99)",
            labels=("kind", "q"))
        self._latq_children = {
            (k, q): self._m_latency_q.labels(kind=k, q=q)
            for k in ("ttft", "tpot") for q in ("p50", "p95", "p99")}
        self._m_pool = r.gauge(
            "router_engine_pool_size",
            "engines currently admitted to the router's pool (healthy "
            "or not) — the elastic actuator's scale_up/scale_down is "
            "what moves this")
        for h in self.handles.values():
            self._m_healthy.labels(engine=str(h.engine_id)).set(1)
        self._m_pool.set(len(self.handles))

    def _refresh_roles(self):
        """Recompute the role-aware dispatch flags — in __init__ and on
        every pool-membership change (an all-'mixed' pool must keep the
        exact plain ranking even after engines come and go)."""
        roles = [getattr(h.engine, "role", "mixed")
                 for h in self.handles.values()]
        self._role_pool = any(r != "mixed" for r in roles)
        self._disagg = ("prefill" in roles
                        and any(r != "prefill" for r in roles))

    # ---- elastic pool membership ----------------------------------------
    def add_engine(self, engine) -> int:
        """Admit one engine (or pre-built :class:`EngineHandle`) to the
        live pool — the elastic actuator's scale_up.  The newcomer is
        routable from the next ``step()``: it probes, ranks (its empty
        slots make it the least-loaded target), and samples into the
        capacity plane like any founding member.  Returns its
        engine_id; a duplicate id raises ValueError."""
        h = engine if isinstance(engine, EngineHandle) \
            else EngineHandle(engine)
        if h.engine_id in self.handles:
            raise ValueError(
                "duplicate engine_id %d in the pool — pass a distinct "
                "engine_id= on the engine (or handle)" % h.engine_id)
        self.handles[h.engine_id] = h
        h.healthy = True
        h.probe_failures = 0
        self._refresh_roles()
        self._m_healthy.labels(engine=str(h.engine_id)).set(1)
        self._m_pool.set(len(self.handles))
        return h.engine_id

    def remove_engine(self, engine_id: int,
                      reason: str = "scale_down") -> Dict[str, int]:
        """Retire one engine from the pool — the elastic actuator's
        scale_down.  Every in-flight request drains off it first
        through the same extract-first requeue the failure path uses
        (KV pages travel, the resume injects with zero re-prefill),
        but with ``reason="scale_down"``: a planned retirement is not
        an ``engine_lost``.  The handle then leaves the pool entirely
        (a removed engine is gone, not parked-unhealthy).  Returns the
        drain fate counts ``{"migrated": n, "re_prefilled": m}``.
        Removing the last engine raises ValueError — a router must
        keep at least one."""
        if engine_id not in self.handles:
            raise KeyError("engine %r is not in the pool" % (engine_id,))
        if len(self.handles) <= 1:
            raise ValueError(
                "refusing to remove the last engine in the pool")
        h = self.handles[engine_id]
        fates = self._drain_engine(h, reason=reason)
        del self.handles[engine_id]
        if self.capacity is not None:
            # its frozen windows must leave the rollup too, or the
            # planner would keep averaging a ghost engine forever
            self.capacity.drop_engine(engine_id)
        self._refresh_roles()
        self._m_healthy.labels(engine=str(engine_id)).set(0)
        self._m_pool.set(len(self.handles))
        return fates

    # ---- public API -----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 16,
               eos_token_id: Optional[int] = None, priority: int = 0,
               ttft_target: Optional[float] = None,
               tpot_target: Optional[float] = None) -> int:
        """Queue one prompt with its SLO envelope; returns the router
        request id.  ``ttft_target`` (seconds) orders the pending
        queue (earliest deadline first among equal priorities) and
        releases an affinity hold once the deadline passes;
        ``tpot_target`` marks the request preempt-last among
        equal-priority victims (a preemption is what blows a per-token
        SLO).  Raises :class:`RouterQueueFull` when the bounded
        pending queue is at ``max_pending`` (counted as
        ``outcome="rejected"`` — shed load at the front door instead
        of growing an unbounded backlog)."""
        if len(self.pending) >= self.max_pending:
            self._m_requests.labels(outcome="rejected").inc()
            raise RouterQueueFull(
                "pending queue at max_pending=%d" % self.max_pending)
        rr = RouterRequest(
            rid=self._next_rid,
            prompt_ids=np.asarray(prompt_ids, np.int64).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            eos_token_id=eos_token_id, priority=int(priority),
            ttft_target=ttft_target, tpot_target=tpot_target)
        self._next_rid += 1
        rr.t_submit = time.perf_counter()
        rr.t_requeued = rr.t_submit
        self.pending.append(rr)
        self._m_pending.set(len(self.pending))
        self.tracer.event(
            rr.rid, "enqueue", ts=rr.t_submit, priority=rr.priority,
            prompt_tokens=len(rr.prompt_ids),
            ttft_target=rr.ttft_target, tpot_target=rr.tpot_target)
        return rr.rid

    def has_work(self) -> bool:
        return bool(self.pending) or bool(self._inflight)

    def step(self) -> List[int]:
        """One router round: probe every engine, dispatch pending work
        (preempting when priorities demand), then advance every healthy
        engine one ``step()``.  Returns every rid that completed since
        the last call — including out-of-band completions (a requeue
        whose tokens already met the budget, a ``mark_unhealthy`` drain
        between steps): callers keying on the returned ids must never
        have one go missing."""
        self._probe_all()
        self._dispatch_pending()
        # remote-engine fan-out: fire every step RPC BEFORE collecting
        # any reply, so N server processes genuinely step concurrently
        # (begin_step is an opportunistic send — failures surface in
        # the per-handle step()/finish below and take the engine-lost
        # path there)
        for h in self.handles.values():
            begin = getattr(h.engine, "begin_step", None)
            if begin is not None and h.healthy and h.engine.has_work():
                begin()
        for h in list(self.handles.values()):
            if not h.healthy:
                continue
            try:
                if h.engine.has_work():
                    for erid in h.engine.step():
                        rr = self._inflight.pop((h.engine_id, erid),
                                                None)
                        if rr is not None:
                            # pop, don't read: the router holds the
                            # authoritative copy, and the engine-side
                            # record would otherwise grow per request
                            # forever in a long-running deployment
                            self._complete(
                                rr, h.engine.finished.pop(erid))
            except Exception:                         # noqa: BLE001
                self._lose_engine(h)
                continue
            # defensive sweep — OUTSIDE the has_work gate: anything of
            # ours in the engine's finished dict that a step() return
            # ever missed (an engine implementation quirk must degrade
            # to a late completion, never to a request the router
            # waits on forever, even once the engine has gone idle)
            for key in [k for k in self._inflight
                        if k[0] == h.engine_id
                        and k[1] in h.engine.finished]:
                rr = self._inflight.pop(key)
                self._complete(rr, h.engine.finished.pop(key[1]))
            self._sync_first_tokens(h)
        if self._disagg:
            self._migrate_ready()
        if self.capacity is not None:
            # one sampling + planner tick per router round, fed from
            # the payloads _probe_all already refreshed (zero extra
            # scrapes; O(1) window appends per engine)
            self.capacity.observe_router(self)
        self._m_pending.set(len(self.pending))
        done, self._done_backlog = self._done_backlog, []
        return done

    def run_to_completion(self) -> Dict[int, List[int]]:
        stalled = 0
        while self.has_work():
            if not any(h.healthy for h in self.handles.values()):
                raise RuntimeError(
                    "ServingRouter: no healthy engines left with %d "
                    "request(s) outstanding — recover_engine() or add "
                    "capacity" % (len(self.pending) + len(self._inflight)))
            n_pending = len(self.pending)
            self.step()
            if (self.pending and not self._inflight
                    and len(self.pending) == n_pending
                    and not any(h.healthy and h.engine.has_work()
                                for h in self.handles.values())):
                # nothing in flight, every engine idle, dispatch placed
                # nothing.  One such step is normal (the engine drained
                # DURING it, after dispatch ran); two in a row means
                # these requests fit NO engine in the pool
                # (pages/block-table limits) — fail loudly, don't spin
                stalled += 1
                if stalled >= 2:
                    raise RuntimeError(
                        "ServingRouter: %d pending request(s) fit no "
                        "engine in the pool (add_request rejected them "
                        "everywhere)" % len(self.pending))
            else:
                stalled = 0
        return {rid: r.output_ids for rid, r in self.finished.items()}

    def result(self, rid: int) -> List[int]:
        return self.finished[rid].output_ids

    def pop_result(self, rid: int) -> List[int]:
        """Consume one finished request's tokens (the streaming-caller
        API: read each rid from ``step()``'s return, pop it, and the
        finished record stays flat regardless of run length).  Callers
        that also want the latency numbers use :meth:`pop_record`."""
        return self.finished.pop(rid).output_ids

    def pop_record(self, rid: int) -> RouterRequest:
        """Consume one finished request's FULL record: tokens in
        ``.output_ids`` plus the final per-request summary in
        ``.summary`` (measured ttft, mean tpot, requeue count, engines
        visited, SLO outcomes) — streaming callers get the numbers
        without scraping process-wide metrics.  Same bounded-`finished`
        eviction semantics as :meth:`pop_result`."""
        return self.finished.pop(rid)

    def _publish_latency_gauges(self, digests: Optional[Dict] = None):
        """Push the reservoir digests into the
        ``router_latency_quantile_seconds{kind,q}`` gauges."""
        for kind, res in (("ttft", self._ttft_res),
                          ("tpot", self._tpot_res)):
            d = (digests or {}).get(kind) or res.digest()
            for tag in ("p50", "p95", "p99"):
                if d[tag] is not None:
                    self._latq_children[(kind, tag)].set(d[tag])

    def slo_snapshot(self) -> Dict[str, Dict]:
        """Per-kind attainment counts + bounded-reservoir latency
        digests (p50/p95/p99) over THIS router's completed requests —
        the ``health_payload()``/``/healthz`` SLO block, and the
        completeness gate's arithmetic source (for each kind the
        outcome counts sum to completed admissions).  Reading a
        snapshot also refreshes the quantile gauges, so a Prometheus
        scrape taken through any health path is exact."""
        out = {}
        for kind, res in (("ttft", self._ttft_res),
                          ("tpot", self._tpot_res)):
            d = {o: self._slo_counts[(kind, o)]
                 for o in ("attained", "missed", "no_target")}
            d.update(res.digest())
            out[kind] = d
        self._publish_latency_gauges(out)
        return out

    def capacity_plan(self) -> Dict:
        """The committed fleet capacity recommendation — windowed
        per-engine signals, fleet rollup, and the advisory action
        (``scale_up`` / ``scale_down`` / ``rebalance`` / ``steady``)
        with the declared hysteresis bands + minimum dwell already
        applied, so an actuator can follow it verbatim without its own
        debouncing.  Requires capacity monitoring: construct with
        ``capacity=True`` (or a ``CapacityConfig`` / prebuilt
        ``FleetCapacityMonitor``)."""
        if self.capacity is None:
            raise ValueError(
                "capacity monitoring is off: construct ServingRouter("
                "capacity=True) (or pass a CapacityConfig / "
                "FleetCapacityMonitor) to enable capacity_plan()")
        return self.capacity.capacity_plan()

    def health_payload(self) -> Dict:
        """Fleet-level load/health snapshot (the router-side twin of
        the engine's ``health_payload``): queue depths, healthy-engine
        count, the SLO attainment digests, and — when capacity
        monitoring is configured — the committed capacity plan.
        Install as the process's health provider
        (``observability.set_health_provider(router.health_payload)``)
        and ``/healthz`` serves it."""
        payload = {
            "router": 1,
            "pending": len(self.pending),
            "inflight": len(self._inflight),
            "engines": len(self.handles),
            "engines_healthy": sum(1 for h in self.handles.values()
                                   if h.healthy),
            "slo": self.slo_snapshot(),
        }
        if self.capacity is not None:
            payload["capacity"] = self.capacity.capacity_plan()
        return payload

    # ---- health ---------------------------------------------------------
    def mark_unhealthy(self, engine_id: int):
        """Operator/test hook: take an engine out of rotation NOW and
        drain-and-requeue everything in flight on it (the same path a
        failed probe or step exception takes)."""
        self._lose_engine(self.handles[engine_id])

    def recover_engine(self, engine_id: int):
        """Re-admit an engine (restarted, or past a transient probe
        blip).  Its router-side affinity record was cleared on loss;
        matching restarts from its LIVE prefix table, which is exactly
        right for both a fresh restart (empty) and a survivor (intact)."""
        h = self.handles[engine_id]
        h.healthy = True
        h.probe_failures = 0
        self._m_healthy.labels(engine=str(h.engine_id)).set(1)

    def _probe_all(self):
        for h in self.handles.values():
            if not h.healthy:
                continue
            if h.probe():
                h.probe_failures = 0
            else:
                h.probe_failures += 1
                if h.probe_failures >= self.probe_failure_threshold:
                    self._lose_engine(h)

    def _lose_engine(self, h: EngineHandle):
        """Mark unhealthy + drain: every in-flight request comes off
        through ``preempt_request`` when the engine's host state still
        answers (refcounted release — a later recovery finds a clean
        pool), else from the router's own record; all requeue with
        reason="engine_lost".  Zero drops by construction: every
        dispatched request is in ``_inflight`` until completed."""
        if not h.healthy:
            return
        h.healthy = False
        h.probe_failures = 0
        self._m_healthy.labels(engine=str(h.engine_id)).set(0)
        self._drain_engine(h, reason="engine_lost")

    def _drain_engine(self, h: EngineHandle,
                      reason: str) -> Dict[str, int]:
        """The one drain body (failure path AND planned scale_down):
        pull every in-flight request off ``h`` extract-first and
        requeue it with ``reason``.  Returns how each drained request
        travels: ``"migrated"`` (its KV pages came with it — the
        resume injects, zero re-prefill) vs ``"re_prefilled"``
        (extraction unsupported/failed; the recompute resume)."""
        fates = {"migrated": 0, "re_prefilled": 0}
        h.routed_keys.clear()
        for (eid, erid) in [k for k in self._inflight
                            if k[0] == h.engine_id]:
            rr = self._inflight.pop((eid, erid))
            gen: List[int] = []
            vbuf = None
            try:
                # extract the victim's KV pages while the engine's
                # device state still answers — the requeued request
                # then resumes elsewhere with ZERO re-prefill; the
                # engine degrades extraction to buffer=None itself
                # when its pools can't travel
                ext = getattr(h.engine, "extract_request", None)
                if ext is not None:
                    _prompt, gen, vbuf = ext(erid)
                else:
                    _prompt, gen = h.engine.preempt_request(erid)
            except Exception:                         # noqa: BLE001
                # the request finished INSIDE the failing step, or the
                # engine is too far gone: consume the engine-side
                # finished record if there is one (popping it — a
                # recovered engine must not strand it forever), else
                # fall back to the live request object's token list
                ereq = None
                try:
                    ereq = h.engine.finished.pop(erid, None)
                except Exception:                     # noqa: BLE001
                    pass
                try:
                    gen = list((ereq or rr.engine_req).output_ids)
                except Exception:                     # noqa: BLE001
                    gen = []
            fates["migrated" if vbuf is not None
                  else "re_prefilled"] += 1
            self._requeue(rr, gen, reason=reason, buffer=vbuf)
        return fates

    # ---- requeue / preemption -------------------------------------------
    def _requeue(self, rr: RouterRequest, gen: List[int], reason: str,
                 buffer=None):
        """Fold the tokens the lost/preempted engine generated into the
        router-side record and put the request back in the pending
        queue (or finish it, if those tokens already met the budget or
        hit EOS).  ``buffer`` carries the KV pages extracted off the
        engine being left (a host ``KVPageBuffer``): the next dispatch
        injects them into the target pool and the request resumes with
        zero re-prefill; None (extraction unsupported or failed)
        degrades to the re-prefill resume."""
        # the first token may have landed on the engine we are leaving
        # without a _sync_first_tokens pass seeing it (preempt/loss
        # between steps): capture its mark off the live engine request
        # BEFORE dropping it, or the measured TTFT would drift to the
        # completion fallback
        if not rr.t_first_token and (gen or rr.base_output):
            t_ft = getattr(rr.engine_req, "t_first_token", 0.0) or 0.0
            rr.t_first_token = t_ft or time.perf_counter()
            self.tracer.event(rr.rid, "first_token",
                              ts=rr.t_first_token,
                              ttft=rr.t_first_token - rr.t_submit)
        now = time.perf_counter()
        left_engine = -1
        if rr.hops and rr.hops[-1][3] is None:
            rr.hops[-1][3] = now
            left_engine = rr.hops[-1][0]
            self.tracer.span(rr.rid, "on_engine", rr.hops[-1][2], now,
                             engine=left_engine)
        rr.t_requeued = now
        rr.base_output.extend(int(t) for t in gen)
        rr.key_cache.clear()            # resume prompt just grew
        # a fresh extraction replaces any stale buffer; extraction
        # failure (None) must also clear it — old pages no longer
        # cover the grown resume prompt
        rr.kv_buffer = buffer
        rr.engine_id = -1
        rr.engine_req_id = -1
        rr.engine_req = None
        rr.requeues += 1
        self.tracer.event(rr.rid, "requeue", ts=now, reason=reason,
                          engine=left_engine, tokens=len(gen))
        self._m_requeues.labels(reason=reason).inc()
        hit_eos = (rr.eos_token_id is not None and rr.base_output
                   and rr.base_output[-1] == rr.eos_token_id)
        if rr.remaining_budget() <= 0 or hit_eos:
            self._complete(rr, None)
            return
        rr.state = "pending"
        self.pending.append(rr)

    def _preempt_and_place(self, rr: RouterRequest,
                           only: Optional[EngineHandle] = None) -> bool:
        """Every engine ``rr`` may use is full and it outranks someone:
        place ``rr`` by preempting the cheapest strictly-lower-priority
        running request (lowest priority first; among equals, requests
        WITHOUT a TPOT target before those with one — a preemption is
        exactly what blows a per-token-latency SLO — then fewest total
        tokens, the smallest re-prefix bill).  ``rr`` is dispatched to
        the victim's engine FIRST (engine queues accept regardless of
        slot occupancy — capacity gating is the router's own notion),
        and the victim is pulled only once that succeeds: an engine
        whose geometry rejects ``rr`` costs a recorded rejection, never
        a pointless preemption.  ``only`` restricts victims to one
        engine — when ``rr`` is holding for its affinity target, a
        preemption anywhere else would not place it."""
        victims = []
        for key, vr in self._inflight.items():
            h = self.handles[key[0]]
            if not h.healthy or vr.priority >= rr.priority:
                continue
            if h.engine_id in rr.rejected_engines:
                continue          # freeing a slot there cannot place rr
            if only is not None and h is not only:
                continue
            if getattr(vr.engine_req, "slot", 0) < 0:
                # dispatched but still in the engine's waiting queue:
                # pulling it frees NO slot — preempting it would strand
                # rr behind the same full slots
                continue
            try:
                n_tok = (len(vr.prompt_ids) + len(vr.base_output)
                         + len(vr.engine_req.output_ids))
            except Exception:                         # noqa: BLE001
                n_tok = len(vr.prompt_ids)
            victims.append(((vr.priority,
                             vr.tpot_target is not None, n_tok,
                             vr.rid), key, vr, h))
        tried = set()
        for _rank, key, vr, h in sorted(victims, key=lambda v: v[0]):
            if h.engine_id in tried:
                continue          # geometry already rejected rr there
            tried.add(h.engine_id)
            preempted_first = False
            if self._buffer_fits(rr, h):
                # rr carries extracted KV that fits this engine:
                # inject_request needs the slot FREE at dispatch time,
                # so pull the victim FIRST — otherwise every
                # preemption-path placement would burn the buffer on
                # the no-free-slot fallback and re-prefill anyway.
                # The geometry pre-check keeps the no-pointless-
                # preemption rule: the buffer is known to fit before
                # anyone is disturbed (a residual add_request
                # rejection after this can still waste one victim —
                # bounded by the rejected_engines memo)
                # a victim that raced to completion left its slot free
                # anyway — either way rr still needs the dispatch below
                self._pull_victim(key, vr, h)
                preempted_first = True
            if not self._dispatch(rr, h, self._match(h, rr)):
                continue
            if not preempted_first:
                if not self._pull_victim(key, vr, h):
                    return True   # raced with completion: slot free
                                  # anyway and rr is already queued
            try:
                h.refresh()
            except Exception:                         # noqa: BLE001
                # scrape died mid-round: take the engine-lost path
                # (rr just landed there and drains right back off)
                self._lose_engine(h)
            return True
        return False

    def _pull_victim(self, key, vr: RouterRequest,
                     h: EngineHandle) -> bool:
        """Preempt one victim off its engine and requeue it —
        extract-first, so its pages travel with it and its resume
        elsewhere skips the re-prefill bill that made preemption
        expensive.  Returns False when the victim raced to completion
        inside the engine (its slot is free regardless)."""
        try:
            ext = getattr(h.engine, "extract_request", None)
            if ext is not None:
                _prompt, gen, vbuf = ext(vr.engine_req_id)
            else:
                _prompt, gen = h.engine.preempt_request(
                    vr.engine_req_id)
                vbuf = None
        except EngineRPCError:
            # the victim's engine died under us: drain it (the victim
            # — and anything else in flight there — requeues off the
            # router's own record inside _lose_engine)
            self._lose_engine(h)
            return False
        except KeyError:
            return False
        self._inflight.pop(key, None)
        self._requeue(vr, gen, reason="preempt", buffer=vbuf)
        return True

    def _buffer_fits(self, rr: RouterRequest, h: EngineHandle) -> bool:
        """Does ``rr``'s extracted KV buffer match ``h``'s pool
        geometry?  The cheap pre-check behind preempt-before-dispatch
        and the disaggregation sweep — never extract or preempt for an
        inject that is known to fail."""
        buf = rr.kv_buffer
        if buf is None or not hasattr(h.engine, "inject_request"):
            return False
        geo = getattr(h.engine, "migration_geometry", None)
        if geo is None:
            return False
        try:
            return geo() == buf.geometry()
        except Exception:                             # noqa: BLE001
            return False

    # ---- disaggregated prefill→decode migration -------------------------
    def _migrate_ready(self):
        """The disaggregation sweep (pools mixing ``role="prefill"``
        and decode-side engines): any request whose prefill COMPLETED
        on a prefill specialist — it is decoding, its first token is
        out — has its KV pages extracted and requeues with
        ``reason="migrated"``; the next dispatch injects them into a
        decode-side engine (role-aware ranking steers it there) and
        the stream continues with zero re-prefill.  TTFT was already
        paid on the prefill specialist, so the move isolates decode
        TPOT from prefill interference without restarting anything.
        Only fires when a decode-side target currently has capacity —
        a full decode tier leaves the request where it runs."""
        for key in list(self._inflight.keys()):
            rr = self._inflight.get(key)
            if rr is None:
                continue
            h = self.handles.get(key[0])
            if h is None or not h.healthy:
                continue
            if getattr(h.engine, "role", "mixed") != "prefill":
                continue
            ereq = rr.engine_req
            if ereq is None or getattr(ereq, "state", "") != "running":
                continue
            if not getattr(ereq, "output_ids", None):
                continue
            # geometry pre-flight: only extract when the source CAN
            # produce a buffer and some decode-side target can take it
            # — otherwise the "migration" degrades to paying the
            # prefill twice (extract fails or inject rejects and the
            # resume re-prefills the whole prompt on the decode tier)
            src_geo = getattr(h.engine, "migration_geometry",
                              lambda: None)()
            if src_geo is None:
                continue
            if not any(t.healthy and t is not h
                       and getattr(t.engine, "role", "mixed") != "prefill"
                       and t.engine_id not in rr.rejected_engines
                       and t.has_capacity()
                       and getattr(t.engine, "migration_geometry",
                                   lambda: None)() == src_geo
                       for t in self.handles.values()):
                continue
            try:
                _prompt, gen, buf = h.engine.extract_request(key[1])
            except Exception:                         # noqa: BLE001
                continue
            self._inflight.pop(key, None)
            rr.migrations += 1
            self._requeue(rr, gen, reason="migrated", buffer=buf)

    # ---- dispatch -------------------------------------------------------
    def _match(self, h: EngineHandle, rr: RouterRequest) -> int:
        """Prefix-match tokens of ``rr`` on ``h``, through the
        request's memoized per-block-size key chain."""
        bs = getattr(h.engine, "block_size", 0)
        if not bs or getattr(h.engine, "prefix_cache", None) is None:
            return 0
        return h.prefix_match_tokens(None,
                                     keys=rr.routing_keys_for(bs))

    def _rank_engines(self, rr: RouterRequest
                      ) -> Tuple[List[Tuple[int, EngineHandle]],
                                 Optional[EngineHandle]]:
        """``(candidates best-first as (match_tokens, handle), hold)``.

        Affinity policy: the longest prefix match over every HEALTHY
        engine decides.  Match on an engine with capacity -> dispatch
        there (ties: load, then engine id).  Match only on FULL engines
        and the request hasn't exhausted its wait budget -> no
        candidates, ``hold`` names the engine worth waiting (or
        preempting) for.  No match (or wait exhausted, or TTFT deadline
        passed) -> least-loaded over capacity-holding engines.
        ``random`` policy shuffles the capacity-holding engines — the
        bench's control arm."""
        healthy = [h for h in self.handles.values()
                   if h.healthy and h.engine_id not in rr.rejected_engines]
        if self._role_pool:
            # disaggregated dispatch: fresh prompts go to prefill
            # specialists (and mixed), resumed/migrated requests to
            # decode specialists (and mixed).  Soft preference: when no
            # preferred engine has capacity the full healthy set stays
            # eligible — role policy must never strand a request a
            # mis-roled engine could serve
            # "fresh" = has no resumable state, so it needs a FULL
            # prefill wherever it lands (a victim preempted while
            # still waiting requeues with no tokens and no KV — it
            # belongs on the prefill tier despite its requeue count)
            fresh = not rr.base_output and rr.kv_buffer is None
            avoid = "decode" if fresh else "prefill"
            preferred = [h for h in healthy
                         if getattr(h.engine, "role", "mixed") != avoid]
            if any(h.has_capacity() for h in preferred):
                healthy = preferred
        cands = [h for h in healthy if h.has_capacity()]
        if self.route_policy == "random":
            order = self._route_rng.permutation(len(cands))
            return [(0, cands[i]) for i in order], None
        scored = [(self._match(h, rr), h) for h in healthy]
        best = max((m for m, _ in scored), default=0)
        if best > 0:
            matching = sorted(
                ((m, h) for m, h in scored if m == best),
                key=lambda mh: (mh[1].load(), mh[1].engine_id))
            with_cap = [(m, h) for m, h in matching
                        if h.has_capacity()]
            if with_cap:
                return with_cap, None
            if (rr.affinity_waited < self.affinity_wait_steps
                    and time.perf_counter() < rr.deadline()):
                return [], matching[0][1]
            # wait budget spent: spill below — the recompute registers
            # the prefix on the spill engine, replicating a hot family
        ranked = sorted(
            ((m, h) for m, h in scored if h.has_capacity()),
            key=lambda mh: (-mh[0], mh[1].load(), mh[1].engine_id))
        return ranked, None

    def _dispatch_pending(self):
        """Drain the pending queue highest-priority-first onto ranked
        engines; requests no engine can hold (or that are holding for
        a full affinity target) stay pending.  Preemption (when
        enabled) triggers for a request that outranks a running one
        once every engine it may use is full."""
        if not self.pending:
            return
        queue, self.pending = self.pending, []
        queue.sort(key=lambda rr: (-rr.priority, rr.deadline(), rr.rid))
        leftover: List[RouterRequest] = []
        for rr in queue:
            placed = False
            hold = None
            while not placed:
                # re-rank after a geometry rejection: the rejected
                # engine just left the candidate set, which can turn a
                # match-only ranking into a least-loaded fallback with
                # FREE capacity — preemption must stay the last resort
                n_rej = len(rr.rejected_engines)
                ranked, hold = self._rank_engines(rr)
                for match, h in ranked:
                    if self._dispatch(rr, h, match):
                        placed = True
                        break
                if placed or len(rr.rejected_engines) == n_rej:
                    break        # no new rejections: re-ranking is moot
            if not placed and self.preempt:
                placed = self._preempt_and_place(rr, only=hold)
            if not placed:
                if hold is not None:
                    rr.affinity_waited += 1
                    self.tracer.event(
                        rr.rid, "affinity_hold",
                        engine=hold.engine_id,
                        hold_round=rr.affinity_waited)
                leftover.append(rr)
        # preemption victims appended themselves to self.pending
        self.pending = leftover + self.pending

    def _dispatch(self, rr: RouterRequest, h: EngineHandle,
                  match: int) -> bool:
        """Hand one request to one engine.  A ValueError from
        ``add_request`` means THIS engine cannot hold the request
        (heterogeneous pools: too few pages, narrow block table) — the
        caller tries the next candidate.

        A request carrying extracted KV pages (``rr.kv_buffer``) tries
        ``inject_request`` FIRST — migrated resume, zero re-prefill;
        an engine that cannot take the buffer (geometry/kv_dtype
        mismatch, no free slot) falls back to ``add_request`` on the
        same engine (re-prefill resume, the path).  Either way a
        successful dispatch consumes the buffer — the request's tokens
        outgrow its coverage from here on."""
        injected = False
        erid = None
        if rr.kv_buffer is not None:
            inject = getattr(h.engine, "inject_request", None)
            if inject is not None:
                try:
                    erid = inject(rr.resume_prompt(), rr.kv_buffer,
                                  max_new_tokens=rr.remaining_budget(),
                                  eos_token_id=rr.eos_token_id)
                    injected = True
                except EngineRPCError:
                    # dead remote engine: don't burn a second retry
                    # cycle on the add_request fallback
                    self._lose_engine(h)
                    return False
                except (ValueError, RuntimeError):
                    erid = None     # fall through to re-prefill resume
        if not injected:
            try:
                erid = h.engine.add_request(
                    rr.resume_prompt(),
                    max_new_tokens=rr.remaining_budget(),
                    eos_token_id=rr.eos_token_id)
            except EngineRPCError:
                # a remote engine whose RPCs exhausted their retries is
                # LOST, not "too small" — drain it (requeues anything
                # in flight there) and try the next candidate; rr is
                # not in _inflight yet so it stays pending either way
                self._lose_engine(h)
                return False
            except ValueError:
                rr.rejected_engines.add(h.engine_id)
                return False
        rr.kv_buffer = None
        rr.state = "dispatched"
        rr.engine_id = h.engine_id
        rr.engine_req_id = erid
        if injected:
            # inject_request lands straight on a slot, not the waiting
            # queue — find the live request object there
            rr.engine_req = next(
                (r for r in getattr(h.engine, "slots", [])
                 if r is not None and r.req_id == erid), None)
        else:
            # add_request APPENDS to the engine's waiting queue — grab
            # the live request object for host-side sync (first-token
            # marks, drain fallback)
            rr.engine_req = (h.engine.waiting[-1]
                             if h.engine.waiting else None)
        rr.routed_by_prefix = match > 0
        now = time.perf_counter()
        rr.hops.append([h.engine_id, erid, now, None])
        if self.tracer.enabled:
            # ONE record: a "dispatch" SPAN covering the pending wait
            # (submit..dispatch / requeue..re-dispatch — the tile the
            # chain validator checks) whose args carry the route
            # decision and its affinity outcome
            outcome = ("prefix" if match > 0 else
                       "random" if self.route_policy == "random" else
                       "spilled" if rr.affinity_waited else
                       "least_loaded")
            self.tracer.span(rr.rid, "dispatch", rr.t_requeued, now,
                             engine=h.engine_id, match_tokens=match,
                             route=outcome, requeues=rr.requeues,
                             migrated=injected)
        if match > 0:
            self._m_prefix_hits.inc()
        role = getattr(h.engine, "role", "mixed")
        self._role_children.get(role, self._role_children["mixed"]).inc()
        bs = getattr(h.engine, "block_size", 0)
        if bs and getattr(h.engine, "prefix_cache", None) is not None:
            h.note_routed(None, keys=rr.routing_keys_for(bs))
        h.note_dispatched()
        self._inflight[(h.engine_id, erid)] = rr
        return True

    # ---- completion -----------------------------------------------------
    def _sync_first_tokens(self, h: EngineHandle):
        """TTFT marks for requests whose first token just landed on
        this engine (pure host-side reads of the live request object)."""
        for key, rr in self._inflight.items():
            if key[0] != h.engine_id or rr.t_first_token:
                continue
            if rr.base_output:
                # a requeued request's first token predates this engine
                continue
            ereq = rr.engine_req
            if ereq is not None and ereq.output_ids:
                rr.t_first_token = (ereq.t_first_token
                                    or time.perf_counter())
                self.tracer.event(rr.rid, "first_token",
                                  ts=rr.t_first_token,
                                  ttft=rr.t_first_token - rr.t_submit)

    def _complete(self, rr: RouterRequest, ereq) -> None:
        rr.output_ids = rr.base_output + (list(ereq.output_ids)
                                          if ereq is not None else [])
        rr.truncated = bool(getattr(ereq, "truncated", False))
        rr.state = "done"
        rr.t_done = time.perf_counter()
        if not rr.t_first_token:
            rr.t_first_token = (getattr(ereq, "t_first_token", 0.0)
                                or rr.t_done)
            self.tracer.event(rr.rid, "first_token",
                              ts=rr.t_first_token,
                              ttft=rr.t_first_token - rr.t_submit)
        if rr.hops and rr.hops[-1][3] is None:
            # close the final engine segment (a request finishing
            # through the requeue path closed it there already)
            rr.hops[-1][3] = rr.t_done
            self.tracer.span(rr.rid, "on_engine", rr.hops[-1][2],
                             rr.t_done, engine=rr.hops[-1][0])
        rr.engine_req = None
        rr.kv_buffer = None     # finished records must not pin page KV
        self._account_slo(rr)
        self.finished[rr.rid] = rr
        while len(self.finished) > self.max_finished:
            self.finished.popitem(last=False)
        self._done_backlog.append(rr.rid)
        outcome = "truncated" if rr.truncated else "completed"
        self._m_requests.labels(outcome=outcome).inc()
        self.tracer.event(
            rr.rid, "finish", ts=rr.t_done, outcome=outcome,
            tokens=len(rr.output_ids), requeues=rr.requeues,
            ttft_outcome=rr.summary["slo"]["ttft"],
            tpot_outcome=rr.summary["slo"]["tpot"])

    def _account_slo(self, rr: RouterRequest) -> None:
        """Judge the finished request's MEASURED latencies against its
        declared targets, feed the reservoirs/quantile gauges, and
        attach the per-request summary to the record.  Every completion
        contributes exactly one outcome per kind, so for each kind the
        attainment counters sum to completed admissions (the bench's
        arithmetic gate)."""
        n = len(rr.output_ids)
        ttft = rr.t_first_token - rr.t_submit
        if ttft < 0 or not n:
            ttft = None                      # nothing ever streamed
        mean_tpot = ((rr.t_done - rr.t_first_token) / (n - 1)
                     if n > 1 and rr.t_first_token else None)
        if ttft is None or rr.ttft_target is None:
            ttft_out = "no_target" if rr.ttft_target is None else "missed"
        else:
            ttft_out = ("attained" if ttft <= rr.ttft_target
                        else "missed")
        if rr.tpot_target is None or mean_tpot is None:
            # an unmeasurable TPOT (0/1-token output) has no per-token
            # stream to judge — it counts as untargeted, keeping the
            # per-kind sum equal to completions
            tpot_out = "no_target"
        else:
            tpot_out = ("attained" if mean_tpot <= rr.tpot_target
                        else "missed")
        self._slo_counts[("ttft", ttft_out)] += 1
        self._slo_counts[("tpot", tpot_out)] += 1
        self._slo_children[("ttft", ttft_out)].inc()
        self._slo_children[("tpot", tpot_out)].inc()
        if ttft is not None:
            self._ttft_res.add(ttft)
        if mean_tpot is not None:
            self._tpot_res.add(mean_tpot)
        # quantile gauges are published every 16th completion (and on
        # every slo_snapshot/health_payload read, which recomputes
        # exactly): completions stay O(1) reservoir adds instead of
        # six sorted-window passes each
        self._completions += 1
        if self._completions % 16 == 1:
            self._publish_latency_gauges()
        rr.summary = {
            "tokens": n,
            "ttft": ttft,
            "mean_tpot": mean_tpot,
            "requeues": rr.requeues,
            "migrations": rr.migrations,
            "engines_visited": rr.engines_visited(),
            "outcome": "truncated" if rr.truncated else "completed",
            "ttft_target": rr.ttft_target,
            "tpot_target": rr.tpot_target,
            "slo": {"ttft": ttft_out, "tpot": tpot_out},
        }
