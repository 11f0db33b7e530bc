"""Fleet request tracing: per-request phase spans + SLO attainment (a
copy of ``paddle_tpu/observability/request_trace.py``).

A request's lifecycle through the multi-engine router (pending-queue
wait, affinity hold, the route decision, dispatch, per-chunk prefill,
first token, decode, preempt/requeue/migration hops onto other engines,
finish) is recorded end to end, and the SLO targets admission orders on
(``ttft_target`` / ``tpot_target``) are measured for attainment:

- :class:`RequestTracer` — a bounded, thread-safe log of TYPED
  per-request phase events/spans keyed by request id.  Every engine and
  every router owns one by default (``tracer=False`` drops to the
  no-op :data:`NULL_TRACER` stub).  All records are host control flow
  on the shared ``perf_counter`` clock: no device work.
- :func:`fleet_trace` — merges the router's spans and every pool
  engine's spans into ONE chrome://tracing JSON (through
  ``merge_chrome_trace``): the router and each engine render as
  separate track groups (pids), every request is one lane (tid), and a
  requeued request's spans CHAIN across engines via chrome flow
  events (``ph: "s"/"f"``).
- :func:`validate_span_chain` — the completeness contract: a dispatched
  request's router-side chain must be gap-free (enqueue -> dispatch ->
  ... -> finish, every requeue hop re-dispatched, pending/on-engine
  spans tiling submit..done with no temporal hole).
- :class:`LatencyReservoir` — bounded reservoir sample (Algorithm R,
  seeded: deterministic) backing the router's p50/p95/p99 TTFT/TPOT
  digests in ``health_payload()`` / ``/healthz``; the Prometheus twin
  is the ``router_latency_quantile_seconds{kind,q}`` gauge family.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["RequestTracer", "NullRequestTracer", "NULL_TRACER",
           "resolve_tracer", "LatencyReservoir", "validate_span_chain",
           "fleet_trace", "REQUEST_TRACE_CAP", "EVENTS_PER_REQUEST_CAP"]

# bounds: a week-long serving job must not grow tracer state without
# limit — oldest REQUESTS evict first (the recent window is the one an
# operator pulls a trace for), and a runaway per-request stream (long
# decode) stops recording past the per-request cap (counted, so the
# drop is visible).  BULK spans (prefill chunks, sampled decode steps)
# stop _LIFECYCLE_RESERVE entries early: the handful of lifecycle
# INSTANTS (finish, preempt, requeue marks) always have room, so a
# production-length generation's lane still shows how it ended
REQUEST_TRACE_CAP = 4096
EVENTS_PER_REQUEST_CAP = 256
_LIFECYCLE_RESERVE = 16     # cap slice bulk spans may not consume
_METRIC_FLUSH = 64          # batched counter-update granularity


class NullRequestTracer:
    """No-op stub with the full tracer surface: the ``tracer=False``
    engine/router drop-in, and the overhead bench's control arm."""

    enabled = False

    def event(self, rid, kind, ts=None, **args):
        pass

    def span(self, rid, kind, start, end, **args):
        pass

    def sample_span(self, rid, kind, start, end, every=1, **args):
        pass

    def events(self, rid) -> List[tuple]:
        return []

    def request_ids(self) -> List[int]:
        return []

    def kind_count(self, rid, kind) -> int:
        return 0

    def dropped(self) -> int:
        return 0

    def clear(self):
        pass

    def flush_metrics(self):
        pass

    def chrome_events(self, rename=None) -> List[dict]:
        return []


NULL_TRACER = NullRequestTracer()


class RequestTracer:
    """Bounded, thread-safe per-request phase log.

    Entries are ``(ph, kind, t_start, t_end, args)`` tuples per request
    id — ``ph`` is the chrome phase ("X" completed span, "i" instant) —
    appended in lifecycle order under one lock (router thread + engine
    step thread + an HTTP scraper may interleave).  Timestamps are
    ``time.perf_counter`` seconds: every tracer in the process shares
    the clock, so :func:`fleet_trace` merges them onto one timeline
    with no per-source renormalization.
    """

    enabled = True

    def __init__(self, max_requests: int = REQUEST_TRACE_CAP,
                 max_events_per_request: int = EVENTS_PER_REQUEST_CAP):
        self.max_requests = max(1, int(max_requests))
        self.max_events_per_request = max(1, int(max_events_per_request))
        # completed spans stop here; instants may fill the rest — the
        # lifecycle reserve (see _LIFECYCLE_RESERVE)
        self._span_cap = max(1, self.max_events_per_request
                             - _LIFECYCLE_RESERVE)
        self._lock = threading.Lock()
        # rid -> {"events": [entry], "counts": {kind: n}, "dropped": n}
        # (plain dict: insertion-ordered on py3.7+, and the hot path is
        # one lookup + one list append — this sits inside the engine
        # step loop, so every dict op counts)
        self._reqs: Dict[int, dict] = {}
        self._dropped_total = 0
        from .metrics import default_registry
        r = default_registry()
        self._m_spans = r.counter(
            "request_trace_spans_total",
            "phase spans/events recorded by request tracers in this "
            "process (flushed in batches off the record hot path)")
        self._m_dropped = r.counter(
            "request_trace_dropped_spans_total",
            "spans dropped at the per-request event cap (the bound "
            "that keeps a week-long stream from growing tracer state)")
        # Prometheus counter updates are BATCHED: the per-record cost
        # budget is one tracer lock + one list append — pending deltas
        # accumulate under that same lock, flushing every
        # _METRIC_FLUSH records and (force-)on every read path, so the
        # scrape lags by at most one batch while traffic flows and by
        # nothing once anyone looks
        self._pend_spans = 0
        self._pend_dropped = 0

    # ---- recording ------------------------------------------------------
    def _rec_locked(self, rid: int) -> dict:
        """The request's record; caller holds the lock.  Creating one
        past the request cap evicts the oldest (dict insertion order =
        recording order)."""
        rec = self._reqs.get(rid)
        if rec is None:
            rec = {"events": [], "counts": {}, "dropped": 0}
            self._reqs[rid] = rec
            while len(self._reqs) > self.max_requests:
                del self._reqs[next(iter(self._reqs))]
        return rec

    def _flush_locked(self, force: bool = False):
        """Push batched deltas into the Prometheus counters; caller
        holds the lock."""
        if not force and self._pend_spans < _METRIC_FLUSH \
                and self._pend_dropped < _METRIC_FLUSH:
            return
        ns, nd = self._pend_spans, self._pend_dropped
        self._pend_spans = self._pend_dropped = 0
        if ns:
            self._m_spans.inc(ns)
        if nd:
            self._m_dropped.inc(nd)

    def flush_metrics(self):
        """Force the batched span/drop counts into the counters (a
        scraper that must see exact figures calls this first)."""
        with self._lock:
            self._flush_locked(force=True)

    def _record(self, rid: int, entry: tuple) -> bool:
        # instants are lifecycle marks (finish/preempt/requeue/...):
        # they may use the reserved tail of the cap that bulk spans
        # cannot, so a long generation's lane still shows how it ended
        cap = (self.max_events_per_request if entry[0] == "i"
               else self._span_cap)
        with self._lock:
            rec = self._rec_locked(rid)
            if len(rec["events"]) >= cap:
                rec["dropped"] += 1
                self._dropped_total += 1
                self._pend_dropped += 1
                ok = False
            else:
                rec["events"].append(entry)
                self._pend_spans += 1
                ok = True
            self._flush_locked()
        return ok

    def event(self, rid: int, kind: str, ts: Optional[float] = None,
              **args):
        """One instant lifecycle event (enqueue, dispatch, requeue,
        first_token, finish, ...) at ``ts`` (perf_counter; default
        now)."""
        if ts is None:
            ts = time.perf_counter()
        self._record(int(rid), ("i", kind, float(ts), float(ts), args))

    def span(self, rid: int, kind: str, start: float, end: float,
             **args):
        """One completed phase span (pending wait, on-engine segment,
        prefill chunk, ...)."""
        self._record(int(rid),
                     ("X", kind, float(start), float(end), args))

    def sample_span(self, rid: int, kind: str, start: float, end: float,
                    every: int = 1, **args):
        """A span recorded every ``every``-th call per (request, kind)
        — the decode hot loop's knob: one sample per N steps keeps a
        long generation's trace readable AND inside the event cap,
        while the per-kind call count stays exact.  ONE lock pass for
        count + append (this is the per-step-per-slot call)."""
        rid = int(rid)
        if every < 1:
            every = 1
        with self._lock:
            rec = self._rec_locked(rid)
            counts = rec["counts"]
            n = counts.get(kind, 0)
            counts[kind] = n + 1
            if n % every:
                return
            if len(rec["events"]) >= self._span_cap:
                rec["dropped"] += 1
                self._dropped_total += 1
                self._pend_dropped += 1
            else:
                args["sample_index"] = n
                rec["events"].append(
                    ("X", kind, float(start), float(end), args))
                self._pend_spans += 1
            self._flush_locked()

    # ---- reads ----------------------------------------------------------
    # every read path force-flushes the batched counter deltas first:
    # once traffic stops, the next scrape/inspection sees exact totals
    # (the batch bounds scrape lag by records, reads bound it in time)
    def events(self, rid: int) -> List[tuple]:
        """The request's entries, lifecycle order (copies)."""
        with self._lock:
            self._flush_locked(force=True)
            rec = self._reqs.get(int(rid))
            return list(rec["events"]) if rec else []

    def kind_count(self, rid: int, kind: str) -> int:
        """Exact per-kind call count (sample_span records a subset but
        counts every call)."""
        with self._lock:
            self._flush_locked(force=True)
            rec = self._reqs.get(int(rid))
            return rec["counts"].get(kind, 0) if rec else 0

    def request_ids(self) -> List[int]:
        with self._lock:
            self._flush_locked(force=True)
            return list(self._reqs)

    def dropped(self) -> int:
        with self._lock:
            self._flush_locked(force=True)
            return self._dropped_total

    def clear(self):
        with self._lock:
            self._flush_locked(force=True)
            self._reqs.clear()
            self._dropped_total = 0

    # ---- chrome emission -------------------------------------------------
    def chrome_events(self, rename: Optional[Callable] = None
                      ) -> List[dict]:
        """Chrome trace dicts with ABSOLUTE perf_counter-second ``ts``
        (``merge_chrome_trace`` owns the shared-clock shift and the µs
        scaling).  Each request renders as one lane: ``tid`` = its id.

        ``rename(rid)`` maps local ids to display ids — the router uses
        it to rename engine-local request ids to fleet-wide rids so a
        request keeps ONE lane id across every engine it visited;
        ``None`` from the mapper keeps the local id on an offset lane
        (requests the router never routed)."""
        with self._lock:
            self._flush_locked(force=True)
            items = [(rid, list(rec["events"]))
                     for rid, rec in self._reqs.items()]
        out: List[dict] = []
        lanes: Dict[int, str] = {}
        for rid, evs in items:
            disp = rename(rid) if rename is not None else rid
            if disp is None:
                tid, label = 1_000_000 + rid, "local req %d" % rid
            else:
                tid, label = int(disp), "req %d" % int(disp)
            lanes[tid] = label
            for ph, kind, t0, t1, args in evs:
                ev = {"name": kind, "cat": "request", "ph": ph,
                      "tid": tid, "ts": t0}
                if ph == "X":
                    ev["dur"] = t1 - t0
                else:
                    ev["s"] = "t"
                if args:
                    ev["args"] = dict(args)
                out.append(ev)
        for tid in sorted(lanes):
            out.append({"name": "thread_name", "ph": "M", "tid": tid,
                        "args": {"name": lanes[tid]}})
        return out


def resolve_tracer(arg) -> "RequestTracer":
    """The engine/router ``tracer=`` knob: ``None``/``True`` -> a fresh
    bounded tracer (the default-ON contract), ``False`` -> the no-op
    stub, an existing tracer instance -> shared as-is."""
    if arg is None or arg is True:
        return RequestTracer()
    if arg is False:
        return NULL_TRACER
    if isinstance(arg, (RequestTracer, NullRequestTracer)):
        return arg
    raise TypeError(
        "tracer= must be None/True (own bounded tracer), False (no-op "
        "stub) or a RequestTracer instance; got %r" % (arg,))


class LatencyReservoir:
    """Bounded uniform reservoir (Algorithm R, seeded RNG so digests
    are deterministic for a fixed completion order) feeding p50/p95/p99
    TTFT/TPOT digests.  O(1) add, O(cap·log cap) quantile — quantiles
    run per COMPLETION (rare) not per step, so the sort never sits on
    the decode hot path."""

    def __init__(self, capacity: int = 1024, seed: int = 0):
        import numpy as np
        self.capacity = max(1, int(capacity))
        self._buf = np.zeros((self.capacity,), np.float64)
        self._n = 0                  # filled slots
        self._seen = 0               # values offered ever
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()

    def add(self, value: float):
        v = float(value)
        with self._lock:
            self._seen += 1
            if self._n < self.capacity:
                self._buf[self._n] = v
                self._n += 1
            else:
                j = int(self._rng.randint(0, self._seen))
                if j < self.capacity:
                    self._buf[j] = v

    @property
    def count(self) -> int:
        """Values ever offered (the reservoir holds a uniform sample of
        them)."""
        with self._lock:
            return self._seen

    def _snapshot(self):
        """(seen, filled, buffer copy) under ONE lock acquisition."""
        with self._lock:
            return self._seen, self._n, self._buf[:self._n].copy()

    def quantile(self, q: float) -> Optional[float]:
        import numpy as np
        _seen, n, buf = self._snapshot()
        if not n:
            return None
        return float(np.quantile(buf, min(1.0, max(0.0, float(q)))))

    def digest(self) -> Dict[str, object]:
        """JSON-able {count, window, p50, p95, p99} (None quantiles
        when empty — valid JSON, unlike NaN).  All fields come from
        ONE locked snapshot, so a concurrent ``add`` can never yield
        an internally inconsistent digest (p50 > p95, count drifted
        from the quantiles' window)."""
        import numpy as np
        seen, n, buf = self._snapshot()
        if not n:
            return {"count": seen, "window": 0,
                    "p50": None, "p95": None, "p99": None}
        p50, p95, p99 = (float(v) for v in
                         np.quantile(buf, (0.5, 0.95, 0.99)))
        return {"count": seen, "window": n,
                "p50": p50, "p95": p95, "p99": p99}


# ---------------------------------------------------------------------------
# span-chain completeness (the bench gate's validator)
# ---------------------------------------------------------------------------
def validate_span_chain(events: List[tuple], eps: float = 0.005
                        ) -> Tuple[bool, str]:
    """Is this router-side request chain complete and gap-free?

    Structural contract (the kinds the ServingRouter records):

    - first event ``enqueue``, last event ``finish`` (exactly one);
    - ``dispatch`` only from the pending state, ``requeue`` only from
      the dispatched state — every preempt/engine-lost hop is followed
      by a re-dispatch (or by ``finish``, when the requeued tokens had
      already met the budget);
    - one ``on_engine`` span per dispatch (closed at requeue or
      completion).

    Temporal contract: the ``dispatch`` spans (each covers its pending
    wait, submit-or-requeue .. placement) + ``on_engine`` spans TILE
    the request's life — sorted by start, each span begins within
    ``eps`` of the running coverage end, starting at the enqueue mark
    and reaching the finish mark.  A missing hop record (e.g. an
    engine segment nobody closed) is a hole, not a rendering quirk.

    Returns ``(ok, reason)``; reason is "" on success.
    """
    if not events:
        return False, "no events recorded"
    kinds = [e[1] for e in events]
    if kinds[0] != "enqueue":
        return False, "chain does not start with enqueue (got %r)" \
            % kinds[0]
    if kinds.count("finish") != 1 or kinds[-1] != "finish":
        return False, "chain must end with exactly one finish"
    state = "pending"
    n_dispatch = n_requeue = 0
    for k in kinds:
        if k == "dispatch":
            if state != "pending":
                return False, "dispatch while already dispatched"
            state = "dispatched"
            n_dispatch += 1
        elif k == "requeue":
            if state != "dispatched":
                return False, "requeue without a live dispatch"
            state = "pending"
            n_requeue += 1
    if n_dispatch == 0:
        return False, "request was never dispatched"
    n_engine_spans = sum(1 for e in events
                         if e[0] == "X" and e[1] == "on_engine")
    if n_engine_spans != n_dispatch:
        return False, ("%d dispatches but %d on_engine spans"
                       % (n_dispatch, n_engine_spans))
    t_enqueue = events[0][2]
    t_finish = events[-1][2]
    spans = sorted(((e[2], e[3]) for e in events
                    if e[0] == "X" and e[1] in ("dispatch", "on_engine")),
                   key=lambda s: s[0])
    if not spans:
        return False, "no dispatch/on_engine coverage spans"
    if spans[0][0] > t_enqueue + eps:
        return False, "coverage starts %.3fs after enqueue" \
            % (spans[0][0] - t_enqueue)
    end = spans[0][1]
    for s0, s1 in spans[1:]:
        if s0 > end + eps:
            return False, "gap of %.3fs in span coverage" % (s0 - end)
        end = max(end, s1)
    if end < t_finish - eps:
        return False, "coverage ends %.3fs before finish" \
            % (t_finish - end)
    return True, ""


# ---------------------------------------------------------------------------
# fleet-wide chrome trace
# ---------------------------------------------------------------------------
def fleet_trace(path: str, router, device_trace_dir: Optional[str] = None,
                runtime_events=()) -> Dict[str, object]:
    """Write ONE chrome://tracing JSON for a :class:`ServingRouter`
    fleet: the router's request spans plus every pool engine's spans,
    each as its own track group (pid), all on the shared
    ``perf_counter`` clock, with chrome flow events linking a requeued
    request's segments across engines.

    Engine-local request ids are renamed to fleet-wide rids through the
    router's hop records (``RouterRequest.hops``), so one request keeps
    one lane id everywhere it ran; engine-side requests the router
    never placed (direct ``add_request`` callers) keep their local ids
    on offset lanes.

    Returns ``{path, engine_groups, flow_links, cross_engine_links,
    requests}`` — the bench gates on ``engine_groups >= 2`` and
    ``cross_engine_links >= 1`` under the kill drill.
    """
    from .trace_merge import merge_chrome_trace
    tracer = getattr(router, "tracer", None) or NULL_TRACER

    # every request the router knows about: finished, in flight, AND
    # requeued-but-not-yet-redispatched (router.pending) — the
    # mid-incident case an operator pulls a trace FOR; omitting
    # pending would strip a drained request's lane renaming and hop
    # arrows exactly when they matter
    recs = list(getattr(router, "finished", {}).values())
    inflight = getattr(router, "_inflight", None)
    if inflight:
        recs += list(inflight.values())
    recs += [rr for rr in getattr(router, "pending", ())
             if getattr(rr, "hops", None)]
    rid_map: Dict[Tuple[int, int], int] = {}
    hops_by_rid: Dict[int, list] = {}
    for rr in recs:
        hops = list(getattr(rr, "hops", ()))
        hops_by_rid[rr.rid] = hops
        for hop in hops:
            rid_map[(hop[0], hop[1])] = rr.rid

    groups: List[Tuple[str, List[dict]]] = []
    router_events = tracer.chrome_events() if tracer.enabled else []
    if router_events:
        groups.append(("router", router_events))

    engine_events: Dict[int, List[dict]] = {}
    for h in router.handles.values():
        etr = getattr(h.engine, "tracer", None)
        evs: List[dict] = []
        if etr is not None and getattr(etr, "enabled", False):
            eid = h.engine_id
            evs = etr.chrome_events(
                rename=lambda erid, _e=eid: rid_map.get((_e, erid)))
        engine_events[h.engine_id] = evs

    # flow events: one s->f arrow per hop pair, drawn from the source
    # segment's leave mark to the destination segment's dispatch mark.
    # Arrows bind to enclosing slices in chrome, so they are only
    # emitted between groups that actually carry spans (a stub-traced
    # engine gets neither dangling arrows nor a phantom track group —
    # the completeness gates must not pass on hop records alone)
    spanned = {eid for eid, evs in engine_events.items() if evs}
    flow_links = cross_links = 0
    for rid, hops in hops_by_rid.items():
        for i in range(len(hops) - 1):
            src, dst = hops[i], hops[i + 1]
            if src[3] is None or dst[2] is None:
                continue              # segment still open: no arrow yet
            if src[0] not in spanned or dst[0] not in spanned:
                continue
            fid = rid * 1000 + i
            name = "req %d requeue" % rid
            engine_events[src[0]].append(
                {"name": name, "cat": "flow", "ph": "s", "id": fid,
                 "tid": rid, "ts": float(src[3])})
            engine_events[dst[0]].append(
                {"name": name, "cat": "flow", "ph": "f", "bp": "e",
                 "id": fid, "tid": rid, "ts": float(dst[2])})
            flow_links += 1
            if src[0] != dst[0]:
                cross_links += 1

    n_engine_groups = 0
    for eid in sorted(engine_events):
        if eid in spanned:
            groups.append(("engine %d" % eid, engine_events[eid]))
            n_engine_groups += 1

    merge_chrome_trace(path, host_events=None,
                       runtime_events=list(runtime_events),
                       device_trace_dir=device_trace_dir,
                       extra_groups=groups)
    return {"path": path, "engine_groups": n_engine_groups,
            "flow_links": flow_links, "cross_engine_links": cross_links,
            "requests": len(hops_by_rid)}
