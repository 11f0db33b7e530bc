"""Merged host + device Chrome traces (a copy of
``paddle_tpu/observability/trace_merge.py``).

``merge_chrome_trace`` folds host spans (objects with ``name``,
``start``, ``end`` and ``tid``), the runtime span log this module keeps,
caller-built track groups (the request tracers' lanes, through
``request_trace.fleet_trace``) and a device trace directory into ONE
chrome://tracing JSON.  The device trace is any ``*.trace.json[.gz]``
under the directory: ``torch.profiler``'s chrome export
(``prof.export_chrome_trace(dir + "/step.pt.trace.json")``) qualifies.

Clock domains: host spans are ``time.perf_counter`` based, the device
trace has its own epoch; each source is shifted so its earliest event
sits at t=0 (alignment at trace start — sub-trace ordering is exact,
cross-trace skew is bounded by the capture window).
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

__all__ = ["SpanLog", "span_log", "record_span", "record_instant",
           "load_device_trace_events", "merge_chrome_trace"]

_SPAN_LOG_CAP = 16384


class SpanLog:
    """Bounded in-memory log of runtime spans/instants (step markers,
    checkpoint writes, watchdog timeouts).  An append is one lock + one
    deque.append — cheap enough for per-step use; the cap drops the
    OLDEST entries so a week-long job keeps the recent window.  The
    append AND the eviction run under one lock: concurrent writers
    (train thread + checkpoint writer + watchdog) can never race the
    bound past ``maxlen`` or drop each other's fresh entries."""

    def __init__(self, maxlen: int = _SPAN_LOG_CAP):
        self._maxlen = max(1, int(maxlen))
        self._events: "collections.deque" = collections.deque()
        self._lock = threading.Lock()

    def _append(self, entry: tuple):
        with self._lock:
            self._events.append(entry)
            while len(self._events) > self._maxlen:
                self._events.popleft()

    def record(self, name: str, start: float, end: float,
               cat: str = "runtime", **args):
        """A completed span; start/end are time.perf_counter seconds."""
        self._append(("X", name, cat, start, end, args,
                      threading.get_ident()))

    def instant(self, name: str, ts: Optional[float] = None,
                cat: str = "runtime", **args):
        t = time.perf_counter() if ts is None else ts
        self._append(("i", name, cat, t, t, args,
                      threading.get_ident()))

    def events(self) -> List[tuple]:
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self):
        with self._lock:
            return len(self._events)


# process-wide log every wired subsystem appends to
span_log = SpanLog()


def record_span(name: str, start: float, end: float,
                cat: str = "runtime", **args):
    span_log.record(name, start, end, cat, **args)


def record_instant(name: str, ts: Optional[float] = None,
                   cat: str = "runtime", **args):
    span_log.instant(name, ts, cat, **args)


def _tid_map(idents: Iterable[int]) -> Dict[int, int]:
    """Stable small thread ids (chrome renders 15-digit pthread idents
    as separate unreadable lanes)."""
    return {ident: i for i, ident in enumerate(sorted(set(idents)))}


def load_device_trace_events(trace_dir: str) -> List[dict]:
    """traceEvents from the chrome trace(s) a profiler wrote under
    ``trace_dir`` (``**/*.trace.json[.gz]``); [] when the dir is missing
    or holds no trace — a device-less CPU/host-only run merges cleanly
    to host spans alone."""
    if not trace_dir or not os.path.isdir(trace_dir):
        return []
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                    recursive=True))
    events: List[dict] = []
    for path in paths:
        try:
            if path.endswith(".gz"):
                with gzip.open(path, "rt") as f:
                    data = json.load(f)
            else:
                with open(path) as f:
                    data = json.load(f)
        except (OSError, ValueError):
            continue
        evs = data.get("traceEvents", data) if isinstance(data, dict) \
            else data
        if isinstance(evs, list):
            events.extend(e for e in evs if isinstance(e, dict))
    return events


def _host_events_json(host_events, pid: int,
                      t0: Optional[float] = None) -> List[dict]:
    """Host span list (``name``/``start``/``end``/``tid``, optional
    ``event_type``) -> chrome 'X' events +
    name metadata, normalized to t=0 at ``t0`` (defaults to the
    earliest span)."""
    if not host_events:
        return []
    if t0 is None:
        t0 = min(e.start for e in host_events)
    tids = _tid_map(e.tid for e in host_events)
    # spans FIRST, name metadata after: tools that peek at
    # traceEvents[0] (and the repo's own round-trip checks) see a real
    # 'X' span, and chrome accepts metadata at any position
    out = [{"name": e.name, "ph": "X", "pid": pid,
            "tid": tids[e.tid], "ts": (e.start - t0) * 1e6,
            "dur": (e.end - e.start) * 1e6,
            "cat": getattr(e, "event_type", "UserDefined")}
           for e in sorted(host_events, key=lambda e: e.start)]
    out.append({"name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": "host spans"}})
    for ident, tid in tids.items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": f"host-thread-{tid}"}})
    return out


def _span_log_events_json(entries, pid: int,
                          t0: Optional[float] = None) -> List[dict]:
    if not entries:
        return []
    if t0 is None:
        t0 = min(e[3] for e in entries)
    tids = _tid_map(e[6] for e in entries)
    out = []
    for ph, name, cat, start, end, args, ident in entries:
        ev = {"name": name, "ph": ph, "pid": pid, "tid": tids[ident],
              "ts": (start - t0) * 1e6, "cat": cat}
        if ph == "X":
            ev["dur"] = (end - start) * 1e6
        else:
            ev["s"] = "t"          # thread-scoped instant
        if args:
            ev["args"] = {k: v for k, v in args.items()}
        out.append(ev)
    out.append({"name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": "runtime (steps/ckpt/comm)"}})
    for ident, tid in tids.items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid,
                    "args": {"name": f"runtime-thread-{tid}"}})
    return out


def _device_events_json(events: List[dict], pid_base: int) -> List[dict]:
    """Re-base the device trace: pids offset so they never collide with
    the host groups, timestamps shifted to t=0 at the earliest event."""
    if not events:
        return []
    ts_vals = []
    for e in events:
        try:
            ts_vals.append(float(e["ts"]))
        except (KeyError, TypeError, ValueError):
            pass
    ts0 = min(ts_vals) if ts_vals else 0.0   # metadata-only trace: keep
    out = []
    for e in events:
        ev = dict(e)
        if "pid" in ev:
            try:
                ev["pid"] = pid_base + int(ev["pid"])
            except (TypeError, ValueError):
                ev["pid"] = pid_base
        else:
            ev["pid"] = pid_base
        try:
            ev["ts"] = float(ev["ts"]) - ts0
        except (KeyError, TypeError, ValueError):
            pass                             # no/odd ts: pass through
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            args = dict(ev.get("args") or {})
            args["name"] = f"device: {args.get('name', 'profiler')}"
            ev["args"] = args
        out.append(ev)
    return out


def _extra_group_json(name: str, group_events: List[dict], pid: int,
                      t0: Optional[float]) -> List[dict]:
    """One caller-built track group (e.g. a request tracer's events):
    chrome dicts whose ``ts``/``dur`` are ABSOLUTE perf_counter seconds
    — this shifts them onto the shared t0 and scales to µs, assigns the
    group's pid, and appends its process_name metadata."""
    if not group_events:
        return []
    base = t0 or 0.0
    out = []
    for e in group_events:
        ev = dict(e)
        ev["pid"] = pid
        if "ts" in ev:
            ev["ts"] = (float(ev["ts"]) - base) * 1e6
        if "dur" in ev:
            ev["dur"] = float(ev["dur"]) * 1e6
        out.append(ev)
    out.append({"name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": name}})
    return out


def merge_chrome_trace(path: str, host_events=None,
                       runtime_events=None,
                       device_trace_dir: Optional[str] = None,
                       extra_groups=None) -> str:
    """Write one chrome://tracing JSON folding host spans,
    the runtime span log, and the device trace (if any) — the
    observability subsystem's single-timeline artifact.

    host_events: host span objects (or None).
    runtime_events: a :class:`SpanLog` / its ``events()`` list; defaults
    to the process-wide :data:`span_log`.
    device_trace_dir: a profiler's trace dir; missing/empty dirs
    degrade to a host-only trace (the device-less CPU contract).
    extra_groups: ``[(process_name, chrome_event_dicts)]`` — additional
    track groups (one pid each) whose ``ts``/``dur`` are ABSOLUTE
    perf_counter seconds on the same clock as the host/runtime spans;
    the fleet request tracer (``request_trace.fleet_trace``) feeds the
    router's and every engine's request lanes through this.

    Output ordering is DETERMINISTIC: non-metadata events sort by
    ``(ts, pid, tid, name)`` — two spans sharing a timestamp always
    serialize in the same order, so traces diff cleanly across runs —
    with metadata after (the first traceEvent stays a real span).
    """
    if runtime_events is None:
        runtime_events = span_log
    if isinstance(runtime_events, SpanLog):
        runtime_events = runtime_events.events()
    pid = os.getpid()
    host_events = list(host_events or [])
    runtime_events = list(runtime_events or [])
    extra_groups = [(str(n), list(evs or []))
                    for n, evs in (extra_groups or [])]
    # host spans, runtime spans and extra groups share the perf_counter
    # clock: ONE t0 across all of them, or a checkpoint 45s into the
    # profile would render at t=0 next to the first host span
    starts = [e.start for e in host_events] \
        + [e[3] for e in runtime_events]
    for _name, evs in extra_groups:
        starts += [float(e["ts"]) for e in evs if "ts" in e]
    t0 = min(starts) if starts else None
    events: List[dict] = []
    events.extend(_host_events_json(host_events, pid, t0))
    events.extend(_span_log_events_json(runtime_events, pid + 1, t0))
    for i, (name, evs) in enumerate(extra_groups):
        events.extend(_extra_group_json(name, evs, pid + 2 + i, t0))
    events.extend(_device_events_json(
        load_device_trace_events(device_trace_dir), 1_000_000))
    # deterministic serialization: spans by (ts, pid, tid, name) —
    # ties included — then metadata (tools that peek at traceEvents[0]
    # must still see a real span)
    spans = [e for e in events if e.get("ph") != "M"]
    meta = [e for e in events if e.get("ph") == "M"]

    def _num(v):
        # device traces may carry non-numeric ids: numbers sort
        # numerically, anything else sorts after them as text — the
        # key never raises and stays deterministic either way
        try:
            return (0, float(v), "")
        except (TypeError, ValueError):
            return (1, 0.0, str(v))

    def _order(e):
        try:
            ts = float(e.get("ts", 0.0))
        except (TypeError, ValueError):
            ts = 0.0
        return (ts, _num(e.get("pid", 0)), _num(e.get("tid", 0)),
                str(e.get("name", "")))

    spans.sort(key=_order)
    out = {"displayTimeUnit": "ms", "traceEvents": spans + meta}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)
    return path
