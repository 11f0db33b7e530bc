"""Elastic actuator for the serving fleet (a copy of
``paddle_tpu/inference/elastic.py`` over the port's router).

The capacity plane emits flap-free ``scale_up`` / ``scale_down`` /
``rebalance`` recommendations and page migration made KV pages movable;
:class:`ElasticController` is the actuator: it reads
``ServingRouter.capacity_plan()`` after each router step and turns the
committed recommendation into pool changes, all through the router's
unchanged dispatch/drain state machine:

- **scale_up** — admit a cold engine (popped from the ``standby`` pool
  or built by the ``spawn`` factory: an in-process engine, or an
  ``EngineProcess``-backed :class:`~paddle_tpu_torch.inference.fleet.
  RemoteEngineClient`), then WARM it: hot prefix families are copied
  from the most-saturated peers' host tiers into the newcomer's (first
  touch hits host RAM instead of recomputing), and in-flight decode
  work is shed off the hottest peer extract-first so its pages migrate
  over (the newcomer's empty slots make it the ranked dispatch's
  least-loaded target).
- **scale_down** — pick the least-saturated victim and retire it via
  ``router.remove_engine``: every in-flight request drains off through
  the same extract-first requeue the failure path uses, so each resume
  injects its KV pages with ZERO re-prefill (``fate="migrated"``; an
  engine whose pools can't travel degrades to ``"re_prefilled"``).
  The drained engine parks back in ``standby`` (or is handed to the
  ``retire`` callback — kill the subprocess, return the lease).
- **rebalance** — the plan's ranked ``rebalance_pairs`` name concrete
  (source, target) engines; decoding requests are pulled off each
  source extract-first and requeued, and the ranked dispatch lands
  them (pages and all) on the spare capacity.

The controller acts at most once per planner EVALUATION and then holds
for ``cooldown_steps`` router steps — the planner's hysteresis+dwell
already forbids flapping recommendations, and the cooldown keeps the
actuator from re-acting on the same committed action every step while
its effect is still propagating through the windows.

Construction is the only knob: a router without an ElasticController
attached behaves exactly as before.  The controller scales the pool of
engines; it does not reshard a live engine's mesh (an engine's mesh is
fixed when it is built, whether it serves on one device or over ranks).
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["ElasticController"]


class ElasticController:
    """Drives a :class:`~paddle_tpu_torch.inference.router.ServingRouter`'s
    pool membership off its committed capacity plan.

    Call :meth:`step` after every ``router.step()`` (or let a serving
    loop own the cadence).  ``spawn()`` -> engine is consulted on
    scale_up when ``standby`` is empty; ``retire(engine)`` on
    scale_down (default: park in ``standby`` for the next scale_up —
    the in-process fleet shape).
    """

    def __init__(self, router, spawn=None, standby=None, retire=None,
                 min_engines: int = 1, max_engines: int = 8,
                 cooldown_steps: int = 8, max_moves_per_action: int = 4,
                 warm_pages: int = 32, registry=None):
        if router.capacity is None:
            raise ValueError(
                "ElasticController needs capacity monitoring: construct "
                "the ServingRouter with capacity=True (or a "
                "CapacityConfig / FleetCapacityMonitor)")
        self.router = router
        self.spawn = spawn
        self.standby: List = list(standby) if standby else []
        self.retire = retire
        self.min_engines = max(1, int(min_engines))
        self.max_engines = max(self.min_engines, int(max_engines))
        self.cooldown_steps = max(0, int(cooldown_steps))
        self.max_moves_per_action = max(1, int(max_moves_per_action))
        self.warm_pages = max(0, int(warm_pages))
        self._cooldown = 0
        self._acted_evaluations = -1
        # action log for tests/benches: (router evaluation count,
        # action, detail dict)
        self.actions: List[tuple] = []

        from ..observability import default_registry
        r = registry if registry is not None else default_registry()
        self._m_actions = r.counter(
            "elastic_actions_total",
            "capacity-plan recommendations the elastic actuator "
            "actually executed, by action — the capacity plane "
            "recommends, this counts actuation",
            labels=("action",))
        self._action_children = {
            a: self._m_actions.labels(action=a)
            for a in ("scale_up", "scale_down", "rebalance")}
        self._m_drained = r.counter(
            "elastic_drained_requests_total",
            "in-flight requests drained off a scale_down victim, by "
            "how they travelled: 'migrated' = KV pages extracted and "
            "re-injected (zero re-prefill), 're_prefilled' = the "
            "recompute fallback",
            labels=("fate",))
        self._m_warm = r.counter(
            "elastic_warmup_restored_pages_total",
            "host-tier prefix pages copied into a freshly admitted "
            "engine's tier during scale_up warmup (hot families "
            "pre-seeded so first touches restore instead of recompute)")

    # ---- the one per-step hook ------------------------------------------
    def step(self) -> Optional[str]:
        """Read the committed plan and act on it (at most one action).
        Returns the action executed this call, or None."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        plan = self.router.capacity_plan()
        action = plan.get("action", "steady")
        if action == "steady":
            return None
        # one actuation per planner evaluation: the recommendation
        # persists until its clear band, and re-acting on the same
        # evaluation would double-execute one decision
        if plan.get("evaluations", 0) == self._acted_evaluations:
            return None
        executed = None
        if action == "scale_up":
            executed = self._scale_up()
        elif action == "scale_down":
            executed = self._scale_down()
        elif action == "rebalance":
            executed = self._rebalance(plan)
        if executed is not None:
            self._acted_evaluations = plan.get("evaluations", 0)
            self._cooldown = self.cooldown_steps
            self._action_children[executed].inc()
        return executed

    # ---- scale_up --------------------------------------------------------
    def _scale_up(self) -> Optional[str]:
        if len(self.router.handles) >= self.max_engines:
            return None
        engine = self.standby.pop() if self.standby else (
            self.spawn() if self.spawn is not None else None)
        if engine is None:
            return None
        eid = self.router.add_engine(engine)
        detail = {"engine": eid,
                  "warmed_pages": self._warm_host_tier(eid),
                  "shed": self._shed_into_pool(limit=(
                      self.max_moves_per_action))}
        self.actions.append((self._evaluations(), "scale_up", detail))
        return "scale_up"

    def _warm_host_tier(self, cold_id: int) -> int:
        """Copy the hottest host-tier prefix entries from saturated
        peers into the cold engine's tier (digest keys are engine-
        independent — the chain digest hashes prompt tokens only).
        The newcomer's first prompts then restore from host RAM via
        the normal ``match(restore=True)`` path instead of
        recomputing.  Returns pages copied."""
        h = self.router.handles.get(cold_id)
        cold = getattr(h, "engine", None)
        tier = getattr(cold, "host_tier", None)
        geo_fn = getattr(cold, "migration_geometry", None)
        if tier is None or geo_fn is None or not self.warm_pages:
            return 0
        try:
            cold_geo = geo_fn()
        except Exception:                             # noqa: BLE001
            return 0
        if cold_geo is None:
            return 0
        copied = 0
        for peer_id in self._by_saturation(descending=True):
            if peer_id == cold_id or copied >= self.warm_pages:
                break
            ph = self.router.handles.get(peer_id)
            src = getattr(getattr(ph, "engine", None), "host_tier",
                          None)
            pgeo = getattr(ph.engine, "migration_geometry",
                           lambda: None)()
            if src is None or pgeo != cold_geo:
                continue
            # hottest first: the LRU keeps most-recently-touched at
            # the back
            for key in list(reversed(src.entries)):
                if copied >= self.warm_pages:
                    break
                if key in tier:
                    continue
                buf = src.entries.get(key)
                if buf is not None and tier.put(key, buf):
                    copied += 1
        if copied:
            self._m_warm.inc(copied)
        return copied

    def _shed_into_pool(self, limit: int) -> int:
        """Pull decoding requests off the most-saturated peer so their
        pages migrate to wherever the ranked dispatch finds spare
        capacity — right after a scale_up that is the empty newcomer."""
        order = self._by_saturation(descending=True)
        return self._shed_from(order[0], limit) if order else 0

    # ---- scale_down ------------------------------------------------------
    def _scale_down(self) -> Optional[str]:
        if len(self.router.handles) <= self.min_engines:
            return None
        order = self._by_saturation(descending=False)
        victim = next((eid for eid in order
                       if len(self.router.handles) > 1), None)
        if victim is None:
            return None
        engine = self.router.handles[victim].engine
        fates = self.router.remove_engine(victim, reason="scale_down")
        self._m_drained.labels(fate="migrated").inc(fates["migrated"])
        self._m_drained.labels(fate="re_prefilled").inc(
            fates["re_prefilled"])
        if self.retire is not None:
            self.retire(engine)
        else:
            self.standby.append(engine)
        self.actions.append((self._evaluations(), "scale_down",
                             {"engine": victim, "fates": fates}))
        return "scale_down"

    # ---- rebalance -------------------------------------------------------
    def _rebalance(self, plan: Dict) -> Optional[str]:
        pairs = plan.get("rebalance_pairs") or []
        moved = 0
        for pair in pairs:
            if moved >= self.max_moves_per_action:
                break
            moved += self._shed_from(
                pair["source_engine"],
                self.max_moves_per_action - moved,
                prefer=pair.get("target_engine"))
        if not moved:
            return None
        self.actions.append((self._evaluations(), "rebalance",
                             {"moved": moved}))
        return "rebalance"

    # ---- shared machinery ------------------------------------------------
    def _shed_from(self, src_id: int, limit: int,
                   prefer: Optional[int] = None) -> int:
        """Extract up to ``limit`` decoding requests off ``src_id`` and
        requeue them with their KV pages (``reason="rebalance"``) —
        the router's next dispatch injects them wherever capacity and
        geometry line up (``prefer`` only gates on that engine having
        room; placement stays the ranked dispatch's call — the
        unchanged state machine is the point)."""
        router = self.router
        h = router.handles.get(src_id)
        if h is None or not h.healthy:
            return 0
        geo_fn = getattr(h.engine, "migration_geometry", None)
        src_geo = geo_fn() if geo_fn is not None else None
        if src_geo is None:
            return 0
        if prefer is not None:
            th = router.handles.get(prefer)
            if th is None or not th.healthy or not th.has_capacity():
                return 0
        # a target with room and matching pool geometry must exist, or
        # the "move" degrades to paying the prefill again elsewhere
        if not any(t.healthy and t.engine_id != src_id
                   and t.has_capacity()
                   and getattr(t.engine, "migration_geometry",
                               lambda: None)() == src_geo
                   for t in router.handles.values()):
            return 0
        moved = 0
        for key in list(router._inflight.keys()):
            if moved >= limit:
                break
            if key[0] != src_id:
                continue
            rr = router._inflight.get(key)
            ereq = rr.engine_req if rr is not None else None
            if ereq is None or getattr(ereq, "state", "") != "running":
                continue
            if not getattr(ereq, "output_ids", None):
                continue          # prefill not done: nothing to move
            try:
                _prompt, gen, buf = h.engine.extract_request(key[1])
            except Exception:                         # noqa: BLE001
                continue
            router._inflight.pop(key, None)
            rr.migrations += 1
            router._requeue(rr, gen, reason="rebalance", buffer=buf)
            moved += 1
        return moved

    def _by_saturation(self, descending: bool) -> List[int]:
        """Healthy engine ids ordered by their monitored saturation
        EWMA (ties: engine id, for determinism)."""
        cap = self.router.capacity
        out = []
        for h in self.router.handles.values():
            if not h.healthy:
                continue
            m = cap.engines.get(h.engine_id)
            s = m.w_saturation.ewma() if m is not None else None
            out.append((float(s) if s is not None else 0.0,
                        h.engine_id))
        out.sort(key=lambda t: ((-t[0]) if descending else t[0], t[1]))
        return [eid for _s, eid in out]

    def _evaluations(self) -> int:
        return int(self.router.capacity.planner.evaluations)
