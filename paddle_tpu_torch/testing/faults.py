"""Fault-injection harness (a copy of ``paddle_tpu/testing/faults.py``,
stdlib only: the port keeps its own so that it imports nothing of the
reference; the spec syntax, the sites and ``PADDLE_TPU_FAULT_SPEC`` are
the reference's, so one spec arms both packages' fleet servers).

Robustness code paths (atomic checkpoints, I/O retry, collective
watchdogs) are only trustworthy if tests can MAKE the failure happen at
the exact instrumented instant.  Production code marks those instants
with :func:`fault_point("site.name")`; a fault spec — from the
``PADDLE_TPU_FAULT_SPEC`` environment variable or an in-process
:func:`configure` call — decides what each hit does.

Spec syntax (';'-separated rules)::

    <mode>:<site-glob>[:key=value]*

    modes:
      ioerror         raise FaultError (an OSError subclass)
      kill            SIGKILL the whole process (kill -9 semantics:
                      no cleanup, no atexit, no finally blocks)
      delay           sleep ``ms`` milliseconds, then continue
      hang            sleep ``ms`` (default 3600000), for watchdog tests
      drop            raise FaultDrop — the instrumented I/O "happened"
                      but its bytes vanished (a lost datagram/frame);
                      the RPC layer swallows it and lets the reply
                      deadline discover the loss
      econnreset      raise ConnectionResetError (peer RST mid-stream)

    keys:
      after=N         arm on the N-th hit of a matching site (1-based,
                      counted per rule; default 1)
      times=M         fire at most M times once armed (default: kill
                      fires once, everything else fires forever)
      ms=T            delay/hang duration in milliseconds (delay
                      default 100)

Examples::

    PADDLE_TPU_FAULT_SPEC="kill:ckpt.write:after=2"
    PADDLE_TPU_FAULT_SPEC="ioerror:io.save:times=2"      # retries succeed
    PADDLE_TPU_FAULT_SPEC="delay:ckpt.gather:ms=300"     # watchdog food

Sites are matched with fnmatch globs, so ``ckpt.*`` covers every
checkpoint-write instant.  The harness is inert (one dict lookup) when
no spec is installed.

Network sites (the fleet RPC layer, both sides of the wire; the
injector is process-global in each package, so a client-process spec
and a server-subprocess spec never collide, and a process that holds
both packages arms or resets each copy on its own)::

    rpc.send     just before a frame is written (client request or
                 server response); ``drop`` makes that frame vanish
    rpc.recv     a complete frame just arrived (client reply or server
                 request); ``drop`` discards it unprocessed
    rpc.accept   a connection was just accepted; ``econnreset`` closes
                 it before any frame is read

    PADDLE_TPU_FAULT_SPEC="drop:rpc.send:after=2:times=1"   # one lost rpc
    PADDLE_TPU_FAULT_SPEC="econnreset:rpc.recv"             # flaky peer
    PADDLE_TPU_FAULT_SPEC="hang:rpc.recv:ms=2000"           # stuck server
"""
from __future__ import annotations

import fnmatch
import os
import signal
import threading
import time
from typing import Dict, List, Optional

__all__ = ["FaultRule", "FaultInjector", "FaultError", "FaultDrop",
           "fault_point", "configure", "active_spec", "reset", "ENV_VAR"]

ENV_VAR = "PADDLE_TPU_FAULT_SPEC"

_MODES = ("ioerror", "kill", "delay", "hang", "drop", "econnreset")


class FaultError(OSError):
    """The injected I/O failure (an OSError so real retry/backoff code
    handles it like a transient disk error)."""


class FaultDrop(Exception):
    """The instrumented operation "happened" but its bytes vanished —
    a lost frame/datagram.  Deliberately NOT an OSError: the RPC layer
    catches it exactly at the fault point and continues silently, so
    the loss is only discovered by the reply deadline (the realistic
    packet-loss failure shape, not a synchronous error)."""


class FaultRule:
    """One parsed ``mode:site[:k=v]*`` clause."""

    def __init__(self, mode: str, site: str, after: int = 1,
                 times: Optional[int] = None, ms: Optional[float] = None):
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}; one of {_MODES}")
        self.mode = mode
        self.site = site
        self.after = max(1, int(after))
        if times is None:
            times = 1 if mode == "kill" else -1    # -1 = unbounded
        self.times = int(times)
        if ms is None:
            ms = 3.6e6 if mode == "hang" else 100.0
        self.ms = float(ms)
        self.hits = 0          # matching fault_point() calls seen
        self.fired = 0

    @classmethod
    def parse(cls, clause: str) -> "FaultRule":
        parts = [p for p in clause.strip().split(":") if p]
        if len(parts) < 2:
            raise ValueError(
                f"fault clause {clause!r} must be mode:site[:k=v]*")
        mode, site, kv = parts[0], parts[1], parts[2:]
        kwargs = {}
        for item in kv:
            k, _, v = item.partition("=")
            if k not in ("after", "times", "ms"):
                raise ValueError(f"unknown fault key {k!r} in {clause!r}")
            kwargs[k] = float(v) if k == "ms" else int(v)
        return cls(mode, site, **kwargs)

    def matches(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site, self.site)

    def should_fire(self) -> bool:
        """Count this hit; True if the rule is armed and not exhausted."""
        self.hits += 1
        if self.hits < self.after:
            return False
        if self.times >= 0 and self.fired >= self.times:
            return False
        self.fired += 1
        return True

    def __repr__(self):
        return (f"FaultRule({self.mode}:{self.site} after={self.after} "
                f"times={self.times} ms={self.ms})")


class FaultInjector:
    """Holds the active rules; thread-safe (checkpoint writers run in
    background threads)."""

    def __init__(self, spec: str = ""):
        self.spec = spec or ""
        self.rules: List[FaultRule] = [
            FaultRule.parse(c) for c in self.spec.split(";") if c.strip()]
        self._lock = threading.Lock()
        self.log: List[str] = []        # fired "mode:site" records

    def hit(self, site: str):
        for rule in self.rules:
            if not rule.matches(site):
                continue
            with self._lock:
                fire = rule.should_fire()
            if not fire:
                continue
            self.log.append(f"{rule.mode}:{site}")
            if rule.mode == "ioerror":
                raise FaultError(
                    f"injected I/O error at fault point {site!r}")
            if rule.mode == "drop":
                raise FaultDrop(
                    f"injected byte loss at fault point {site!r}")
            if rule.mode == "econnreset":
                raise ConnectionResetError(
                    f"injected connection reset at fault point {site!r}")
            if rule.mode == "kill":
                # kill -9 the real process: the point is proving that
                # NOTHING after this line (flush, rename, finally)
                # happens, exactly like a preemption
                os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(60)     # never reached; belt and braces
            if rule.mode in ("delay", "hang"):
                time.sleep(rule.ms / 1000.0)


# -- process-global injector ------------------------------------------------
# Lazily (re)built: the env var is read once per configure()/first use, so
# subprocess tests just set the env before exec and never import us first.
_injector: List[Optional[FaultInjector]] = [None]
_env_seen: List[Optional[str]] = [None]


def configure(spec: Optional[str]) -> FaultInjector:
    """Install a spec in-process (overrides the env var); None/'' resets
    to inert."""
    _injector[0] = FaultInjector(spec or "")
    _env_seen[0] = None if spec else ""
    return _injector[0]


def reset():
    _injector[0] = None
    _env_seen[0] = None


def active_spec() -> Optional[FaultInjector]:
    env = os.environ.get(ENV_VAR, "")
    if _injector[0] is None or (_env_seen[0] is not None
                                and env != _env_seen[0]):
        _injector[0] = FaultInjector(env)
        _env_seen[0] = env
    return _injector[0]


def fault_point(site: str):
    """Mark an injectable instant.  Inert unless a matching rule is
    installed."""
    inj = active_spec()
    if inj is not None and inj.rules:
        inj.hit(site)
