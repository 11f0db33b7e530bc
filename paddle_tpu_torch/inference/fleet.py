"""The two names of ``paddle_tpu/inference/fleet.py`` that the router
uses in process: :class:`EngineRPCError` and :class:`RetryPolicy` (copies).

The multi-process fleet itself (the PTF1 wire protocol, engine server
processes and the remote engine client) is not ported yet.
"""
from __future__ import annotations

import random
import time

__all__ = ["EngineRPCError", "RetryPolicy"]


class EngineRPCError(RuntimeError):
    """An RPC that exhausted its retries (or hit a non-engine server
    failure).  Deliberately NOT a ValueError: the router maps it to the
    engine-lost drain path, never to a capacity rejection."""

    def __init__(self, msg: str, method: str = "", attempts: int = 0):
        super().__init__(msg)
        self.method = method
        self.attempts = attempts


class RetryPolicy:
    """Capped exponential backoff with jitter.

    ``delay(attempt)`` for the 1-based ``attempt``-th failure is
    ``min(max_delay, base_delay * 2**(attempt-1)) * (1 + jitter*u)``
    with ``u`` uniform in [0, 1).  ``sleep``/``rng`` are injectable so
    tests pin the arithmetic on a stub clock."""

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, jitter: float = 0.5,
                 rng=None, sleep=time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self._rng = rng if rng is not None else random.Random()
        self.sleep = sleep

    def delay(self, attempt: int) -> float:
        base = min(self.max_delay,
                   self.base_delay * (2.0 ** (max(1, attempt) - 1)))
        return base * (1.0 + self.jitter * self._rng.random())

    def run(self, fn, retry_on=(OSError,), on_retry=None):
        """Call ``fn`` with up to ``max_attempts`` tries; sleeps
        ``delay(i)`` between them.  The final failure re-raises."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except retry_on as e:
                if attempt >= self.max_attempts:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self.sleep(self.delay(attempt))
