"""Collective-communication watchdog (a copy of
``paddle_tpu/distributed/comm_watchdog.py`` over threads; the port keeps
its own, importing nothing of the reference).

A collective that one rank never enters blocks every other rank inside
``torch.distributed`` for good.  The watchdog is a monitor thread holding
a registry of in-flight :class:`CommTask` s with deadlines; on expiry it
prints a diagnostic (op name, group ranks, elapsed, every thread's stack),
bumps ``comm_timeouts_total`` and calls the abort handler, which by
default only logs; with ``FLAGS_comm_abort_on_timeout`` it kills the
process (exit code 124), as the reference's communicator abort does, so a
launcher can restart a consistent world.

The settings keep the reference's flag names, read from the environment
at each task start: ``FLAGS_comm_task_timeout_s`` (seconds; 0, the
default, disables the watchdog) and ``FLAGS_comm_abort_on_timeout``
(default off).  Every collective of ``distributed/collective.py`` and the
checkpoint manager's snapshot and commit run under :func:`comm_task`.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

__all__ = ["CommTask", "CommTaskManager", "comm_task",
           "get_comm_task_manager", "task_timeout_s", "abort_on_timeout"]

TIMEOUT_ENV = "FLAGS_comm_task_timeout_s"
ABORT_ENV = "FLAGS_comm_abort_on_timeout"


def task_timeout_s() -> float:
    """``FLAGS_comm_task_timeout_s`` (0 when unset or not a number)."""
    try:
        return float(os.environ.get(TIMEOUT_ENV, "0") or 0.0)
    except ValueError:
        return 0.0


def abort_on_timeout() -> bool:
    return os.environ.get(ABORT_ENV, "").strip().lower() in (
        "1", "true", "yes", "on")


class CommTask:
    """One in-flight collective."""

    __slots__ = ("name", "ranks", "start", "deadline", "task_id")

    def __init__(self, name: str, ranks, timeout_s: float, task_id: int):
        self.name = name
        self.ranks = list(ranks) if ranks else []
        self.start = time.monotonic()
        self.deadline = self.start + timeout_s
        self.task_id = task_id


class CommTaskManager:
    """Deadline registry and monitor thread."""

    def __init__(self):
        self._tasks: Dict[int, CommTask] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._timed_out: List[CommTask] = []
        # overridable for tests and custom runtimes
        self.abort_handler: Callable[[CommTask], None] = self._default_abort

    def start_task(self, name: str, ranks=None,
                   timeout_s: Optional[float] = None) -> Optional[CommTask]:
        if timeout_s is None:
            timeout_s = task_timeout_s()
        if timeout_s <= 0:
            return None
        if callable(ranks):
            ranks = ranks()
        with self._lock:
            task = CommTask(name, ranks, timeout_s, self._next_id)
            self._next_id += 1
            self._tasks[task.task_id] = task
            if self._monitor is None or not self._monitor.is_alive():
                self._stop.clear()
                self._monitor = threading.Thread(
                    target=self._monitor_loop, daemon=True,
                    name="comm-watchdog")
                self._monitor.start()
        return task

    def end_task(self, task: Optional[CommTask]):
        if task is None:
            return
        with self._lock:
            self._tasks.pop(task.task_id, None)

    @property
    def timed_out_tasks(self) -> List[CommTask]:
        with self._lock:
            return list(self._timed_out)

    def _monitor_loop(self):
        while not self._stop.is_set():
            time.sleep(0.05)
            now = time.monotonic()
            expired = []
            with self._lock:
                for tid, task in list(self._tasks.items()):
                    if now > task.deadline:
                        expired.append(task)
                        del self._tasks[tid]
                self._timed_out.extend(expired)
            for task in expired:
                try:
                    from ..observability import (default_registry,
                                                 record_instant)
                    default_registry().counter(
                        "comm_timeouts_total",
                        "collectives that exceeded the watchdog "
                        "deadline").inc()
                    record_instant("comm_timeout:%s" % task.name,
                                   cat="comm", ranks=str(task.ranks))
                except Exception:                     # noqa: BLE001
                    pass        # the diagnostic below must still print
                self._report(task)
                try:
                    self.abort_handler(task)
                except Exception:                     # noqa: BLE001
                    traceback.print_exc()

    def _report(self, task: CommTask):
        elapsed = time.monotonic() - task.start
        print("[comm-watchdog] collective '%s' on ranks %s exceeded its "
              "timeout (%.1fs) — probable hang/desync (one rank never "
              "entered the collective)."
              % (task.name, task.ranks or "world", elapsed),
              file=sys.stderr)
        for tid, frame in sys._current_frames().items():
            print("[comm-watchdog] thread %s stack:" % tid, file=sys.stderr)
            traceback.print_stack(frame, file=sys.stderr)

    def _default_abort(self, task: CommTask):
        if abort_on_timeout():
            try:
                from ..observability import default_registry
                default_registry().counter(
                    "comm_aborts_total",
                    "processes killed by the comm watchdog "
                    "(FLAGS_comm_abort_on_timeout)").inc()
            except Exception:                         # noqa: BLE001
                pass
            os._exit(124)

    def shutdown(self):
        self._stop.set()


_manager: List[Optional[CommTaskManager]] = [None]


def get_comm_task_manager() -> CommTaskManager:
    if _manager[0] is None:
        _manager[0] = CommTaskManager()
    return _manager[0]


class comm_task:
    """Context manager wrapping one collective call.  ``ranks`` may be a
    callable, asked only when the watchdog is on."""

    def __init__(self, name: str, ranks=None,
                 timeout_s: Optional[float] = None):
        self._name = name
        self._ranks = ranks
        self._timeout = timeout_s
        self._task = None

    def __enter__(self):
        self._task = get_comm_task_manager().start_task(
            self._name, self._ranks, self._timeout)
        return self._task

    def __exit__(self, *exc):
        get_comm_task_manager().end_task(self._task)
        return False
