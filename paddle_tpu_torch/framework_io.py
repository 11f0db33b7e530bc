"""Crash-safe pickling (a port copy of ``paddle_tpu/framework_io.py``'s
``_atomic_pickle``, the one piece of it the checkpoint layer needs)."""
from __future__ import annotations

import os
import pickle
import time
from typing import Any

__all__ = ["_atomic_pickle"]


def _atomic_pickle(payload: Any, path: str, protocol: int = 4,
                   max_tries: int = 3, backoff_s: float = 0.05):
    """Pickle ``payload`` to ``path`` via temp file + ``os.replace`` —
    a crash or injected failure at any instant leaves either the old
    file or the new one, never a truncated pickle.  Transient I/O errors
    retry with exponential backoff."""
    from .testing.faults import fault_point
    tmp = f"{path}.tmp.{os.getpid()}"
    last = None
    for attempt in range(max_tries):
        try:
            fault_point("io.save")
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=protocol)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return
        except OSError as e:
            last = e
            if attempt < max_tries - 1:
                time.sleep(backoff_s * (2 ** attempt))
        except BaseException:
            # not an I/O failure (an unpicklable object, an interrupt):
            # no retry, but never leave the temp file behind
            _remove_quiet(tmp)
            raise
    _remove_quiet(tmp)
    raise last


def _remove_quiet(path):
    try:
        os.remove(path)
    except OSError:
        pass
