"""``paddle.save`` / ``paddle.load`` and crash-safe pickling (counterpart
of ``paddle_tpu/framework_io.py``).

The file format is the reference's: a pickle of plain Python and numpy
values in which an API Tensor is a marker dict holding an ndarray (bf16
through a ``uint16`` view) and its ``stop_gradient``; so files written by
either package load in the other.  ``_atomic_pickle`` writes through a
temporary file and ``os.replace``.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load", "_atomic_pickle"]

_TENSOR_KEY = "__paddle_tpu_tensor__"


def _pack(obj):
    from .core.tensor import Tensor
    if isinstance(obj, Tensor):
        v = obj._value.detach().cpu()
        rec = {_TENSOR_KEY: True, "stop_gradient": bool(obj.stop_gradient),
               "bf16": v.dtype == torch.bfloat16}
        rec["data"] = (v.view(torch.int16).numpy().view(np.uint16)
                       if rec["bf16"] else v.numpy())
        return rec
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _tensor_of(rec):
    from .core.tensor import Tensor
    arr = rec["data"]
    if rec.get("bf16"):
        v = torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16).copy()).view(torch.bfloat16)
    else:
        v = torch.from_numpy(np.array(arr, copy=True))
    t = Tensor(v)
    t.stop_gradient = rec.get("stop_gradient", True)
    return t


def _unpack(obj, return_numpy=False):
    if isinstance(obj, dict) and obj.get(_TENSOR_KEY):
        if return_numpy:
            arr = obj["data"]
            return arr.view(np.uint16) if obj.get("bf16") else arr
        return _tensor_of(obj)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        un = [_unpack(v, return_numpy) for v in obj]
        return un if isinstance(obj, list) else tuple(un)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """``paddle.save``: API tensors anywhere in ``obj`` (a state dict, a
    nested structure) as the reference's marker dicts; crash-safe."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    _atomic_pickle(_pack(obj), path, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """``paddle.load``: the saved structure with API tensors on the
    current device (numpy arrays with ``return_numpy``; bf16 as its
    ``uint16`` bits)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy)


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
