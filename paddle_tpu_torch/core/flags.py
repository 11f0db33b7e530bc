"""Runtime flag registry (a port copy of ``paddle_tpu/core/flags.py``).

Capability parity with the reference's FLAGS system
(reference: paddle/phi/core/flags.cc — 126 PHI_DEFINE_EXPORTED_* definitions;
paddle/utils/flags.h:24 gflags wrapper with a self-contained native fallback).

Flags are process-global knobs, settable three ways (same precedence as the
reference): definition default < environment variable ``FLAGS_<name>`` <
explicit ``set_flags``.  A native C++ registry can be slotted behind this
module later; the Python registry is authoritative for now.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_lock = threading.RLock()


@dataclass
class _FlagDef:
    name: str
    default: Any
    type: type
    help: str
    on_change: Optional[Callable[[Any], None]] = None
    value: Any = None


_REGISTRY: Dict[str, _FlagDef] = {}


def _parse(raw: str, ty: type):
    if ty is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return ty(raw)


def define_flag(name: str, default, help: str = "", type: type | None = None,
                on_change=None):
    """Define a flag. Environment ``FLAGS_<name>`` overrides the default."""
    ty = type if type is not None else default.__class__
    with _lock:
        env = os.environ.get("FLAGS_" + name)
        value = _parse(env, ty) if env is not None else default
        _REGISTRY[name] = _FlagDef(name, default, ty, help, on_change, value)
    return value


def _canon(name: str) -> str:
    # the reference spells flags "FLAGS_<name>" at the set_flags/get_flags
    # surface (python/paddle/base/framework.py set_flags); the registry
    # stores bare names — accept both
    return name[6:] if name.startswith("FLAGS_") else name


def get_flags(flags=None) -> Dict[str, Any]:
    """Query flag values: ``flags`` a name, a list of names, or None
    (all)."""
    with _lock:
        if flags is None:
            return {k: d.value for k, d in _REGISTRY.items()}
        if isinstance(flags, str):
            flags = [flags]
        out = {}
        for k in flags:
            c = _canon(k)
            if c not in _REGISTRY:
                raise ValueError(f"Flag {k!r} is not defined")
            out[k] = _REGISTRY[c].value
        return out


def get_flag(name: str):
    return get_flags([name])[name]


def set_flags(flags: Dict[str, Any]):
    """Set flag values (same surface as paddle.set_flags)."""
    with _lock:
        for k, v in flags.items():
            k = _canon(k)
            if k not in _REGISTRY:
                raise ValueError(f"Flag {k!r} is not defined")
            d = _REGISTRY[k]
            if isinstance(v, str) and d.type is not str:
                v = _parse(v, d.type)
            d.value = d.type(v) if not isinstance(v, d.type) else v
            if d.on_change is not None:
                d.on_change(d.value)


# ---------------------------------------------------------------------------
# Core flag definitions (subset of reference paddle/phi/core/flags.cc that is
# meaningful on TPU; more are defined next to their subsystems).
# ---------------------------------------------------------------------------
define_flag("check_nan_inf", False,
            "Check outputs of every op for NaN/Inf (numerical sanitizer; "
            "reference: paddle/phi/core/flags.cc:62)")
define_flag("check_nan_inf_level", 0,
            "0: error on nan/inf; >0: warn levels "
            "(reference: paddle/phi/core/flags.cc:88)")
define_flag("benchmark", False, "Sync after every op for timing")
define_flag("eager_compile_ops", True,
            "Kept for API parity; the port dispatches every op eagerly")
define_flag("use_pallas_kernels", True,
            "Route the API's attention to the hand-written flash kernels "
            "(csrc/flash_attention*.cu) when it has no mask and no dropout")
define_flag("allocator_strategy", "auto_growth",
            "Kept for API parity; PyTorch's caching allocator owns device "
            "memory (reference: paddle/fluid/memory/allocation/"
            "allocator_strategy.cc:31)")
define_flag("tpu_deterministic", False,
            "Kept for API parity (the reference's deterministic-reduction "
            "request)")
define_flag("log_level", 0, "Verbose logging level (GLOG_v analog)")
