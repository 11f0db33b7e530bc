"""Runtime metrics registry (a copy of
``paddle_tpu/observability/metrics.py``; this registry is the port's own).

A process-wide registry of labeled ``Counter`` / ``Gauge`` /
``Histogram`` instruments that the port's serving engine and router
record into, scraped by the exporters in
:mod:`paddle_tpu_torch.observability.exporters`.

Design constraints:

- **Hot-path cheap.**  Instruments sit inside the decode loop, so an
  increment is one dict lookup + one tiny per-child lock (never the
  registry lock); registration (``registry.counter(...)``) is idempotent
  so call sites can re-register on every construction without keeping
  module globals.
- **Fixed histogram buckets.**  Boundaries are frozen at registration
  (Prometheus semantics) — observation is a linear scan over ~a dozen
  floats, no allocation.
- **Naming contract** (enforced here and by the metric-name lint of
  ``tools/graftlint/metric_names.py``): snake_case, counters end in
  ``_total``, durations in ``_seconds``, sizes in ``_bytes``.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "MetricError", "default_registry", "counter", "gauge",
           "histogram", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# latency-shaped default (seconds): sub-ms dispatch up to multi-second
# compile/checkpoint stalls
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)


class MetricError(ValueError):
    """Bad metric name / label schema / conflicting registration."""


def _check_name(name: str, kind: str):
    if not _NAME_RE.match(name or ""):
        raise MetricError(
            f"metric name {name!r} must be snake_case "
            f"([a-z][a-z0-9_]*)")
    if kind == "counter" and not name.endswith("_total"):
        raise MetricError(
            f"counter {name!r} must end in '_total' "
            f"(prometheus unit-suffix convention)")
    if kind != "counter" and name.endswith("_total"):
        raise MetricError(
            f"{kind} {name!r} must not end in '_total' (counters only)")


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("labels", "_lock", "_value")

    def __init__(self, labels: Dict[str, str]):
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise MetricError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, value: float):
        # locked like inc/dec: a concurrent set between inc's read and
        # write must not be overwritten by the stale read + amount
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("labels", "_lock", "_bounds", "_counts", "_sum",
                 "_count")

    def __init__(self, labels: Dict[str, str],
                 bounds: Sequence[float]):
        self.labels = labels
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float):
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile by linear interpolation over the fixed
        buckets (``histogram_quantile`` semantics): find the bucket the
        rank ``q * count`` falls in, interpolate linearly inside it.
        The +Inf bucket has no upper edge — mass there reports the
        highest finite boundary (the estimate saturates, it never
        invents values).  NaN when nothing was observed."""
        q = min(1.0, max(0.0, float(q)))
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return float("nan")
        rank = q * total
        acc = 0
        for i, c in enumerate(counts):
            prev, acc = acc, acc + c
            if c and acc >= rank:
                if i >= len(self._bounds):          # +Inf bucket
                    return float(self._bounds[-1])
                hi = float(self._bounds[i])
                lo = float(self._bounds[i - 1]) if i > 0 \
                    else min(0.0, hi)
                frac = min(1.0, max(0.0, (rank - prev) / c))
                return lo + (hi - lo) * frac
        return float(self._bounds[-1])

    # prometheus exposition is CUMULATIVE per bucket
    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        _check_name(name, self.kind)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"bad label name {ln!r} on {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._default = self._make_child({})
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self, labels: Dict[str, str]):
        raise NotImplementedError

    def labels(self, **labelvalues):
        """The child series for these label values (created on first
        use).  Label NAMES must match the registration exactly — a typo'd
        or extra label is a schema bug, not a new series."""
        if tuple(sorted(labelvalues)) != tuple(sorted(self.labelnames)):
            raise MetricError(
                f"{self.name}: labels() got {sorted(labelvalues)}, "
                f"declared labelnames are {sorted(self.labelnames)}")
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child(
                        dict(zip(self.labelnames, key)))
                    self._children[key] = child
        return child

    def children(self):
        return list(self._children.values())

    def _need_default(self):
        if self._default is None:
            raise MetricError(
                f"{self.name} has labels {self.labelnames}; call "
                f".labels(...) first")
        return self._default

    def _schema(self):
        return (self.kind, self.labelnames)


class Counter(_Metric):
    kind = "counter"

    def _make_child(self, labels):
        return _CounterChild(labels)

    def inc(self, amount: float = 1.0):
        self._need_default().inc(amount)

    @property
    def value(self) -> float:
        return self._need_default().value


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self, labels):
        return _GaugeChild(labels)

    def set(self, value: float):
        self._need_default().set(value)

    def inc(self, amount: float = 1.0):
        self._need_default().inc(amount)

    def dec(self, amount: float = 1.0):
        self._need_default().dec(amount)

    @property
    def value(self) -> float:
        return self._need_default().value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames,
                 buckets: Optional[Sequence[float]] = None):
        bounds = tuple(float(b) for b in (buckets if buckets is not None
                                          else DEFAULT_BUCKETS))
        if not bounds or any(b2 <= b1 for b1, b2
                             in zip(bounds, bounds[1:])):
            raise MetricError(
                f"{name}: bucket boundaries must be strictly "
                f"increasing and non-empty, got {bounds}")
        if any(math.isinf(b) or math.isnan(b) for b in bounds):
            raise MetricError(
                f"{name}: +Inf bucket is implicit; boundaries must be "
                f"finite")
        self.buckets = bounds
        super().__init__(name, help, labelnames)

    def _make_child(self, labels):
        return _HistogramChild(labels, self.buckets)

    def observe(self, value: float):
        self._need_default().observe(value)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile from the fixed buckets (linear
        interpolation inside the containing bucket; labeled metrics:
        ``.labels(...).quantile(q)``)."""
        return self._need_default().quantile(q)

    @property
    def sum(self) -> float:
        return self._need_default().sum

    @property
    def count(self) -> int:
        return self._need_default().count

    def _schema(self):
        return (self.kind, self.labelnames, self.buckets)


class MetricsRegistry:
    """Name -> metric map with idempotent get-or-create registration.

    Re-registering an identical (name, kind, labelnames[, buckets])
    schema returns the EXISTING metric — subsystems register at their
    construction sites, and two engines in one process share series.
    A conflicting schema under the same name raises ``MetricError``.
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                candidate_schema = (cls.kind, tuple(labels)) + (
                    ((tuple(float(b) for b in kw["buckets"])
                      if kw.get("buckets") is not None
                      else DEFAULT_BUCKETS),)
                    if cls is Histogram else ())
                if existing._schema() != candidate_schema:
                    raise MetricError(
                        f"metric {name!r} already registered with a "
                        f"different schema {existing._schema()!r}")
                return existing
            metric = cls(name, help, tuple(labels), **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def collect(self) -> Iterable[_Metric]:
        with self._lock:
            metrics = list(self._metrics.values())
        return sorted(metrics, key=lambda m: m.name)

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self):
        """Drop every metric (tests)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able {name: {type, help, series:[{labels, ...}]}} — the
        payload of the JSON exporter and ``bench.py --emit-metrics``."""
        out = {}
        for m in self.collect():
            series = []
            for ch in m.children():
                entry = {"labels": dict(ch.labels)}
                if isinstance(ch, _HistogramChild):
                    entry.update({
                        "buckets": list(m.buckets),
                        "counts": list(ch._counts),
                        "sum": ch.sum, "count": ch.count})
                else:
                    entry["value"] = ch.value
                series.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help,
                           "series": series}
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every built-in subsystem records into
    (and the exporters scrape by default)."""
    return _DEFAULT


def counter(name: str, help: str = "",
            labels: Sequence[str] = ()) -> Counter:
    return _DEFAULT.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return _DEFAULT.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _DEFAULT.histogram(name, help, labels, buckets=buckets)
