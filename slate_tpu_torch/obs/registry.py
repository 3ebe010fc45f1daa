"""Metrics registry: counters, gauges, histograms with labels.

Reference analogue: none — SLATE's observability is the tester's printed
columns plus trace SVGs.  Here one registry collects the phase timers
(utils/trace.py), the driver spans (obs/spans.py) and the resilience layer's
fault events (robust/), and one ``metrics.json`` document (schema
``slate_tpu.metrics/v1``, the JAX package's) serializes the lot for CI and
offline diffing.

Design points:

* **Label model** — every sample carries a flat ``{str: str}`` label map
  (routine, dtype, shape_bucket, mesh, lu_panel, method, ...).  Label sets
  are canonicalized to sorted tuples so ``inc(a=1, b=2)`` and
  ``inc(b=2, a=1)`` hit the same series.
* **Cardinality cap** — a metric holds at most :data:`MAX_SERIES` distinct
  label sets; past the cap new series fold into one ``{"overflow": "true"}``
  series instead of growing without bound (a sweep over thousands of shapes
  must not turn the registry into the memory leak it is meant to audit).
* **Histograms** — fixed upper-bound buckets (default: log-spaced seconds);
  counts has one extra slot for the overflow bucket, plus sum/count for
  mean-rate queries.
* **Thread safety** — one lock around every mutation; the tester and bench
  both run host threads.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

SCHEMA = "slate_tpu.metrics/v1"

#: per-metric label-set cap (see module docstring)
MAX_SERIES = 512

#: default histogram upper bounds — log-spaced around solver wall times
#: (sub-ms dispatches up to multi-minute distributed factorizations)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                   1.0, 5.0, 10.0, 30.0, 60.0, 300.0)

_OVERFLOW_KEY = (("overflow", "true"),)

LabelKey = Tuple[Tuple[str, str], ...]


def _canon(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def quantile_from_counts(buckets: Sequence[float], counts: Sequence[int],
                         q: float) -> Optional[float]:
    """Estimate the ``q``-quantile (0 <= q <= 1) of a bucketed distribution.

    Prometheus-style: find the bucket holding the target rank and linearly
    interpolate within it (the first bucket interpolates from 0, assuming
    non-negative observations — true of every duration/count histogram
    here).  Observations in the overflow slot clamp to the largest bound —
    the estimator cannot see past its bucket table, so a p99 that lands
    there reads as ">= last bound", not a fabricated value.  Returns None
    on an empty distribution.  Shared by :meth:`Histogram.quantile` and the
    per-window delta estimation in :mod:`.timeseries`."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    seen = 0.0
    for i, ub in enumerate(buckets):
        c = counts[i]
        if seen + c >= rank and c > 0:
            lo = buckets[i - 1] if i > 0 else 0.0
            frac = (rank - seen) / c
            return lo + (ub - lo) * min(max(frac, 0.0), 1.0)
        seen += c
    return float(buckets[-1])     # rank fell in the overflow slot


class _Metric:
    """Base: a named family of label-keyed series."""

    kind = "abstract"

    def __init__(self, name: str, help: str = "",
                 registry: "MetricsRegistry" = None):
        self.name = name
        self.help = help
        self._registry = registry
        self._series: Dict[LabelKey, Any] = {}
        self._lock = registry._lock if registry is not None \
            else threading.Lock()

    def _key(self, labels: Dict[str, Any]) -> LabelKey:
        key = _canon(labels)
        if key not in self._series and len(self._series) >= MAX_SERIES:
            return _OVERFLOW_KEY
        return key

    def series(self) -> Dict[LabelKey, Any]:
        with self._lock:
            return dict(self._series)

    def labeled(self, **labels):
        """The sample value for one exact label set (None when absent)."""
        with self._lock:
            return self._series.get(_canon(labels))


class Counter(_Metric):
    """Monotonic accumulator (retries, faults, spans, test rows)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment {value}")
        with self._lock:
            key = self._key(labels)
            self._series[key] = self._series.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        return float(self.labeled(**labels) or 0.0)


class Gauge(_Metric):
    """Last-write-wins sample (mesh size, HBM footprint, queue depth)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        return self.labeled(**labels)


class Histogram(_Metric):
    """Bucketed distribution (span durations, IR iteration counts)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 registry: "MetricsRegistry" = None):
        super().__init__(name, help, registry)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {self.name}: empty bucket list")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        with self._lock:
            key = self._key(labels)
            state = self._series.get(key)
            if state is None:
                state = {"counts": [0] * (len(self.buckets) + 1),
                         "sum": 0.0, "count": 0}
                self._series[key] = state
            idx = len(self.buckets)            # overflow slot by default
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    idx = i
                    break
            state["counts"][idx] += 1
            state["sum"] += value
            state["count"] += 1

    def snapshot(self, **labels) -> Optional[Dict[str, Any]]:
        state = self.labeled(**labels)
        if state is None:
            return None
        return {"buckets": list(self.buckets),
                "counts": list(state["counts"]),
                "sum": state["sum"], "count": state["count"]}

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Bucket-interpolated ``q``-quantile (0 <= q <= 1) of one series —
        p50/p99 derivable live, not just end-of-run (see
        :func:`quantile_from_counts` for the estimator and its clamping at
        the overflow slot).  None when the series has no observations."""
        state = self.labeled(**labels)
        if state is None:
            return None
        return quantile_from_counts(self.buckets, state["counts"], q)


class MetricsRegistry:
    """The process-wide metric family table.

    ``counter/gauge/histogram`` are get-or-create: repeated calls with the
    same name return the same object; a name reused across kinds raises (the
    one schema must stay coherent across bench, tester, and chaos runs).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, registry=self, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        h = self._get(Histogram, name, help, buckets=buckets)
        want = tuple(sorted(float(b) for b in buckets))
        if want != h.buckets and want != tuple(DEFAULT_BUCKETS):
            # a get with explicit non-default bounds against a family created
            # with different ones would silently mis-bucket its observations;
            # passing the default means "whatever exists" and stays a lookup
            raise ValueError(
                f"histogram {name!r} exists with buckets {h.buckets}, "
                f"requested {want}")
        return h

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every metric family (tests; a fresh run's clean slate)."""
        with self._lock:
            self._metrics.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    # -- serialization ------------------------------------------------------
    def collect(self, source: str = "unknown") -> Dict[str, Any]:
        """The ``metrics.json`` document (schema ``slate_tpu.metrics/v1``) —
        the one shape bench, tester, and chaos-suite runs all emit."""
        with self._lock:
            metrics: List[Dict[str, Any]] = []
            for name in sorted(self._metrics):
                m = self._metrics[name]
                samples = []
                for key in sorted(m._series):
                    val = m._series[key]
                    sample: Dict[str, Any] = {"labels": dict(key)}
                    if m.kind == "histogram":
                        sample.update(buckets=list(m.buckets),
                                      counts=list(val["counts"]),
                                      sum=val["sum"], count=val["count"])
                    else:
                        sample["value"] = val
                    samples.append(sample)
                metrics.append({"name": name, "kind": m.kind,
                                "help": m.help, "samples": samples})
        return {"schema": SCHEMA, "source": str(source),
                "created_unix": round(time.time(), 3), "metrics": metrics}

    def export(self, path: str, source: str = "unknown") -> str:
        doc = self.collect(source=source)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=False)
            f.write("\n")
        return path


def validate_metrics(doc: Any) -> None:
    """Schema-check a ``metrics.json`` document, raising on the first violation.

    The schema test runs bench/tester/chaos documents through this, so the
    three producers cannot drift apart silently."""
    if not isinstance(doc, dict):
        raise ValueError(f"metrics doc must be a dict, got {type(doc)}")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"schema must be {SCHEMA!r}, got {doc.get('schema')!r}")
    if not isinstance(doc.get("source"), str):
        raise ValueError("source must be a string")
    if not isinstance(doc.get("created_unix"), (int, float)):
        raise ValueError("created_unix must be a number")
    metrics = doc.get("metrics")
    if not isinstance(metrics, list):
        raise ValueError("metrics must be a list")
    for m in metrics:
        name = m.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError(f"metric name missing/empty: {m!r}")
        kind = m.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"{name}: bad kind {kind!r}")
        if not isinstance(m.get("samples"), list):
            raise ValueError(f"{name}: samples must be a list")
        for s in m["samples"]:
            labels = s.get("labels")
            if not isinstance(labels, dict) or not all(
                    isinstance(k, str) and isinstance(v, str)
                    for k, v in labels.items()):
                raise ValueError(f"{name}: labels must be str->str")
            if kind == "histogram":
                bs, cs = s.get("buckets"), s.get("counts")
                if not isinstance(bs, list) or not isinstance(cs, list):
                    raise ValueError(f"{name}: histogram needs buckets+counts")
                if len(cs) != len(bs) + 1:
                    raise ValueError(
                        f"{name}: counts must have len(buckets)+1 slots "
                        f"(got {len(cs)} for {len(bs)} buckets)")
                if not isinstance(s.get("sum"), (int, float)) \
                        or not isinstance(s.get("count"), int):
                    raise ValueError(f"{name}: histogram needs sum+count")
            else:
                if not isinstance(s.get("value"), (int, float)):
                    raise ValueError(f"{name}: sample value must be numeric")


#: the process-wide registry every subsystem reports into
REGISTRY = MetricsRegistry()
