"""Observability: the metrics registry and the span API.

* **Metrics registry** (:mod:`.registry`) — process-wide counters, gauges and
  histograms with labels, exported as one ``metrics.json`` document (the same
  schema as the JAX package's).
* **Span API** (:mod:`.spans`) — ``obs.scope(routine, **labels)`` wraps a driver
  invocation: a trace region (``utils.trace.trace_block``) plus the
  ``slate_spans_total`` counter and ``slate_span_seconds`` histogram, labeled
  routine/dtype/shape_bucket (and ``nb`` only when passed as a keyword).
  ``obs.instrument`` is the decorator the drivers wear.

The compiled-cost audit, time series and SLO monitors are not ported yet
(ROADMAP.md queue A item 14).
"""

from .registry import (REGISTRY, SCHEMA, Counter, Gauge, Histogram,
                       MetricsRegistry, quantile_from_counts,
                       validate_metrics)
from .spans import (INSTRUMENT_ATTR, current_span, instrument,
                    on_phases, scope, span_depth)


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create a counter on the process registry."""
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    """Get-or-create a gauge (last-write-wins sample) on the process registry."""
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", **kw) -> Histogram:
    """Get-or-create a histogram (bucketed distribution) on the process registry."""
    return REGISTRY.histogram(name, help, **kw)


def metrics_doc(source: str = "unknown") -> dict:
    """The current ``metrics.json`` document (validated shape)."""
    return REGISTRY.collect(source=source)


def export_metrics(path: str, source: str = "unknown") -> str:
    """Write ``metrics.json`` for this run; returns the path."""
    return REGISTRY.export(path, source=source)


def reset() -> None:
    """Drop all metrics (test isolation / fresh-run boundary)."""
    REGISTRY.reset()


__all__ = [
    "REGISTRY", "SCHEMA", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "quantile_from_counts", "validate_metrics", "INSTRUMENT_ATTR",
    "current_span", "instrument", "on_phases", "scope",
    "span_depth", "counter", "gauge", "histogram", "metrics_doc",
    "export_metrics", "reset",
]
