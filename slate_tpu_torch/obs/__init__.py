"""Observability: the metrics registry and the span API.

* **Metrics registry** (:mod:`.registry`) — process-wide counters, gauges and
  histograms with labels, exported as one ``metrics.json`` document (the same
  schema as the JAX package's).
* **Span API** (:mod:`.spans`) — ``obs.scope(routine, **labels)`` wraps a driver
  invocation: a trace region (``utils.trace.trace_block``, device-timed on a
  CUDA argument) plus the ``slate_spans_total`` counter, labeled
  routine/dtype/shape_bucket (and ``nb`` only when passed as a keyword).
  ``obs.instrument`` is the decorator the drivers wear.
* **Time series and SLOs** (:mod:`.timeseries`, :mod:`.slo`) — windowed
  rates and quantiles over the registry, and declared objectives evaluated
  into ``ok``/``warning``/``breach`` verdicts (``slate_slo_*`` gauges) that
  the serving queue's admission control reads.
* **Cost audit** (:mod:`.costaudit` / :mod:`.scaling`) — a counted run's
  collective volume (the run-time collective log of ``parallel.collectives``)
  and this rank's flops / bytes, for every ``parallel/`` routine on a P-rank
  grid; ``python -m slate_tpu_torch.obs.scaling --update-pins`` rewrites the
  P=2 pins.  ``scaling`` imports the parallel tier inside its spec builders,
  so ``import slate_tpu_torch.obs`` stays light.
"""

from .registry import (REGISTRY, SCHEMA, Counter, Gauge, Histogram,
                       MetricsRegistry, quantile_from_counts,
                       validate_metrics)
from .spans import (INSTRUMENT_ATTR, SpanHandle, current_span, instrument,
                    on_phases, scope, span_depth)
from .costaudit import COLLECTIVE_OPS, collective_volume, harvest, harvest_many
from .scaling import (AUDIT_N, AUDIT_NB, RoutineSpec, audit_all,
                      audit_routine, make_grid, spec_names, specs)
from .timeseries import (TIMESERIES_SCHEMA, TimeSeriesSampler,
                         validate_timeseries)
from .slo import (SLO, SLOMonitor, SLOVerdict, STATUS_CODES,
                  default_serve_slos)


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
    """Drop all metrics (test isolation / fresh-run boundary) — the serving
    series a :class:`TimeSeriesSampler` windows and the ``slate_slo_*``
    verdict gauges included, so no test reads another's samples."""
    REGISTRY.reset()


__all__ = [
    "REGISTRY", "SCHEMA", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "quantile_from_counts", "validate_metrics", "INSTRUMENT_ATTR",
    "SpanHandle", "current_span", "instrument", "on_phases", "scope",
    "span_depth", "COLLECTIVE_OPS", "collective_volume", "harvest",
    "harvest_many", "AUDIT_N", "AUDIT_NB", "RoutineSpec", "audit_all",
    "audit_routine", "make_grid", "spec_names", "specs", "TIMESERIES_SCHEMA", "TimeSeriesSampler",
    "validate_timeseries", "SLO", "SLOMonitor", "SLOVerdict", "STATUS_CODES",
    "default_serve_slos", "counter", "gauge", "histogram", "metrics_doc",
    "export_metrics", "reset",
]
