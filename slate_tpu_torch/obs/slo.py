"""SLO monitors: declared objectives evaluated over the window ring.

The serving tier's admission control (``serve.admission``) needs a *verdict*,
not a dashboard: "is gesv p99 latency inside its objective right now, and
how fast is the error budget burning?".  This module turns the
:mod:`.timeseries` ring into exactly that signal:

* an :class:`SLO` **declares** one objective — a per-routine p99 latency
  bound, a maximum error rate, or a minimum cache hit rate after warm-up;
* an :class:`SLOMonitor` **evaluates** the declared set over the last N
  windows of a :class:`~.timeseries.TimeSeriesSampler`, computing the
  classic error-budget burn rate (observed bad fraction / allowed bad
  fraction) and mapping it to a verdict: ``ok`` (burn < 1 — inside budget),
  ``warning`` (budget burning faster than sustainable), ``breach`` (burn
  past the breach multiplier), or ``no_data``;
* every verdict lands in the registry as gauges —
  ``slate_slo_status{slo=...}`` (0 ok / 1 warning / 2 breach / -1 no data)
  and ``slate_slo_burn_rate{slo=...}`` — which is the form
  :class:`~slate_tpu_torch.serve.queue.ServeQueue` consumes
  (``ServeQueue.slo_status()``), and which its admission controller sheds
  load on.

Burn-rate semantics (the SRE-workbook form, windowed): for a latency SLO
"p99 < objective" the budget is the 1% of requests allowed over the bound;
the observed bad fraction is estimated from the window's histogram delta
counts (observations in buckets above the threshold, interpolated within
the straddling bucket).  For rate SLOs the budget is the declared maximum
bad fraction directly.  ``burn = bad_fraction / budget``: 1.0 means burning
exactly the budget, sustained; 2.0 means the budget is gone in half the
period.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .registry import REGISTRY
from .timeseries import TimeSeriesSampler

VERDICT_OK = "ok"
VERDICT_WARNING = "warning"
VERDICT_BREACH = "breach"
VERDICT_NO_DATA = "no_data"

#: verdict -> the gauge code ``slate_slo_status`` carries
STATUS_CODES = {VERDICT_OK: 0, VERDICT_WARNING: 1, VERDICT_BREACH: 2,
                VERDICT_NO_DATA: -1}

KINDS = ("latency", "error_rate", "hit_rate")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective.

    kind:        ``latency`` — p(``target``) of histogram ``metric`` must be
                 under ``objective`` seconds; ``error_rate`` — counter
                 ``metric`` over counter ``total_metric`` must stay under
                 ``objective``; ``hit_rate`` — counter ``metric`` (good)
                 over good + ``total_metric`` (bad) must stay over
                 ``objective``.
    labels:      series filter — a sample matches when its labels contain
                 every (k, v) pair here (subset match, so one SLO can cover
                 a routine across buckets).
    windows:     evaluate over the newest N windows of the ring.
    warmup_windows: ignore the oldest K windows of the *run* (hit-rate SLOs
                 exempt the warm-up compiles this way).
    warn_burn / breach_burn: burn-rate thresholds for the verdict ladder.
    """

    name: str
    kind: str
    metric: str
    objective: float
    total_metric: str = ""
    labels: Tuple[Tuple[str, str], ...] = ()
    target: float = 0.99
    windows: int = 10
    warmup_windows: int = 0
    warn_burn: float = 1.0
    breach_burn: float = 2.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"SLO {self.name}: kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.kind in ("error_rate", "hit_rate") and not self.total_metric:
            raise ValueError(f"SLO {self.name}: {self.kind} needs "
                             "total_metric")
        if self.kind == "latency" and not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO {self.name}: latency target must be in "
                             f"(0, 1), got {self.target}")

    def budget(self) -> float:
        """The allowed bad fraction."""
        if self.kind == "latency":
            return 1.0 - self.target
        if self.kind == "error_rate":
            return self.objective
        return 1.0 - self.objective         # hit_rate


@dataclasses.dataclass
class SLOVerdict:
    """One evaluation: the verdict plus the numbers behind it."""

    name: str
    kind: str
    verdict: str
    burn_rate: Optional[float]
    value: Optional[float]       # observed p-quantile / error rate / hit rate
    objective: float
    bad: float                   # observations over the bound (est.)
    total: float                 # observations considered
    windows_evaluated: int
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in ("burn_rate", "value", "bad", "total"):
            if d[k] is not None:
                d[k] = round(float(d[k]), 6)
        return d


def _match(labels: Dict[str, str], flt: Tuple[Tuple[str, str], ...]) -> bool:
    return all(labels.get(k) == v for k, v in flt)


def _frac_above(buckets: Sequence[float], counts: Sequence[int],
                threshold: float) -> Tuple[float, float]:
    """(observations above ``threshold``, total) for one histogram window —
    full buckets above the bound, plus the straddling bucket's interpolated
    share.  The overflow slot is entirely above any *in-range* threshold;
    for a threshold past the top bound the overflow observations are
    indeterminate (they may still be under it), so they are NOT counted —
    the estimator under-reports rather than fabricating violations."""
    total = float(sum(counts))
    if total <= 0:
        return 0.0, 0.0
    bad = float(counts[len(buckets)]) if threshold <= buckets[-1] else 0.0
    for i, ub in enumerate(buckets):
        lo = buckets[i - 1] if i > 0 else 0.0
        if threshold <= lo:
            bad += counts[i]
        elif threshold < ub:
            bad += counts[i] * (ub - threshold) / (ub - lo)
    return bad, total


class SLOMonitor:
    """Evaluate declared SLOs over a sampler's window ring.

    ::

        mon = obs.SLOMonitor(obs.default_serve_slos(), sampler)
        verdicts = mon.evaluate()        # also sets slate_slo_* gauges
    """

    def __init__(self, slos: Sequence[SLO], sampler: TimeSeriesSampler,
                 registry=None):
        self.slos = tuple(slos)
        self.sampler = sampler
        self.registry = REGISTRY if registry is None else registry

    # -- aggregation over the ring -------------------------------------------
    def _windows_for(self, slo: SLO) -> List[Dict[str, Any]]:
        ws = self.sampler.windows()
        if slo.warmup_windows:
            ws = [w for w in ws if w["index"] >= slo.warmup_windows]
        return ws[-slo.windows:]

    @staticmethod
    def _sum_counter(ws, name, flt) -> float:
        return sum(c["delta"] for w in ws for c in w["counters"]
                   if c["name"] == name and _match(c["labels"], flt))

    def _eval_latency(self, slo: SLO, ws) -> SLOVerdict:
        from .registry import quantile_from_counts

        buckets: Optional[List[float]] = None
        counts: Optional[List[float]] = None
        for w in ws:
            for h in w["histograms"]:
                if h["name"] != slo.metric or not _match(h["labels"],
                                                         slo.labels):
                    continue
                if counts is None:
                    buckets, counts = list(h["buckets"]), [0.0] * len(
                        h["counts"])
                if list(h["buckets"]) == buckets:
                    counts = [a + b for a, b in zip(counts, h["counts"])]
        if counts is None or sum(counts) <= 0:
            return self._verdict(slo, None, None, 0.0, 0.0, len(ws),
                                 "no observations in evaluated windows")
        bad, total = _frac_above(buckets, counts, slo.objective)
        q = quantile_from_counts(buckets, counts, slo.target)
        burn = (bad / total) / slo.budget()
        return self._verdict(slo, burn, q, bad, total, len(ws),
                             f"p{slo.target * 100:g}={q:.4g}s vs "
                             f"objective {slo.objective:g}s")

    def _eval_rate(self, slo: SLO, ws) -> SLOVerdict:
        good_is_metric = slo.kind == "hit_rate"
        a = self._sum_counter(ws, slo.metric, slo.labels)
        b = self._sum_counter(ws, slo.total_metric, slo.labels)
        if good_is_metric:
            total, bad = a + b, b               # metric=hits, total=misses
            value = a / total if total else None
        else:
            total, bad = b, min(a, b)           # metric=errors, total=requests
            value = bad / total if total else None
        if total <= 0:
            return self._verdict(slo, None, None, 0.0, 0.0, len(ws),
                                 "no traffic in evaluated windows")
        burn = (bad / total) / slo.budget() if slo.budget() > 0 else (
            0.0 if bad == 0 else float("inf"))
        what = "hit rate" if good_is_metric else "error rate"
        return self._verdict(slo, burn, value, bad, total, len(ws),
                             f"{what} {value:.4f} vs objective "
                             f"{slo.objective:g}")

    def _verdict(self, slo: SLO, burn, value, bad, total, nwin,
                 detail) -> SLOVerdict:
        if burn is None:
            verdict = VERDICT_NO_DATA
        elif burn < slo.warn_burn:
            verdict = VERDICT_OK
        elif burn < slo.breach_burn:
            verdict = VERDICT_WARNING
        else:
            verdict = VERDICT_BREACH
        return SLOVerdict(name=slo.name, kind=slo.kind, verdict=verdict,
                          burn_rate=burn, value=value,
                          objective=slo.objective, bad=bad, total=total,
                          windows_evaluated=nwin, detail=detail)

    # -- the monitor ---------------------------------------------------------
    def evaluate(self) -> List[SLOVerdict]:
        """Evaluate every declared SLO; publish the verdicts as
        ``slate_slo_status`` / ``slate_slo_burn_rate`` gauges (the signal
        :class:`~slate_tpu_torch.serve.queue.ServeQueue` reads)."""
        verdicts = []
        status = self.registry.gauge(
            "slate_slo_status",
            "SLO verdict per objective: 0 ok, 1 warning, 2 breach, "
            "-1 no data")
        burn_g = self.registry.gauge(
            "slate_slo_burn_rate", "error-budget burn rate per objective")
        for slo in self.slos:
            ws = self._windows_for(slo)
            if slo.kind == "latency":
                v = self._eval_latency(slo, ws)
            else:
                v = self._eval_rate(slo, ws)
            status.set(STATUS_CODES[v.verdict], slo=slo.name)
            if v.burn_rate is not None:
                burn_g.set(v.burn_rate, slo=slo.name)
            verdicts.append(v)
        return verdicts


def default_serve_slos(routines: Sequence[str] = ("gesv", "posv", "gels"),
                       p99_latency_s: float = 1.0,
                       max_error_rate: float = 0.01,
                       min_hit_rate: float = 0.95,
                       warmup_windows: int = 1,
                       windows: int = 20) -> List[SLO]:
    """The serving stack's standard objectives: per-routine p99 submit-to-
    result latency, worker error rate, and executable-cache hit rate after
    warm-up — the three signals the serving admission control needs.
    Thresholds are keyword-tunable (a CPU run loosens latency; a deployment
    on the card tightens it)."""
    slos = [SLO(name=f"{r}_p99_latency", kind="latency",
                metric="slate_serve_latency_seconds",
                labels=(("routine", r),), objective=p99_latency_s,
                target=0.99, windows=windows)
            for r in routines]
    slos.append(SLO(name="serve_error_rate", kind="error_rate",
                    metric="slate_serve_worker_errors_total",
                    total_metric="slate_serve_requests_total",
                    objective=max_error_rate, windows=windows))
    slos.append(SLO(name="serve_cache_hit_rate", kind="hit_rate",
                    metric="slate_serve_cache_hits_total",
                    total_metric="slate_serve_cache_misses_total",
                    objective=min_hit_rate, windows=windows,
                    warmup_windows=warmup_windows))
    return slos
