"""Windowed time-series over the metrics registry.

The registry (:mod:`.registry`) answers "what did this process do overall" —
cumulative counters and end-of-run histograms.  SLO-aware admission control
(``serve.admission``) needs *runtime* signals: rates and quantiles **over time windows**, so a monitor can tell a
steady 1% error rate from a burst that burned the week's budget in a minute.

:class:`TimeSeriesSampler` snapshots the registry on an interval into a ring
of fixed-width windows.  Each window carries, per labeled series:

* **counter deltas and rates** — ``delta = cur - prev``, ``rate = delta /
  duration`` (a counter reset mid-flight clamps to 0 rather than reporting a
  negative rate);
* **histogram deltas** — per-slot count deltas plus delta sum/count, with
  p50/p99 estimated from the delta counts via
  :func:`~.registry.quantile_from_counts` — per-window quantiles, not
  since-process-start ones;
* **gauge values** — last write as of the window close.

The ring is bounded (``max_windows``); old windows fall off, so a sampler
left running for hours costs a fixed few hundred KB.  ``export`` writes the
``metrics_timeseries.json`` document (schema ``slate_tpu.timeseries/v1``,
checked by :func:`validate_timeseries` — the same producer/validator pattern
as ``metrics.json``/``validate_metrics``); SLO verdicts evaluated over the
ring (:mod:`.slo`) ride along in the document's ``slos`` section so one
artifact answers both "what happened" and "was it acceptable".

Sampling is registry-read-only and lock-cheap (one ``collect()`` per tick);
the background thread is optional — tests and the CI smoke drive
``sample()`` manually with explicit timestamps for deterministic rate math.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .registry import REGISTRY, MetricsRegistry, quantile_from_counts

SCHEMA = "slate_tpu.timeseries/v1"
#: package-level alias (obs.SCHEMA is the metrics.json schema id)
TIMESERIES_SCHEMA = SCHEMA

#: default ring size — at the default 1 s interval, two minutes of history
DEFAULT_MAX_WINDOWS = 120


def _series_map(doc: Dict[str, Any]) -> Dict[tuple, Dict[str, Any]]:
    """metrics.json document -> {(name, canonical labels): sample}."""
    out: Dict[tuple, Dict[str, Any]] = {}
    for m in doc.get("metrics", ()):
        for s in m.get("samples", ()):
            key = (m["name"], m["kind"],
                   tuple(sorted(s.get("labels", {}).items())))
            out[key] = s
    return out


class TimeSeriesSampler:
    """Interval snapshots of the registry, diffed into a window ring.

    ::

        ts = obs.TimeSeriesSampler(interval_s=1.0)
        ts.start()                       # background thread; or call
        ...                              # ts.sample() manually
        ts.stop()
        ts.export("metrics_timeseries.json", source="serving-smoke")

    ``sample(now=...)`` accepts an explicit ``time.time()`` stamp so rate
    math is exactly testable; the background thread passes real time.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0,
                 max_windows: int = DEFAULT_MAX_WINDOWS):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        self.registry = REGISTRY if registry is None else registry
        self.interval_s = float(interval_s)
        self.max_windows = int(max_windows)
        self._lock = threading.Lock()
        self._windows: "deque[Dict[str, Any]]" = deque(maxlen=self.max_windows)
        self._prev: Optional[Dict[tuple, Dict[str, Any]]] = None
        self._prev_t: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling ------------------------------------------------------------
    def sample(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Take one snapshot; returns the new window (None on the baseline
        call — the first snapshot has nothing to diff against)."""
        now = time.time() if now is None else float(now)
        cur = _series_map(self.registry.collect(source="timeseries"))
        with self._lock:
            prev, prev_t = self._prev, self._prev_t
            self._prev, self._prev_t = cur, now
            if prev is None or now <= prev_t:
                return None
            window = self._diff(prev, cur, prev_t, now)
            window["index"] = (self._windows[-1]["index"] + 1
                               if self._windows else 0)
            self._windows.append(window)
            return window

    @staticmethod
    def _diff(prev: Dict[tuple, Dict[str, Any]],
              cur: Dict[tuple, Dict[str, Any]],
              t0: float, t1: float) -> Dict[str, Any]:
        dur = t1 - t0
        counters: List[Dict[str, Any]] = []
        histograms: List[Dict[str, Any]] = []
        gauges: List[Dict[str, Any]] = []
        for key in sorted(cur):
            name, kind, lkey = key
            s = cur[key]
            p = prev.get(key)
            if kind == "counter":
                delta = s["value"] - (p["value"] if p else 0.0)
                if delta < 0:          # registry reset mid-flight
                    delta = 0.0
                if delta == 0.0:
                    continue           # quiet series stay out of the window
                counters.append({"name": name, "labels": dict(lkey),
                                 "delta": delta,
                                 "rate": delta / dur})
            elif kind == "gauge":
                gauges.append({"name": name, "labels": dict(lkey),
                               "value": s["value"]})
            else:
                pc = p["counts"] if p else [0] * len(s["counts"])
                dcounts = [c - q for c, q in zip(s["counts"], pc)]
                dcount = s["count"] - (p["count"] if p else 0)
                if dcount <= 0 or any(d < 0 for d in dcounts):
                    continue           # quiet, or reset mid-flight
                buckets = s["buckets"]
                histograms.append({
                    "name": name, "labels": dict(lkey),
                    "buckets": list(buckets), "counts": dcounts,
                    "sum": s["sum"] - (p["sum"] if p else 0.0),
                    "count": dcount,
                    "rate": dcount / dur,
                    "p50": quantile_from_counts(buckets, dcounts, 0.50),
                    "p99": quantile_from_counts(buckets, dcounts, 0.99),
                })
        return {"t_start": round(t0, 6), "t_end": round(t1, 6),
                "duration_s": round(dur, 6), "counters": counters,
                "histograms": histograms, "gauges": gauges}

    def windows(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """The ring's windows, oldest first (``last`` trims to the newest N)."""
        with self._lock:
            ws = list(self._windows)
        return ws if last is None else ws[-int(last):]

    # -- background thread ---------------------------------------------------
    def start(self) -> "TimeSeriesSampler":
        """Begin interval sampling on a daemon thread (idempotent); the
        construction-time baseline is the first ``sample()`` call."""
        if self._thread is not None:
            return self
        self.sample()                    # baseline snapshot
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="slate-obs-sampler")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    def stop(self, final_sample: bool = True) -> None:
        """Stop the thread; by default take one last window so activity since
        the final tick is not dropped on the floor."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=max(5.0, 2 * self.interval_s))
            self._thread = None
        if final_sample:
            self.sample()

    def __enter__(self) -> "TimeSeriesSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- serialization -------------------------------------------------------
    def collect(self, source: str = "unknown",
                slos: Optional[List[Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
        """The ``metrics_timeseries.json`` document (schema
        ``slate_tpu.timeseries/v1``); ``slos`` attaches SLO verdicts
        (:meth:`~slate_tpu_torch.obs.slo.SLOVerdict.to_dict` dicts)."""
        doc = {"schema": SCHEMA, "source": str(source),
               "created_unix": round(time.time(), 3),
               "interval_s": self.interval_s,
               "max_windows": self.max_windows,
               "windows": self.windows()}
        if slos is not None:
            doc["slos"] = list(slos)
        return doc

    def export(self, path: str, source: str = "unknown",
               slos: Optional[List[Dict[str, Any]]] = None) -> str:
        doc = self.collect(source=source, slos=slos)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        return path


def validate_timeseries(doc: Any) -> None:
    """Schema-check a ``metrics_timeseries.json`` document, raising
    ``ValueError`` on the first violation (the CI serving-smoke gate runs
    its exported document through this — same pattern as
    :func:`~.registry.validate_metrics`)."""
    if not isinstance(doc, dict):
        raise ValueError(f"timeseries doc must be a dict, got {type(doc)}")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"schema must be {SCHEMA!r}, got {doc.get('schema')!r}")
    if not isinstance(doc.get("source"), str):
        raise ValueError("source must be a string")
    if not isinstance(doc.get("created_unix"), (int, float)):
        raise ValueError("created_unix must be a number")
    if not isinstance(doc.get("interval_s"), (int, float)) \
            or doc["interval_s"] <= 0:
        raise ValueError("interval_s must be a positive number")
    windows = doc.get("windows")
    if not isinstance(windows, list):
        raise ValueError("windows must be a list")
    for w in windows:
        if not isinstance(w, dict):
            raise ValueError(f"window must be a dict, got {type(w)}")
        for k in ("t_start", "t_end", "duration_s"):
            if not isinstance(w.get(k), (int, float)):
                raise ValueError(f"window.{k} must be a number")
        if w["duration_s"] <= 0:
            raise ValueError("window.duration_s must be positive")
        for sec, need_num in (("counters", ("delta", "rate")),
                              ("gauges", ("value",)),
                              ("histograms", ("sum", "rate"))):
            entries = w.get(sec)
            if not isinstance(entries, list):
                raise ValueError(f"window.{sec} must be a list")
            for e in entries:
                if not isinstance(e.get("name"), str) or not e["name"]:
                    raise ValueError(f"window.{sec} entry missing name")
                if not isinstance(e.get("labels"), dict):
                    raise ValueError(f"{e['name']}: labels must be a dict")
                for k in need_num:
                    if not isinstance(e.get(k), (int, float)):
                        raise ValueError(f"{e['name']}: {k} must be a number")
        for h in w["histograms"]:
            bs, cs = h.get("buckets"), h.get("counts")
            if not isinstance(bs, list) or not isinstance(cs, list) \
                    or len(cs) != len(bs) + 1:
                raise ValueError(f"{h['name']}: histogram window needs "
                                 "buckets + len(buckets)+1 counts")
            if not isinstance(h.get("count"), int) or h["count"] <= 0:
                raise ValueError(f"{h['name']}: window count must be a "
                                 "positive int")
            for k in ("p50", "p99"):
                if h.get(k) is not None \
                        and not isinstance(h[k], (int, float)):
                    raise ValueError(f"{h['name']}: {k} must be numeric or "
                                     "null")
    slos = doc.get("slos")
    if slos is not None:
        if not isinstance(slos, list):
            raise ValueError("slos must be a list")
        for v in slos:
            if not isinstance(v.get("name"), str) or not v["name"]:
                raise ValueError("slo verdict missing name")
            if v.get("verdict") not in ("ok", "warning", "breach",
                                        "no_data"):
                raise ValueError(f"{v.get('name')}: bad verdict "
                                 f"{v.get('verdict')!r}")
            if not isinstance(v.get("burn_rate"), (int, float)) \
                    and v.get("burn_rate") is not None:
                raise ValueError(f"{v['name']}: burn_rate must be numeric "
                                 "or null")
