"""Flight recorder: a bounded ring of per-request postmortem records.

When a served request fails — nonzero info after the whole escalation
ladder, a worker-thread exception, an admission-control rejection
(``reason="shed"``) or an in-queue deadline expiry (``reason="deadline"``)
— the interesting evidence (which bucket
it hit, how long each stage took, whether the cache missed, which ladder
rungs ran) is gone by the time anyone looks: the metrics registry only has
aggregates and the chrome-trace is opt-in.  The flight recorder keeps the
last ``capacity`` requests' records in memory (a few hundred bytes each) so
the postmortem artifact *already exists* when the failure happens.

Two dump paths:

* **on demand** — ``ServeQueue.dump_flight(path)`` / ``recorder.dump``
  writes the ring as JSON (schema ``slate_tpu.flight/v1``);
* **automatically** — the queue calls :meth:`FlightRecorder.on_exhaustion`
  when a request exhausts its escalation ladder (or dies on a worker
  exception); the recorder dumps the full ring to ``auto_dump_path``
  (default ``flight_records.json``, override with the
  ``SLATE_TPU_FLIGHT_PATH`` env var) — the black-box file for the solve
  that did not make it.

Records are host-side dicts written under one lock; the recorder adds no
device syncs and no per-request allocation beyond the record itself.  The
schema is the JAX package's, so both packages' dumps pass either
:func:`validate_flight`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

SCHEMA = "slate_tpu.flight/v1"

#: default ring size — bounded, hours-of-traffic safe
DEFAULT_CAPACITY = 512


def _obs():
    from .. import obs

    return obs


@dataclasses.dataclass
class FlightRecord:
    """One request's black-box entry."""

    trace_id: str
    routine: str
    bucket: str
    dtype: str
    t_submit_unix: float
    stages: Dict[str, float]                 # stage -> seconds
    info: Optional[int] = None               # final LAPACK-style code
    cache_hit: Optional[bool] = None
    batch: Optional[int] = None              # padded batch slots
    occupancy: Optional[float] = None        # real / padded slots
    ladder: Tuple[str, ...] = ()             # escalation rungs taken
    exhausted: bool = False                  # ladder ran out, still failing
    error: Optional[str] = None              # worker exception, if any
    lane: str = ""                           # priority lane
    #: why the request was rejected/expired instead of served — ``shed`` /
    #: ``deadline`` / ``worker_error`` / ``worker_death`` (None = served);
    #: a rejection breakdown groups on it
    reason: Optional[str] = None
    deadline_s: Optional[float] = None       # submitted deadline budget
    executor: str = ""                       # serving executor (ex0, ex1, …)
    #: continuous batching: the request joined an already-staged dispatch
    #: (its queue_wait never paid a flush window — ``stages["slot_join"]``
    #: is submit->join, ``queue_wait`` the full submit->batch-start wait)
    slot_joined: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ladder"] = list(self.ladder)
        d["stages"] = {k: round(float(v), 6) for k, v in self.stages.items()}
        return d


class FlightRecorder:
    """The bounded ring + its dump machinery.

    ::

        rec = FlightRecorder(capacity=256)
        q = ServeQueue(flight=rec)
        ...
        rec.dump("flight_records.json")      # on demand
        # (exhausted ladders dump automatically)
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 auto_dump_path: Optional[str] = None):
        self.capacity = int(capacity)
        self.auto_dump_path = auto_dump_path or os.environ.get(
            "SLATE_TPU_FLIGHT_PATH", "flight_records.json")
        self._lock = threading.Lock()
        self._ring: "deque[FlightRecord]" = deque(maxlen=self.capacity)
        self.dumps = 0

    def record(self, rec: FlightRecord) -> None:
        with self._lock:
            self._ring.append(rec)
        _obs().gauge("slate_serve_flight_depth",
                     "records currently held by the flight recorder").set(
                         len(self._ring))

    def records(self, last: Optional[int] = None) -> List[FlightRecord]:
        """Ring contents, oldest first (``last`` trims to the newest N)."""
        with self._lock:
            recs = list(self._ring)
        return recs if last is None else recs[-int(last):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- dumping -------------------------------------------------------------
    def collect(self, reason: str = "on_demand") -> Dict[str, Any]:
        return {"schema": SCHEMA, "reason": str(reason),
                "created_unix": round(time.time(), 3),
                "capacity": self.capacity,
                "records": [r.to_dict() for r in self.records()]}

    def dump(self, path: Optional[str] = None,
             reason: str = "on_demand") -> str:
        """Write the ring as JSON; returns the path written."""
        path = path or self.auto_dump_path
        doc = self.collect(reason=reason)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        with self._lock:
            self.dumps += 1
        _obs().counter("slate_serve_flight_dumps_total",
                       "flight-recorder dumps").inc(reason=reason)
        return path

    def on_exhaustion(self, rec: FlightRecord,
                      reason: str = "ladder_exhausted") -> Optional[str]:
        """The automatic path: a request exhausted its ladder (or died on a
        worker error — ``reason="worker_error"``) — dump the whole ring now,
        while the neighboring requests' records still surround the failure.
        Exception-proof: a full disk must not take the serving queue down
        with it."""
        try:
            return self.dump(reason=reason)
        # telemetry guard: the dump is a
        # best-effort postmortem write; an unwritable path must not kill
        # the serving worker, and no solve runs inside this block
        except Exception:  # pragma: no cover - unwritable auto-dump path
            return None


def validate_flight(doc: Any) -> None:
    """Schema-check a flight dump, raising ``ValueError`` on violation."""
    if not isinstance(doc, dict):
        raise ValueError(f"flight doc must be a dict, got {type(doc)}")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"schema must be {SCHEMA!r}, got {doc.get('schema')!r}")
    if not isinstance(doc.get("records"), list):
        raise ValueError("records must be a list")
    for r in doc["records"]:
        for k in ("trace_id", "routine", "bucket"):
            if not isinstance(r.get(k), str):
                raise ValueError(f"record.{k} must be a string: {r!r}")
        if not isinstance(r.get("stages"), dict):
            raise ValueError("record.stages must be a dict")
