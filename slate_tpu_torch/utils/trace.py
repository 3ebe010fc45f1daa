"""Named-region tracing and phase timers.

Reference analogue: ``slate::trace`` (src/auxiliary/Trace.cc, 644 LoC) — RAII
``trace::Block`` regions gathered over MPI into a self-contained SVG timeline — plus
the per-driver ``timers[]`` phase map surfaced by the tester at --timer-level 2
(src/heev.cc:126-212).

- ``trace_block(name, device=None, **attrs)`` context manager ≅ ``trace::Block``;
  nests.  Each region is a *span*: its name and attributes, a span id, its
  parent's id and the id of its root (the outermost open span of the thread,
  shared by every span of one top-level call), and its host open and close as
  raw ``time.perf_counter()`` seconds.  Given a CUDA ``device``, the span is
  also *device-timed*: a timing ``torch.cuda.Event`` on that device's current
  stream at open and at close, never waited on while the program runs.
- Spans record while :func:`recording` is true: under ``trace.on()``, or while
  a ``torch.profiler`` (or autograd profiler) records, as
  ``torch.profiler.record_function`` behaves.  Off, a region costs one test.
- Recorded spans stay in memory until one of two readers takes them:
  :func:`spans` returns them as resolved records (device durations from the
  events' ``elapsed_time``), and :func:`finish` writes them as chrome://tracing
  JSON — the portable successor of the reference's SVG writer — with the
  device-timed ones also on a device track of their own.
- Only ``trace.on()`` arms the native capture (``native.trace_count`` /
  ``native.trace_dump``) and the ``Timers`` phase synchronize: a profiled
  run adds no synchronize and builds nothing.
- ``Timers`` accumulates named phase durations (the drivers' ``timers[]`` map);
  ``phase_report`` renders one hottest-first with shares.
- Request scopes (``request_scope``, ``batch_request_scope``) stamp a serving
  request's ``trace_id`` into every region and event recorded while they are
  open, and ``emit_span`` records a span from explicit timestamps — the
  serving tier's per-request stage spans (``slate_tpu_torch.serve``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_state = threading.local()
_enabled = False
#: recorded spans and instant events, in the order they closed
_events: List[Dict[str, Any]] = []
_events_lock = threading.Lock()
_t0 = time.perf_counter()
_span_ids = itertools.count(1)
_profiler_enabled = torch._C._autograd._profiler_enabled


def on() -> None:
    """Enable tracing (reference trace::Trace::on()) and arm the native
    capture buffer (:mod:`slate_tpu_torch.native`; its first call builds the
    library and raises if the build fails)."""
    global _enabled
    from .. import native

    native.trace_enable(True)
    _enabled = True


def off() -> None:
    """Disable tracing and disarm the native capture buffer."""
    global _enabled
    from .. import native

    _enabled = False
    native.trace_enable(False)


def is_on() -> bool:
    return _enabled


def recording() -> bool:
    """True while spans and events record: under :func:`on`, or while a
    ``torch.profiler`` / autograd profiler is recording."""
    return _enabled or _profiler_enabled()


# ---------------------------------------------------------------------------
# request-scoped trace ids (serving telemetry) — a serving request carries one
# id from submit to resolve; every event recorded while a request scope is
# open on this thread is stamped with it, so a single request's lifeline
# (stage spans, ladder retries, fault instants) is stitchable out of the
# interleaved chrome-trace by filtering on args.trace_id.
# ---------------------------------------------------------------------------


def current_request() -> Optional[str]:
    """Innermost open request trace id on this thread (None outside)."""
    stack = getattr(_state, "requests", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def request_scope(trace_id: Optional[str]):
    """Mark this thread as working on request ``trace_id``; every
    ``trace_block`` / ``trace_event`` recorded inside carries it as the
    ``trace_id`` arg.  ``None`` is a no-op scope (callers need not branch).
    Scopes nest: an inner request (one batch element's escalation ladder
    inside a batch worker) shadows the outer one for its duration."""
    if trace_id is None:
        yield
        return
    stack = getattr(_state, "requests", None)
    if stack is None:
        stack = _state.requests = []
    stack.append(str(trace_id))
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def batch_request_scope(trace_ids):
    """Publish the per-element request ids of the batch this thread is about
    to run, so code below the batched drivers (the element-granular
    escalation in serve/batched.py) can re-open the owning request's scope
    from a bare batch index via :func:`batch_request_id`."""
    prev = getattr(_state, "batch_ids", None)
    _state.batch_ids = tuple(str(t) if t is not None else None
                             for t in trace_ids)
    try:
        yield
    finally:
        _state.batch_ids = prev


def batch_request_id(i: int) -> Optional[str]:
    """Trace id of batch element ``i`` under the innermost
    :func:`batch_request_scope` (None outside one, or out of range)."""
    ids = getattr(_state, "batch_ids", None)
    if ids is None or not 0 <= int(i) < len(ids):
        return None
    return ids[int(i)]


def _stamp_request(attrs: Dict[str, Any]) -> Dict[str, Any]:
    req = current_request()
    if req is not None and "trace_id" not in attrs:
        attrs = dict(attrs)
        attrs["trace_id"] = req
    return attrs


# ---------------------------------------------------------------------------
# spans: recorded while recording(), kept until spans() or finish() takes them
# ---------------------------------------------------------------------------


def _open_spans() -> List[Dict[str, Any]]:
    """This thread's open spans, outermost first."""
    stack = getattr(_state, "spans", None)
    if stack is None:
        stack = _state.spans = []
    return stack


def _timed_device(device) -> Optional[torch.device]:
    """``device`` as a ``torch.device`` when it is a CUDA device, else None."""
    if device is None:
        return None
    try:
        device = torch.device(device)
    except (TypeError, RuntimeError):
        return None
    return device if device.type == "cuda" else None


def _event(device: torch.device):
    """A timing event recorded on ``device``'s current stream; nothing waits
    for it until the span is read."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _new_span(name: str, cat: str, attrs: Dict[str, Any],
              parent: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    sid = next(_span_ids)
    span = {"name": name, "ph": "X", "cat": cat, "id": sid,
            "parent": parent["id"] if parent else None,
            "root": parent["root"] if parent else sid,
            "tid": threading.get_ident() % 2**31}
    attrs = _stamp_request(attrs)
    if attrs:
        span["args"] = {k: str(v) for k, v in attrs.items()}
    return span


def _keep(record: Dict[str, Any]) -> None:
    with _events_lock:
        _events.append(record)


def emit_span(name: str, t_start: float, t_end: float, **attrs) -> None:
    """Record a complete span from explicit ``time.perf_counter`` stamps.

    The serving queue measures a request's stage boundaries as cheap host
    timestamps while the batch runs, then *retrospectively* synthesizes the
    per-request stage spans at resolve time — one request's pad/execute spans
    overlap its batchmates', which nested context managers cannot express,
    so each such span is a root of its own.  No-op while not
    :func:`recording`; the span opens and closes at the measured times."""
    if not recording():
        return
    span = _new_span(name, "slate.serve", attrs, None)
    span["t_open"], span["t_close"] = t_start, max(t_end, t_start)
    _keep(span)


@contextlib.contextmanager
def trace_block(name: str, device=None, **attrs):
    """RAII-style named region (reference trace::Block, internal/Trace.hh:103-108),
    recorded as a span while :func:`recording` is true.  With a CUDA
    ``device`` the span is also timed on that device's current stream (an
    event at open and at close, never waited on here).  Under ``trace.on()``
    the region is also a native capture region: one ``trace_begin`` and, when
    it opened one, exactly one ``trace_end``."""
    if not recording():
        yield
        return
    nat = opened = None
    if _enabled:
        from .. import native as nat

        opened = nat.trace_begin(name)
    stack = _open_spans()
    span = _new_span(name, "slate", attrs, stack[-1] if stack else None)
    dev = _timed_device(device)
    span["t_open"] = time.perf_counter()
    if dev is not None:
        span["_dev"] = dev
        span["_open"] = _event(dev)
        # device offsets count from the open event of the outermost
        # device-timed span around this one on the same device
        outer = next((s for s in stack if s.get("_dev") == dev), None)
        span["_origin"] = (outer["_origin"] if outer is not None
                           else (span["_open"], span["t_open"]))
    stack.append(span)
    try:
        yield
    finally:
        if dev is not None:
            span["_close"] = _event(dev)
        span["t_close"] = time.perf_counter()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is span:
                del stack[i]
                break
        if opened:
            nat.trace_end()
        _keep(span)


def annotate(**attrs) -> None:
    """Add attributes to the innermost span open on this thread (none open:
    a no-op) — a routine's own labels on the span its ``@instrument`` scope
    opened."""
    stack = getattr(_state, "spans", None)
    if stack:
        stack[-1].setdefault("args", {}).update(
            {k: str(v) for k, v in attrs.items()})


def trace_event(name: str, **attrs) -> None:
    """Record an instant event (chrome-trace ph='i') — the hook the resilience
    layer uses to mark retries, fallback escalations, and injected faults so
    they line up with the surrounding ``trace_block`` regions in one timeline
    (the reference's Trace.cc has no analogue; its recovery paths are
    invisible in the SVG).  No-op while not :func:`recording`."""
    if not recording():
        return
    ev = {
        "name": name, "ph": "i", "cat": "slate.robust", "s": "t",
        "ts": (time.perf_counter() - _t0) * 1e6,
        "pid": os.getpid(), "tid": threading.get_ident() % 2**31,
    }
    attrs = _stamp_request(attrs)
    if attrs:
        ev["args"] = {k: str(v) for k, v in attrs.items()}
    _keep(ev)


def _resolve(span: Dict[str, Any]) -> Dict[str, Any]:
    """A recorded span as :func:`spans` returns it; a device-timed span's
    events are waited for here, when it is read."""
    rec = {k: span[k] for k in ("name", "cat", "id", "parent", "root", "tid",
                                "t_open", "t_close")}
    rec["args"] = dict(span.get("args", {}))
    rec.update(device=None, device_ms=None, device_open_ms=None,
               device_close_ms=None)
    if "_dev" in span:
        opened, closed, origin = span["_open"], span["_close"], span["_origin"][0]
        for ev in (origin, opened, closed):
            ev.synchronize()
        rec.update(device=str(span["_dev"]),
                   device_ms=opened.elapsed_time(closed),
                   device_open_ms=origin.elapsed_time(opened),
                   device_close_ms=origin.elapsed_time(closed))
    return rec


def spans() -> List[Dict[str, Any]]:
    """Take the recorded spans out of the buffer, resolved, in the order they
    closed (instant events stay for :func:`finish`).

    Each record holds ``name``, ``cat``, ``args`` (its attributes, as
    strings), ``id``, ``parent`` (None at a root), ``root`` (the id shared by
    every span of one top-level call), ``tid``, ``t_open`` / ``t_close`` (raw
    host ``time.perf_counter()`` seconds) and, for a device-timed span,
    ``device``, ``device_ms`` (from its open event to its close event) and
    ``device_open_ms`` / ``device_close_ms`` (from the open event of the
    outermost device-timed span around it: the root, for a routine's spans);
    those four are None for a span timed on the host alone."""
    global _events
    with _events_lock:
        taken = [e for e in _events if e["ph"] == "X"]
        _events = [e for e in _events if e["ph"] != "X"]
    return [_resolve(s) for s in taken]


def finish(path: Optional[str] = None) -> Optional[str]:
    """Write the recorded spans and events as chrome://tracing JSON (reference
    Trace::finish writes trace_<time>.svg, Trace.cc:330-448). Returns the path.

    A span is one complete event on its thread's track, its ids under
    ``args`` (``span_id``, ``parent_id``, ``root_id``); a device-timed span is also one
    on its device's track, placed by its offset from its origin's open.

    Idempotent and safe under ``off()``: the event buffer is swapped out
    atomically under the lock, so a second ``finish()`` after a flush (or a
    ``finish()`` racing a ``trace_block`` close) returns None instead of
    re-writing a truncated or duplicate trace file — events recorded *after*
    a flush start a fresh buffer and flush on the next call."""
    global _events
    with _events_lock:
        if not _events:
            return None
        events, _events = _events, []
    pid = os.getpid()
    out: List[Dict[str, Any]] = []
    tracks: Dict[str, int] = {}
    for e in events:
        if e["ph"] != "X":
            out.append(e)
            continue
        rec = _resolve(e)
        args = dict(rec["args"], span_id=rec["id"], parent_id=rec["parent"],
                    root_id=rec["root"])
        host = {"name": rec["name"], "ph": "X", "cat": rec["cat"],
                "ts": (rec["t_open"] - _t0) * 1e6,
                "dur": (rec["t_close"] - rec["t_open"]) * 1e6,
                "pid": pid, "tid": rec["tid"], "args": args}
        out.append(host)
        if rec["device"] is not None:
            tid = tracks.setdefault(rec["device"], 2**31 + len(tracks))
            out.append(dict(host, cat=rec["cat"] + ".device", tid=tid,
                            ts=(e["_origin"][1] - _t0) * 1e6
                            + rec["device_open_ms"] * 1e3,
                            dur=rec["device_ms"] * 1e3))
    out += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": f"{dev} device time"}}
            for dev, tid in tracks.items()]
    path = path or f"trace_{int(time.time())}.json"
    payload = {"traceEvents": out, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


class Timers(dict):
    """Named phase-duration accumulator (drivers' timers[] map, heev.cc:126-212).

    Phases time the host.  With ``device`` set to a CUDA device and tracing
    on (:func:`on`), each phase ends in a synchronisation of that device, so
    a phase's time includes its queued work (the JAX bench forces a fetch per
    stage for the same reason), at the cost of one sync per phase.  With
    tracing off a phase never waits for the card."""

    def __init__(self, device=None):
        super().__init__()
        self.device = device

    @contextlib.contextmanager
    def time(self, key: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            if (_enabled and self.device is not None
                    and self.device.type == "cuda"):
                torch.cuda.synchronize(self.device)
            self[key] = self.get(key, 0.0) + (time.perf_counter() - t)


# ---------------------------------------------------------------------------
# per-phase perf attribution (the reference tester's --timer-level 2 map,
# heev.cc:126-212: "timers[...]" rows printed per driver phase)
# ---------------------------------------------------------------------------

_phase_maps: Dict[str, Dict[str, float]] = {}
# per-attempt phase maps: {ladder routine: {attempt index: phase map}} — the
# escalation engine (robust.policy.run_ladder) opens an attempt_scope around
# each rung try, so a retried solve keeps the failed attempt's attribution
# instead of clobbering it with the winning attempt's
_phase_attempts: Dict[str, Dict[int, Dict[str, float]]] = {}


@contextlib.contextmanager
def attempt_scope(routine: str, attempt: int):
    """Mark this thread as running ladder ``routine``'s attempt number
    ``attempt``; phase maps recorded inside accumulate under that attempt
    index (attempt 0 resets the routine's attempt history — a fresh solve).
    Scopes nest: an inner ladder (a distributed rung re-entering a mixed
    solve) shadows the outer one for its duration."""
    with _events_lock:
        if attempt == 0:
            _phase_attempts.pop(routine, None)
    prev = getattr(_state, "attempt", None)
    _state.attempt = (routine, int(attempt))
    try:
        yield
    finally:
        _state.attempt = prev


def record_phases(routine: str, timers: "Timers | Dict[str, float]") -> None:
    """Publish a driver's phase map (called by heev/svd at return, like the
    reference drivers filling ``timers[]``).  The tester and bench read it
    back via :func:`last_phases` so a below-baseline number localizes to a
    phase (he2hb / chase / tridiag / back-transform) instead of a driver.

    Under an :func:`attempt_scope` (escalation-ladder retries) the map also
    accumulates per attempt — :func:`phase_attempts` keeps where the *failed*
    attempts spent their time, which ``last_phases`` alone used to lose."""
    phases = {k: float(v) for k, v in dict(timers).items()}
    cur = getattr(_state, "attempt", None)
    with _events_lock:
        _phase_maps[routine] = dict(phases)
        if cur is not None:
            ladder, attempt = cur
            dest = _phase_attempts.setdefault(ladder, {}).setdefault(
                attempt, {})
            for k, v in phases.items():
                key = k if routine == ladder else f"{routine}.{k}"
                dest[key] = dest.get(key, 0.0) + v
        else:
            _phase_attempts.setdefault(routine, {})[0] = dict(phases)
    try:    # mirror into the metrics registry (obs absorbs the phase channel)
        from ..obs import on_phases
        on_phases(routine, phases, attempt=cur[1] if cur else None)
    except Exception:  # pragma: no cover - obs must never break a driver
        pass


def last_phases(routine: str) -> Dict[str, float]:
    """Most recent phase map for ``routine`` ({} when it has not run)."""
    with _events_lock:
        return dict(_phase_maps.get(routine, {}))


def phase_attempts(routine: str) -> Dict[int, Dict[str, float]]:
    """Phase maps keyed by attempt index for ``routine`` (a run_ladder
    routine name, or a plain driver — then everything sits under attempt 0).
    Unlike :func:`last_phases`, a failed attempt's map survives the retry
    that replaced it."""
    with _events_lock:
        return {a: dict(m) for a, m in
                _phase_attempts.get(routine, {}).items()}


def phase_report(timers: "Timers | Dict[str, float]",
                 min_frac: float = 0.0) -> Dict[str, Any]:
    """Render a Timers map as the --timer-level-2 style attribution table:
    ``{phase: {"s": seconds, "pct": share}}`` sorted hottest-first, plus
    ``"total_s"``.  Phase spans are host wall time; on the card a phase is the
    device's time only where it ends in a sync (``Timers`` syncs under
    ``trace.on()``).  ``min_frac`` drops phases below that share (compact
    bench lines)."""
    items = [(k, float(v)) for k, v in dict(timers).items()]
    total = sum(v for _, v in items)
    out: Dict[str, Any] = {"total_s": round(total, 6)}
    for k, v in sorted(items, key=lambda kv: -kv[1]):
        frac = v / total if total > 0 else 0.0
        if frac < min_frac:
            continue
        out[k] = {"s": round(v, 6), "pct": round(100.0 * frac, 1)}
    return out
