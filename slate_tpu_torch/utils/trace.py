"""Named-region tracing and phase timers.

Reference analogue: ``slate::trace`` (src/auxiliary/Trace.cc, 644 LoC) — RAII
``trace::Block`` regions gathered over MPI into a self-contained SVG timeline — plus
the per-driver ``timers[]`` phase map surfaced by the tester at --timer-level 2
(src/heev.cc:126-212).

The device-side timeline comes from ``torch.profiler``, so this module provides the
*host-side* named-region API:

- ``trace_block(name, **attrs)`` context manager ≅ ``trace::Block``; nests.
- When enabled (``trace.on()``), events are recorded and can be dumped as a
  chrome://tracing JSON (``trace.finish(path)``) — the portable successor of the
  reference's SVG writer; each region is also captured by the native runtime
  (``native.trace_count`` / ``native.trace_dump``).
- ``Timers`` accumulates named phase durations (the drivers' ``timers[]`` map);
  ``phase_report`` renders one hottest-first with shares.
- Request scopes (``request_scope``, ``batch_request_scope``) stamp a serving
  request's ``trace_id`` into every region and event recorded while they are
  open, and ``emit_span`` records a span from explicit timestamps — the
  serving tier's per-request stage spans (``slate_tpu_torch.serve``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_state = threading.local()
_enabled = False
_events: List[Dict[str, Any]] = []
_events_lock = threading.Lock()
_t0 = time.perf_counter()


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


def emit_span(name: str, t_start: float, t_end: float, **attrs) -> None:
    """Record a complete span from explicit ``time.perf_counter`` stamps.

    The serving queue measures a request's stage boundaries as cheap host
    timestamps while the batch runs, then *retrospectively* synthesizes the
    per-request stage spans at resolve time — one request's pad/execute spans
    overlap its batchmates', which nested context managers cannot express.
    No-op while tracing is off; ``ts``/``dur`` land at the measured times."""
    if not _enabled:
        return
    attrs = _stamp_request(attrs)
    ev = {
        "name": name, "ph": "X", "cat": "slate.serve",
        "ts": (t_start - _t0) * 1e6,
        "dur": max(t_end - t_start, 0.0) * 1e6,
        "pid": os.getpid(), "tid": threading.get_ident() % 2**31,
    }
    if attrs:
        ev["args"] = {k: str(v) for k, v in attrs.items()}
    with _events_lock:
        _events.append(ev)


@contextlib.contextmanager
def trace_block(name: str, **attrs):
    """RAII-style named region (reference trace::Block, internal/Trace.hh:103-108).
    While tracing is on, the region is also a native capture region: one
    ``trace_begin`` and, when it opened one, exactly one ``trace_end``."""
    if not _enabled:
        yield
        return
    from .. import native

    start = time.perf_counter()
    opened = native.trace_begin(name)
    try:
        yield
    finally:
        if opened:
            native.trace_end()
        end = time.perf_counter()
        ev = {
            "name": name, "ph": "X", "cat": "slate",
            "ts": (start - _t0) * 1e6, "dur": (end - start) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident() % 2**31,
        }
        attrs = _stamp_request(attrs)
        if attrs:
            ev["args"] = {k: str(v) for k, v in attrs.items()}
        with _events_lock:
            _events.append(ev)


def trace_event(name: str, **attrs) -> None:
    """Record an instant event (chrome-trace ph='i') — the hook the resilience
    layer uses to mark retries, fallback escalations, and injected faults so
    they line up with the surrounding ``trace_block`` regions in one timeline
    (the reference's Trace.cc has no analogue; its recovery paths are
    invisible in the SVG).  No-op while tracing is off."""
    if not _enabled:
        return
    ev = {
        "name": name, "ph": "i", "cat": "slate.robust", "s": "t",
        "ts": (time.perf_counter() - _t0) * 1e6,
        "pid": os.getpid(), "tid": threading.get_ident() % 2**31,
    }
    attrs = _stamp_request(attrs)
    if attrs:
        ev["args"] = {k: str(v) for k, v in attrs.items()}
    with _events_lock:
        _events.append(ev)


def finish(path: Optional[str] = None) -> Optional[str]:
    """Write accumulated events as chrome://tracing JSON (reference
    Trace::finish writes trace_<time>.svg, Trace.cc:330-448). Returns the path.

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
    path = path or f"trace_{int(time.time())}.json"
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
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
