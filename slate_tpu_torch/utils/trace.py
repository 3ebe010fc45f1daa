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
  reference's SVG writer.
- ``Timers`` accumulates named phase durations (the drivers' ``timers[]`` map).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_state = threading.local()
_enabled = False
_events: List[Dict[str, Any]] = []
_events_lock = threading.Lock()
_t0 = time.perf_counter()


def on() -> None:
    """Enable tracing (reference trace::Trace::on())."""
    global _enabled
    _enabled = True


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


@contextlib.contextmanager
def trace_block(name: str, **attrs):
    """RAII-style named region (reference trace::Block, internal/Trace.hh:103-108)."""
    if not _enabled:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        end = time.perf_counter()
        ev = {
            "name": name, "ph": "X", "cat": "slate",
            "ts": (start - _t0) * 1e6, "dur": (end - start) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident() % 2**31,
        }
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
    """Named phase-duration accumulator (drivers' timers[] map, heev.cc:126-212)."""

    @contextlib.contextmanager
    def time(self, key: str):
        t = time.perf_counter()
        try:
            yield
        finally:
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
