"""Span API: ``obs.scope(routine=...)`` — the one instrumentation surface.

A *span* is a host-side named region that simultaneously

* opens a :func:`slate_tpu_torch.utils.trace.trace_block` region (so spans land in
  the chrome-trace timeline next to the existing phase timers and the
  resilience layer's retry/fault instants), and
* records into the metrics registry on close: ``slate_spans_total`` (counter)
  and ``slate_span_seconds`` (histogram), labeled with the routine plus
  whatever labels the caller attached (dtype, shape_bucket, nb, method, ...).

Spans nest; a child records its parent's routine under the ``parent`` label
so nested driver compositions (posv -> potrf) remain attributable.

:func:`instrument` is the decorator the drivers wear: it derives
the standard labels (dtype + shape bucket from the first array argument,
``nb``/``method`` keyword options) and wraps the call in a scope.  Host-side
overhead is a few dict writes per *driver call*, and the counters need no
enable switch (unlike the trace timeline, which stays
opt-in via ``trace.on()``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Any, Dict, Optional

from ..utils.trace import trace_block
from .registry import REGISTRY

_stack = threading.local()

#: attribute stamped on instrumented callables
INSTRUMENT_ATTR = "__obs_routine__"


def current_span() -> Optional[str]:
    """Routine name of the innermost open span on this thread (None outside)."""
    stack = getattr(_stack, "spans", None)
    return stack[-1] if stack else None


def span_depth() -> int:
    """Nesting depth of open spans on this thread (0 outside any scope)."""
    return len(getattr(_stack, "spans", ()))


@contextlib.contextmanager
def scope(routine: str, **labels):
    """Open an observability span around a routine invocation.

    ::

        with obs.scope("potrf", dtype="float32"):
            ...

    Labels are stringified; the span's duration lands in the
    ``slate_span_seconds`` histogram and its count in ``slate_spans_total``.
    The duration is host time: CUDA launches are asynchronous, so it covers
    the device work only where the routine itself waits for the device."""
    labels = {k: str(v) for k, v in labels.items() if v is not None}
    parent = current_span()
    if parent is not None:
        labels.setdefault("parent", parent)
    stack = getattr(_stack, "spans", None)
    if stack is None:
        stack = _stack.spans = []
    stack.append(routine)
    t0 = time.perf_counter()
    try:
        with trace_block(routine, **labels):
            yield
    finally:
        dur = time.perf_counter() - t0
        stack.pop()
        REGISTRY.counter(
            "slate_spans_total",
            "driver invocations, by routine and labels").inc(
                routine=routine, **labels)
        REGISTRY.histogram(
            "slate_span_seconds",
            "host wall time per driver invocation").observe(
                dur, routine=routine, **labels)


def _shape_bucket(shape) -> str:
    """Pow-2 bucket of the largest dim: the sweep label that keeps histogram
    cardinality bounded while separating 64-class from 16384-class rows."""
    try:
        top = max(int(d) for d in shape) if len(shape) else 1
    except (TypeError, ValueError):
        return "unknown"
    b = 1
    while b < top:
        b <<= 1
    return f"<={b}"


_LABEL_KWARGS = ("nb", "method", "lu_panel", "kind", "uplo", "lookahead",
                 "batch", "bucket")


def _derive_labels(args, kwargs) -> Dict[str, Any]:
    """Standard label extraction for :func:`instrument`: best-effort and
    exception-free — a driver call must never fail because of telemetry."""
    labels: Dict[str, Any] = {}
    try:
        for a in args:
            if hasattr(a, "dtype") and hasattr(a, "shape"):
                labels["dtype"] = str(a.dtype).removeprefix("torch.")
                labels["shape_bucket"] = _shape_bucket(a.shape)
                break
        for k in _LABEL_KWARGS:
            v = kwargs.get(k)
            if v is not None and not hasattr(v, "shape"):
                labels[k] = v
    # label derivation is best-effort shape/attr inspection of the call's
    # arguments; a driver call must never fail because of telemetry
    except Exception:
        pass
    return labels


def instrument(fn=None, *, routine: Optional[str] = None):
    """Decorator: wrap a driver in an observability scope.

    ::

        @instrument
        def potrf(A, opts=None, uplo=None): ...

    The routine label defaults to the function name.  Works bare or with the
    ``routine=`` override; idempotent on already-instrumented callables.
    """
    def deco(f):
        if getattr(f, INSTRUMENT_ATTR, None):
            return f
        name = routine or f.__name__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with scope(name, **_derive_labels(args, kwargs)):
                return f(*args, **kwargs)

        setattr(wrapper, INSTRUMENT_ATTR, name)
        return wrapper

    return deco(fn) if fn is not None else deco


def on_phases(routine: str, phases: Dict[str, float],
              attempt: Optional[int] = None) -> None:
    """Absorb a driver's phase-timer map into the metrics registry.

    Called lazily by ``utils.trace.record_phases`` so the trace layer stays
    importable without obs.  Each phase becomes one ``slate_phase_seconds``
    histogram sample."""
    hist = REGISTRY.histogram("slate_phase_seconds",
                              "per-phase host wall time (trace.record_phases)")
    for phase, sec in dict(phases).items():
        try:
            labels = {"routine": routine, "phase": str(phase)}
            if attempt is not None:
                labels["attempt"] = str(attempt)
            hist.observe(float(sec), **labels)
        except (TypeError, ValueError):
            continue
