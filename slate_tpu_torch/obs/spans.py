"""Span API: ``obs.scope(routine=...)`` — the one instrumentation surface.

A *span* is a named region that simultaneously

* opens a :func:`slate_tpu_torch.utils.trace.trace_block` region (so spans land in
  the chrome-trace timeline and in ``trace.spans()`` next to the existing
  phase timers and the resilience layer's retry/fault instants, whenever
  ``trace.recording()``), timed on the card too when the call's first tensor
  argument lives on a CUDA device, and
* counts the call in the metrics registry on close: ``slate_spans_total``,
  labeled with the routine plus whatever labels the caller attached (dtype,
  shape_bucket, nb, method, ...).

Spans nest; a child records its parent's routine under the ``parent`` label
so nested driver compositions (posv -> potrf) remain attributable.

:func:`instrument` is the decorator the drivers wear: it derives
the standard labels (dtype + shape bucket from the first array argument,
``nb``/``method`` keyword options, and the device of that argument) and
wraps the call in a scope.  Host-side overhead is a few dict writes per
*driver call*, and the counter needs no enable switch (unlike the trace
spans, which record only under ``trace.on()`` or a running profiler).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict, Optional, Tuple

import torch

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


class SpanHandle:
    """The object a :func:`scope` yields: a slot for the span's result.

    With ``device_sync=True`` on the scope, the recorded duration includes a
    wait for the device stream that produced the tensor handed to
    :meth:`set_result` — without it, asynchronous CUDA launches would close
    the span at *launch* time and the execute histogram would measure queue
    depth, not compute.
    """

    __slots__ = ("_result",)

    def __init__(self):
        self._result = None

    def set_result(self, value) -> None:
        """Attach the span's device result (waited for at close when the
        scope was opened with ``device_sync=True``)."""
        self._result = value


def _wait_for(result) -> None:
    """Block until the current stream of ``result``'s CUDA device has run
    everything queued so far (a no-op for CPU tensors and non-tensors)."""
    if isinstance(result, torch.Tensor) and result.is_cuda:
        torch.cuda.current_stream(result.device).synchronize()


@contextlib.contextmanager
def scope(routine: str, device_sync: bool = False, device=None, **labels):
    """Open an observability span around a routine invocation.

    ::

        with obs.scope("potrf", dtype="float32"):
            ...

    Labels are stringified; the call's count lands in ``slate_spans_total``
    and, while ``trace.recording()``, the trace span carries them.  Given a
    CUDA ``device``, the trace span is also timed on that device's current
    stream (``trace.trace_block``), without a wait.  With
    ``device_sync=True`` (the serve execute stage) the span waits for the
    tensor attached through the yielded :class:`SpanHandle` before it
    closes; such spans carry a ``device_sync="true"`` label so synced and
    unsynced calls never mix in one series::

        with obs.scope("serve.execute", device_sync=True) as sp:
            sp.set_result(driver(A, B))
    """
    labels = {k: str(v) for k, v in labels.items() if v is not None}
    if device_sync:
        labels["device_sync"] = "true"
    parent = current_span()
    if parent is not None:
        labels.setdefault("parent", parent)
    stack = getattr(_stack, "spans", None)
    if stack is None:
        stack = _stack.spans = []
    stack.append(routine)
    handle = SpanHandle()
    try:
        with trace_block(routine, device=device, **labels):
            yield handle
            if device_sync:
                _wait_for(handle._result)
    finally:
        stack.pop()
        REGISTRY.counter(
            "slate_spans_total",
            "driver invocations, by routine and labels").inc(
                routine=routine, **labels)


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


def _derive_labels(args, kwargs) -> Tuple[Dict[str, Any], Any]:
    """Standard label extraction for :func:`instrument`, and the device of
    the first array argument (None without one): best-effort and
    exception-free — a driver call must never fail because of telemetry."""
    labels: Dict[str, Any] = {}
    device = None
    try:
        for a in args:
            if hasattr(a, "dtype") and hasattr(a, "shape"):
                labels["dtype"] = str(a.dtype).removeprefix("torch.")
                labels["shape_bucket"] = _shape_bucket(a.shape)
                device = getattr(a, "device", None)
                break
        for k in _LABEL_KWARGS:
            v = kwargs.get(k)
            if v is not None and not hasattr(v, "shape"):
                labels[k] = v
    # label derivation is best-effort shape/attr inspection of the call's
    # arguments; a driver call must never fail because of telemetry
    except Exception:
        pass
    return labels, device


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
            labels, device = _derive_labels(args, kwargs)
            with scope(name, device=device, **labels):
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
