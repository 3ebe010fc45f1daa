"""Escalation policies: declared fallback ladders + host-level retry.

Reference analogue: the fallback behaviors SLATE hard-codes per driver —
``gesv_mixed.cc:93-96`` (Option::UseFallbackSolver re-solves at full
precision), ``gesv_rbt.cc``'s pivoted retry, ``gels_cholqr``'s Householder
escape — each open-coded at its call site.  Here a driver *declares* its
ladder and the one engine runs it, so every driver gets the same retry
accounting, trace events, and report wiring.

Two mechanisms:

* :func:`run_ladder` — host-level escalation over :class:`Rung`\\ s.  A rung
  is ``(name, fn)`` with ``fn() -> (payload, ok)``; the first rung whose
  ``ok`` verdict (the solve's single host sync) holds wins.  Exhaustion
  either raises :class:`~slate_tpu_torch.core.exceptions.ConvergenceError`
  or returns the last payload with ``recovered=False`` recorded on the report.
* :func:`guard_shards` — the failed-shard guard for distributed solves: the
  result passes through ``inject(..., point="output")`` (where a FaultPlan
  simulates a dead device) and, when chaos is active or checking is forced,
  non-finite results re-run the whole solve up to ``max_retries`` times.

The branch ladders (cholqr's Gram→shifted→Householder chain, CSNE's QR
escape) run inside their drivers with one host check per branch; they are
declared in :data:`LADDERS` so the escalation order is documented in one
place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.exceptions import ConvergenceError
from ..utils.trace import attempt_scope, trace_event
from .faults import POINT_OUTPUT, active, count_event as _count, inject
from .report import SolveReport


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Host-level retry knobs for one solve.

    max_retries: same-rung re-runs before escalating to the next rung (used
                 by the shard guard and by rungs whose failure can be
                 transient); 0 = escalate immediately.
    backoff:     seconds to sleep between host-level retries (0 = none; chaos
                 tests keep it 0 so injection stays wall-clock-free).
    ladder:      informational rung names for reports/traces; drivers
                 normally take these from :data:`LADDERS`.
    """

    max_retries: int = 0
    backoff: float = 0.0
    ladder: Tuple[str, ...] = ()

    @classmethod
    def from_options(cls, opts, routine: str = "") -> "RetryPolicy":
        return cls(max_retries=getattr(opts, "max_retries", 0),
                   backoff=getattr(opts, "retry_backoff", 0.0),
                   ladder=LADDERS.get(routine, ()))


#: The declared escalation ladders — the previously implicit per-driver
#: fallbacks, codified (first rung = fast path, later rungs = escalations).
#: The distributed entries are the ladders of ``slate_tpu_torch.parallel``.
LADDERS = {
    "gesv_mixed": ("mixed", "full"),
    "gesv_mixed_gmres": ("mixed_gmres", "full"),
    "posv_mixed": ("mixed", "full"),
    "posv_mixed_gmres": ("mixed_gmres", "full"),
    "gesv_rbt": ("rbt", "partialpiv"),
    "gesv_nopiv": ("nopiv", "partialpiv"),
    "posv_mixed_distributed": ("mixed", "full"),
    "gesv_mixed_distributed": ("mixed", "full"),
    "gesv_rbt_distributed": ("rbt", "partialpiv"),
    "gesv_batched": ("batched", "elementwise"),
    "posv_batched": ("batched", "elementwise"),
    "gels_batched": ("batched", "elementwise"),
    # branch ladders, run inside their drivers (one host check per branch):
    "cholqr": ("cholqr", "shifted_cholqr", "householder"),
    "gels_cholqr": ("csne", "householder"),
}


class Rung(NamedTuple):
    """One escalation step: ``run() -> (payload, ok)`` with ``ok`` a host
    bool (the rung's single device→host sync)."""

    name: str
    run: Callable[[], Tuple[object, bool]]


def _sleep(seconds: float) -> None:
    if seconds > 0:
        time.sleep(seconds)


def run_ladder(routine: str, rungs: Sequence[Rung],
               policy: Optional[RetryPolicy] = None,
               report: Optional[SolveReport] = None,
               raise_on_exhaust: bool = False):
    """Execute an escalation ladder; returns the winning payload.

    Each rung runs ``1 + policy.max_retries`` times before the engine
    escalates (retries re-enter the fault-plan call accounting, so transient
    injected faults clear on retry).  Every escalation emits a ``fallback``
    trace event; retries emit ``retry``.  When a report is supplied it
    accumulates the rung chain, retry count, and the recovered verdict.
    """
    policy = policy or RetryPolicy()
    payload, ok = None, False
    global_attempt = 0      # across rungs AND same-rung retries (the index
    #                         trace.phase_attempts keys failed attempts by)
    for depth, rung in enumerate(rungs):
        if depth > 0:
            trace_event("fallback", routine=routine, to=rung.name)
            _count("slate_robust_fallbacks_total", routine=routine,
                   to=rung.name)
        for attempt in range(1 + max(policy.max_retries, 0)):
            if attempt > 0:
                trace_event("retry", routine=routine, rung=rung.name,
                            attempt=attempt)
                _count("slate_robust_retries_total", routine=routine,
                       rung=rung.name)
                _sleep(policy.backoff)
                if report is not None:
                    report.retries += 1
            with attempt_scope(routine, global_attempt):
                payload, ok = rung.run()
            global_attempt += 1
            if ok:
                break
        if report is not None:
            report.record_rung(rung.name)
        if ok:
            break
    if report is not None:
        report.recovered = bool(ok)
    if not ok:
        # exhaustion is an event of its own: "the ladder ran out" must be
        # distinguishable from the individual fallback steps (which also fire
        # on successful escalations)
        trace_event("ladder_exhausted", routine=routine,
                    rungs=",".join(r.name for r in rungs))
        _count("slate_robust_ladder_exhausted_total", routine=routine)
        if raise_on_exhaust:
            raise ConvergenceError(
                f"{routine}: escalation ladder "
                f"{tuple(r.name for r in rungs)} exhausted", report=report)
    return payload


def guard_shards(routine: str, run: Callable[[], object],
                 policy: Optional[RetryPolicy] = None,
                 check: bool = False):
    """Failed-shard guard for distributed solves.

    ``run()`` executes the full sharded solve and returns its result tensor;
    the result passes through the fault plan's ``output`` point (where
    ``shard_fail`` simulates a dead device).  When a plan is active — or
    ``check=True`` forces it — a non-finite result triggers up to
    ``policy.max_retries`` full re-runs (recompute from the intact input; the
    re-run's injection call index advances so a transient fault clears).
    Returns ``(result, retries_taken)``.  Each finiteness check is one host
    sync; with no plan and ``check=False`` there is none.
    """
    policy = policy or RetryPolicy(max_retries=1)
    X = inject(routine, run(), point=POINT_OUTPUT)
    if active() is None and not check:
        return X, 0
    retries = 0
    while retries < max(policy.max_retries, 0) and \
            not bool(torch.isfinite(X).all()):
        trace_event("retry", routine=routine, rung="shard_recover",
                    attempt=retries + 1)
        _count("slate_robust_retries_total", routine=routine,
               rung="shard_recover")
        _sleep(policy.backoff)
        X = inject(routine, run(), point=POINT_OUTPUT)
        retries += 1
    return X, retries
