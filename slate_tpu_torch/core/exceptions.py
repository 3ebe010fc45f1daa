"""Exceptions (reference: include/slate/Exception.hh:1-126).

The reference wraps MPI errors (`internal/mpi.hh:10-37`); here there is no MPI — PyTorch
errors propagate natively — so the library-level exception hierarchy and the assert
helper remain.  The taxonomy below mirrors the *failure classes* the reference's
drivers distinguish through info codes and fallback paths (SURVEY §2.7):

- :class:`NumericalError` — the factorization/solve ran but the numbers broke
  (non-finite values, loss of positive definiteness, breakdown pivots).
- :class:`SingularMatrixError` — a zero/NaN pivot made the matrix numerically
  singular (LAPACK info > 0 from LU/Cholesky-class factorizations).
- :class:`ConvergenceError` — an iterative stage (IR, GMRES-IR, eigensolver
  iteration) stalled and every declared escalation rung was exhausted.
  Raised by ``robust.run_ladder`` (not ported yet) when the caller asks for it
  (``raise_on_exhaust=True``); the built-in drivers keep LAPACK semantics
  instead — best-effort result, nonzero info, ``recovered=False`` report.

The serving tier (``serve``) adds two *operational* failure
classes — the numbers were fine (or never computed), the service declined
the work:

- :class:`QueueOverloadError` — admission control rejected the request
  (lane queue full, token bucket empty, or SLO-coupled shedding active).
  Carries the lane, the observed queue depth, and a retry-after hint.
- :class:`DeadlineExceededError` — a queued request's deadline budget ran
  out before (or while) it would have been served; the queue expires it
  instead of wasting a batch slot.
"""

from __future__ import annotations


class SlateError(RuntimeError):
    """Library error (reference slate_error / SLATE Exception.hh:1-60)."""


class NumericalError(SlateError):
    """A computation produced numerically invalid results.

    Covers non-finite values, indefinite matrices where SPD was required,
    and breakdown pivots."""


class SingularMatrixError(NumericalError):
    """The matrix is numerically singular (zero/NaN pivot; LAPACK info > 0).

    ``info`` carries the 1-based index of the first failing pivot when known.
    """

    def __init__(self, msg: str = "", info: int = 0):
        super().__init__(msg or f"singular matrix (info={info})")
        self.info = int(info)


class ConvergenceError(NumericalError):
    """An iterative solve failed to converge and no fallback recovered it.

    Raised by ``robust.run_ladder(..., raise_on_exhaust=True)``; the built-in
    drivers return best-effort + nonzero info instead of raising (LAPACK
    convention), so catch this only around ladders you run with that flag.
    ``report`` (when set) is the :class:`slate_tpu_torch.robust.SolveReport` of the
    exhausted escalation ladder.
    """

    def __init__(self, msg: str = "", report=None):
        super().__init__(msg or "iterative solve failed to converge")
        self.report = report


class QueueOverloadError(SlateError):
    """Admission control rejected the request — the serving tier is shedding.

    Structured fields (the load-balancer / retry-loop contract):

    ``lane``          the priority lane the request targeted;
    ``depth``         that lane's queue depth at rejection time;
    ``reason``        what tripped — ``depth`` (lane queue full),
                      ``inflight`` (global in-flight cap), ``rate`` (token
                      bucket empty), ``slo_warning`` / ``slo_breach``
                      (SLO-coupled shedding);
    ``retry_after_s`` hint for when the caller may retry (None = unknown —
                      re-probe, don't hammer).
    """

    def __init__(self, msg: str = "", lane: str = "", depth: int = 0,
                 reason: str = "", retry_after_s: float = None):
        super().__init__(
            msg or f"serve: lane {lane!r} shedding load "
                   f"(reason={reason or '?'}, depth={depth})")
        self.lane = str(lane)
        self.depth = int(depth)
        self.reason = str(reason)
        self.retry_after_s = (None if retry_after_s is None
                              else float(retry_after_s))


class DeadlineExceededError(SlateError):
    """A request's deadline budget expired before it was served.

    ``lane`` / ``deadline_s`` (the submitted budget, seconds) /
    ``elapsed_s`` (time spent queued when the queue expired it)."""

    def __init__(self, msg: str = "", lane: str = "",
                 deadline_s: float = 0.0, elapsed_s: float = 0.0):
        super().__init__(
            msg or f"serve: deadline of {deadline_s:g}s exceeded after "
                   f"{elapsed_s:.3f}s queued (lane {lane!r})")
        self.lane = str(lane)
        self.deadline_s = float(deadline_s)
        self.elapsed_s = float(elapsed_s)


def slate_assert(cond: bool, msg: str = "") -> None:
    """Check a library invariant (reference slate_assert, Exception.hh:100-126)."""
    if not cond:
        raise SlateError(msg or "assertion failed")
