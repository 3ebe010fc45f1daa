"""Batched solve drivers: a leading batch dimension as a first-class axis.

Reference analogue: SLATE's layer map reserves a whole batch-BLAS tier
(PAPER.md L1) that the single-``Matrix`` drivers never exposed.  These
drivers close that gap for the hot solves — ``gesv`` / ``posv`` / ``gels`` —
by running the pure cores (:func:`slate_tpu_torch.linalg.gesv_core` /
``posv_core`` / ``gels_core``) on torch's leading batch axis (the JAX
package vmaps them) through the prepared-program cache (:mod:`.cache`), so a
million small solves is one batched library call chain per packed batch,
not a million dispatches.

Health semantics (the part a naive batch gets wrong):

* **Per-request info.**  Every driver returns an ``info`` *vector* — element
  i's LAPACK code comes from element i's factor alone (the batched form of
  ``robust.first_bad_index``).  A poisoned element reports its own pivot
  index; its siblings report 0 and their results are those of a clean batch.
* **Element-granular escalation.**  When ``Options.use_fallback_solver``
  holds (the default), elements whose verdict failed re-run *alone* under
  the declared ladder (robust.LADDERS["<routine>"]: batched → elementwise),
  re-entering the fault-injection site from the pristine operand — so a
  transient injected fault clears on the re-run, and one bad request never
  costs its batchmates a recompute.
* **Per-request reports.**  ``Options(solve_report=True)`` appends a list of
  :class:`~slate_tpu_torch.robust.SolveReport`, one per element, each
  carrying its own info / fallback chain / recovered verdict.

Device rule: a tensor handed in keeps its device; numpy input goes to
``cuda`` unless ``device="cpu"`` (or another device) is given.  A CUDA batch
never takes a CPU path.

Host syncs: :func:`start_batched` has none — it launches the batch on the
current stream and returns (the executor pool's dispatch/resolve overlap is
built on that); :func:`finish_batched` reads the per-element verdict (info +
finiteness) back once, and each escalated element once more.

Fault-injection addressing: with a :class:`~slate_tpu_torch.robust.FaultPlan`
active, the batched drivers pass each element through ``inject(routine,
...)`` individually, so ``FaultSpec(call_index=i)`` targets element i of the
first batched call (and re-runs advance the counter past the batch, making
call_index < batch faults transient by construction).  With no plan active
the whole batch passes through as one zero-overhead call.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..core.exceptions import slate_assert
from ..core.matrix import BaseMatrix, as_array, write_back
from ..core.types import Options
from ..linalg.chol import posv_core
from ..linalg.lu import gesv_core
from ..linalg.qr import gels as _gels_full, gels_core
from ..obs import instrument
from ..robust import (RetryPolicy, Rung, SolveReport, active, inject,
                      run_ladder)
from ..robust.faults import count_event
from ..utils.trace import batch_request_id, request_scope, trace_event
from .cache import ExecutableCache, default_cache, dtype_name

# thread-local side channel: per-element escalation outcomes of this
# thread's most recent batched driver call.  The serving queue reads it
# (``last_escalations``) to fill flight-recorder records with the ladder
# rungs a request actually took — without threading report objects through
# the hot path or changing the drivers' return arity.
_tl = threading.local()


def last_escalations() -> Dict[int, Dict[str, Any]]:
    """``{batch element: {"rungs": (...), "recovered": bool}}`` for the most
    recent batched driver call on this thread ({} when nothing escalated);
    budget-capped elements additionally carry ``"capped": True``."""
    return {k: dict(v) for k, v in
            (getattr(_tl, "escalations", None) or {}).items()}


def set_escalation_gate(gate: Optional[Callable[[int], int]]):
    """Install this thread's escalation budget; returns the previous gate.

    ``gate(n)`` is asked how many of ``n`` failed elements may ladder-
    re-run right now (the serving queue passes its
    :class:`~slate_tpu_torch.serve.admission.EscalationBudget`'s ``take``).
    Elements past the allowance skip :func:`_escalate` entirely — they keep
    their rung-1 payload/info, are marked ``capped`` in the side channel,
    and their reports finalize ``recovered=False`` — so a retry storm from
    a poisoned workload cannot starve fresh traffic.  ``None`` (the
    default, and the direct-call path) means unlimited."""
    prev = getattr(_tl, "esc_gate", None)
    _tl.esc_gate = gate
    return prev


#: routine name -> pure single-matrix core (run on the leading batch axis)
CORES = {
    "gesv_batched": gesv_core,
    "posv_batched": posv_core,
    "gels_batched": gels_core,
}


def _gels_elem(a, b):
    """Elementwise-rung gels: the FULL driver (CSNE + Householder escape +
    rank-deficiency clamp) — affordable here because only failed elements
    take this path, one at a time, outside the batched program."""
    x = as_array(_gels_full(a, b))
    info = torch.where(torch.isfinite(x).all(), 0, 1).to(torch.int32)
    return x, info


#: routine name -> the stronger single-matrix form the elementwise rung runs
ELEM_CORES = {
    "gesv_batched": gesv_core,      # partial pivoting is already the
    "posv_batched": posv_core,      # strongest form for these two; the
    #                                 re-run's value is the pristine operand
    "gels_batched": _gels_elem,     # full escape ladder for least squares
}


def _inject_each(routine: str, a: torch.Tensor) -> torch.Tensor:
    """Element-wise injection boundary (see module docstring).  Zero-overhead
    when no plan is active: one ``active()`` check, no per-element calls."""
    if active() is None:
        return a
    return torch.stack([inject(routine, a[i]) for i in range(a.shape[0])])


def _as_batch(A, B, routine: str, device=None):
    a = as_array(A, device)
    b = as_array(B, a.device)
    slate_assert(a.ndim == 3, f"{routine}: A must be (batch, m, n), "
                              f"got shape {tuple(a.shape)}")
    squeeze = b.ndim == 2
    if squeeze:
        b = b[..., None]
    slate_assert(b.ndim == 3 and b.shape[0] == a.shape[0]
                 and b.shape[1] == a.shape[1],
                 f"{routine}: B must be (batch, m[, nrhs]) conformal with A, "
                 f"got A {tuple(a.shape)}, B {tuple(b.shape)}")
    return a, b, squeeze


def batched_build(routine: str) -> Callable:
    """The ONE program factory the cache prepares for ``routine``.

    ``ExecutableCache.make_key`` does not fold in function identity, so every
    site that prepares under a routine's key (the drivers here, the queue's
    ``warmup`` sweep) MUST use this factory — a second hand-rolled copy that
    drifted would let warm traffic key-match a stale program.  The cores
    take a leading batch axis natively (the JAX package's ``jax.vmap``)."""
    return CORES[routine]


def _run_batched(routine: str, a, b, opts: Options,
                 cache: Optional[ExecutableCache], donate: bool):
    """The rung-1 batch solve: the batched core through the cache."""
    cache = default_cache() if cache is None else cache
    ex = cache.get(routine, batched_build(routine), (a, b), opts,
                   donate=donate)
    return ex(a, b)


def _escalate(routine: str, core: Callable, a0, b, idx: Sequence[int],
              opts: Options, out_arrays: List, info, reports):
    """Re-run the failed elements one by one under the declared ladder.

    ``out_arrays`` are the per-routine payload tensors (x [, perm]); each
    recovered element's row is copied into them in place (they are this
    call's own outputs).  Returns the updated ``(out_arrays, info)``."""
    policy = RetryPolicy.from_options(opts, routine)
    escal = getattr(_tl, "escalations", None)
    for i in idx:
        # re-open the owning serving request's scope (if the queue published
        # a batch id map) so the fallback/retry/exhaustion events below carry
        # that request's trace_id in the timeline
        with request_scope(batch_request_id(int(i))):
            trace_event("fallback", routine=routine, to="elementwise",
                        elem=int(i))
            count_event("slate_robust_fallbacks_total", routine=routine,
                        to="elementwise")
            state = {}

            def elem_rung(i=i):
                ai = inject(routine, a0[i])  # pristine operand, counter moves
                out = core(ai, b[i])
                ok = bool((out[-1] == 0) & torch.isfinite(out[0]).all())
                state["out"] = out
                state["ok"] = ok
                return out, ok

            report = reports[i] if reports is not None else None
            run_ladder(routine, [Rung("elementwise", elem_rung)], policy,
                       report)
            out = state["out"]
            if escal is not None:
                escal[int(i)] = {"rungs": ("batched", "elementwise"),
                                 "recovered": bool(state["ok"])}
        for slot, val in zip(out_arrays, out[:-1]):
            slot[0][i] = val
        info[i] = out[-1]
    return out_arrays, info


class PendingBatch:
    """An in-flight batched solve: :func:`start_batched`'s async handle.

    Holds everything :func:`finish_batched` needs to read the verdict back
    and run the escalation half — the pristine operands (``a0`` for ladder
    re-runs), the raw driver output (tensors whose kernels may still be
    running on the stream that launched them), and the option/verdict flags
    decided at dispatch time.  The serving executors (:mod:`.executor`) hand
    these between their dispatch and resolve threads so host-side padding of
    batch k+1 overlaps device execution of batch k."""

    __slots__ = ("routine", "B", "a0", "b", "squeeze", "opts", "out",
                 "want_verdict", "n_real")

    def __init__(self, routine, B, a0, b, squeeze, opts, out, want_verdict,
                 n_real=None):
        self.routine, self.B = routine, B
        self.a0, self.b, self.squeeze = a0, b, squeeze
        self.opts, self.out, self.want_verdict = opts, out, want_verdict
        self.n_real = n_real


def start_batched(routine: str, A, B, opts=None, cache=None,
                  donate: bool = False, n_real: Optional[int] = None,
                  device=None) -> PendingBatch:
    """Dispatch half of a batched solve: validate, inject, and launch the
    batch on the current stream — NO host sync.  Returns a
    :class:`PendingBatch` for :func:`finish_batched`; until then the device
    computes in the background, which is the overlap the executor pool's
    split data path is built on.  The cache lookup happens here, on the
    calling thread (``cache.last_lookup()`` is thread-local — probe it
    before handing off).  A miss prepares the entry first (one synchronous
    warm run on a CUDA device, like the JAX package's compile on a miss).

    ``n_real`` is the ghost-slot boundary (continuous batching's slotted
    variants): elements ``[n_real:]`` are identity-system fill padding the
    batch up to its prepared slot capacity.  The verdict/escalation half
    ignores them entirely — they are never health-checked, never ladder
    re-run, never debit the escalation budget, and get no SolveReport —
    so a poisoned or overflowed ghost can never masquerade as (or bill
    like) real traffic.  ``None`` means every element is real.  ``device``
    places numpy operands (default ``cuda``); tensors keep theirs."""
    opts = Options.make(opts)
    a0, b, squeeze = _as_batch(A, B, routine, device)
    a = _inject_each(routine, a0)
    want_verdict = (opts.use_fallback_solver or opts.solve_report
                    or active() is not None)
    # donation lets the program reuse the operand buffers, and the verdict/
    # escalation path re-reads them (a0[i] on re-run) — so donation is only
    # honored on the zero-sync fast path where nothing is read back
    out = _run_batched(routine, a, b, opts, cache,
                       donate and not want_verdict)
    return PendingBatch(routine, B, a0, b, squeeze, opts, out, want_verdict,
                        n_real=n_real)


def finish_batched(pb: PendingBatch):
    """Resolve half: read the verdict back (one host sync), run
    element-granular escalation, finalize reports — returns ``(payload
    list, info, reports)`` for the one-shot drivers to unpack.  Runs on
    whichever thread calls it, on that thread's current stream (the
    executors' resolver thread uses its executor's stream); the escalation
    side channel (:func:`last_escalations`) and the escalation gate
    (:func:`set_escalation_gate`) are THIS thread's."""
    _tl.escalations = {}                 # fresh side channel for this call
    routine, opts = pb.routine, pb.opts
    a0, b, B = pb.a0, pb.b, pb.B
    batch = a0.shape[0]
    # ghost-slot boundary: only elements [:n_real] are health-checked,
    # escalated, budgeted, or reported — slot fill is inert by construction
    n_real = batch if pb.n_real is None else max(min(int(pb.n_real),
                                                     batch), 0)
    want_verdict = pb.want_verdict
    payload, info = list(pb.out[:-1]), pb.out[-1]

    reports = None
    if opts.solve_report:
        reports = [SolveReport(routine=routine,
                               precision_used=dtype_name(a0.dtype),
                               fallback_chain=("batched",))
                   for _ in range(n_real)]
    forced_bad: set = set()       # failed elements that never escalated —
    #                               their recovered verdict is False even
    #                               when info==0 (non-finite payload)
    if want_verdict:
        # the batch's single host sync: per-element info + finiteness,
        # ghost slots excluded from the verdict mask
        x0 = payload[0][:n_real]
        bad = ((info[:n_real] != 0)
               | ~torch.isfinite(x0).flatten(1).all(dim=1)).cpu().numpy()
        failed = [int(i) for i in bad.nonzero()[0]]
        if failed and opts.use_fallback_solver:
            gate = getattr(_tl, "esc_gate", None)
            allowed = len(failed) if gate is None else \
                max(min(int(gate(len(failed))), len(failed)), 0)
            run, capped = failed[:allowed], failed[allowed:]
            if run:
                slots = [[p] for p in payload]
                slots, info = _escalate(routine, ELEM_CORES[routine], a0, b,
                                        run, opts, slots, info, reports)
                payload = [s[0] for s in slots]
            for i in capped:
                # budget refused the re-run: keep the rung-1 payload, mark
                # the element so the serving queue resolves it with its
                # typed error (recovered=False) instead of a silent retry
                forced_bad.add(i)
                _tl.escalations[i] = {"rungs": ("batched",),
                                      "recovered": False, "capped": True}
                count_event("slate_serve_escalations_capped_total",
                            routine=routine)
        elif failed:
            forced_bad.update(failed)
    if reports is not None:
        final = info.cpu().numpy()
        for i, r in enumerate(reports):
            r.info = int(final[i])
            if len(r.fallback_chain) == 1:      # never escalated
                r.recovered = r.info == 0 and i not in forced_bad
            r.finalize()
    x = payload[0][..., 0] if pb.squeeze else payload[0]
    if isinstance(B, BaseMatrix) and x.shape == B.array.shape:
        write_back(B, x)
    payload[0] = x
    return payload, info, reports


def _solve_batched(routine: str, A, B, opts, cache, donate, n_real=None,
                   device=None):
    """Shared driver body; returns (payload list, info, reports).  The
    one-shot composition of the dispatch/resolve halves the executor pool
    runs on separate threads."""
    return finish_batched(start_batched(routine, A, B, opts=opts,
                                        cache=cache, donate=donate,
                                        n_real=n_real, device=device))


@instrument
def gesv_batched(A, B, opts=None, cache=None, donate=False, n_real=None,
                 device=None):
    """Batched ``gesv``: solve ``A[i] X[i] = B[i]`` for a (batch, n, n) stack.

    Returns ``(X, perm, info)`` with ``perm`` (batch, n) int64 and ``info``
    (batch,) int32 per-request codes; with ``Options(solve_report=True)``,
    ``(X, perm, info, reports)`` where ``reports`` is one
    :class:`SolveReport` per element.  See the module docstring for the
    escalation, device and fault-injection semantics.  ``n_real`` marks the
    ghost-slot boundary: elements past it are slot fill and stay outside
    the verdict/escalation/report path (see :func:`start_batched`)."""
    payload, info, reports = _solve_batched("gesv_batched", A, B, opts,
                                            cache, donate, n_real=n_real,
                                            device=device)
    x, perm = payload
    return (x, perm, info) if reports is None else (x, perm, info, reports)


@instrument
def posv_batched(A, B, opts=None, cache=None, donate=False, n_real=None,
                 device=None):
    """Batched SPD solve: ``A[i] X[i] = B[i]`` with each A[i] the *full*
    Hermitian matrix.  Returns ``(X, info)``; with
    ``Options(solve_report=True)``, ``(X, info, reports)``.  ``n_real``
    marks the ghost-slot boundary (see :func:`start_batched`)."""
    payload, info, reports = _solve_batched("posv_batched", A, B, opts,
                                            cache, donate, n_real=n_real,
                                            device=device)
    return (payload[0], info) if reports is None else \
        (payload[0], info, reports)


@instrument
def gels_batched(A, B, opts=None, cache=None, donate=False, n_real=None,
                 device=None):
    """Batched least squares: min ‖A[i] X[i] − B[i]‖ over a (batch, m, n)
    stack (tall/square = CSNE; wide = LQ min-norm — the shape class is
    static per bucket; failed elements escalate to the full ``gels``).
    Returns ``(X, info)`` with X (batch, n, nrhs); with
    ``Options(solve_report=True)``, ``(X, info, reports)``.  ``n_real``
    marks the ghost-slot boundary (see :func:`start_batched`)."""
    payload, info, reports = _solve_batched("gels_batched", A, B, opts,
                                            cache, donate, n_real=n_real,
                                            device=device)
    return (payload[0], info) if reports is None else \
        (payload[0], info, reports)
