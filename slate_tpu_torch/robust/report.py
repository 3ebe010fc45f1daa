"""Structured health propagation: SolveReport + the shared info combiner.

Reference analogue: every SLATE driver carries an ``int64_t info`` reduced
across ranks by ``internal::reduce_info`` (src/internal/internal_reduce_info.cc)
— MPI_MAX over per-rank codes, first-failure-wins.  This module is the single
vocabulary:

* :func:`first_bad_index` — the LAPACK-info kernel every factorization shares:
  1-based index of the first failing pivot, 0 on success (no host sync).
* :func:`reduce_info` — combine stage infos, first nonzero wins.
* :class:`SolveReport` — the opt-in structured result
  (``Options.solve_report=True``) describing what a solve actually did.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def first_bad_index_batched(bad) -> torch.Tensor:
    """Per-element LAPACK info for a batched failure mask.

    ``bad`` is ``(..., n)``; returns ``(...)`` int32 with each element's 1-based
    first-True index (0 when clean), computed on ``bad``'s device without a
    host sync — one batched factorization yields one info code per request."""
    bad = torch.as_tensor(bad, dtype=torch.bool)
    if bad.shape[-1] == 0:
        return torch.zeros(bad.shape[:-1], dtype=torch.int32, device=bad.device)
    first = torch.argmax(bad.to(torch.int32), dim=-1).to(torch.int32) + 1
    return torch.where(bad.any(dim=-1), first, torch.zeros_like(first))


def first_bad_index(bad) -> torch.Tensor:
    """LAPACK-style info from a boolean failure mask (1-based first True, else 0).

    The shared kernel behind the factorizations' zero/NaN/non-positive pivot
    checks (reference reduce_info semantics).  The mask is flattened, as the
    JAX package's ``jnp.argmax`` does."""
    return first_bad_index_batched(torch.as_tensor(bad, dtype=torch.bool).reshape(-1))


def reduce_info(*infos) -> torch.Tensor:
    """Combine per-stage info codes; the first nonzero (in argument order) wins.

    0 when all stages succeeded — ``internal::reduce_info`` with the rank
    dimension replaced by the stage dimension.  Accepts python ints and
    tensors; the result lies on the first tensor's device."""
    device = next((i.device for i in infos if isinstance(i, torch.Tensor)), None)
    out = torch.zeros((), dtype=torch.int32, device=device)
    for i in infos:
        i32 = torch.as_tensor(i, device=device).to(torch.int32)
        out = torch.where(out != 0, out, i32)
    return out


@dataclasses.dataclass
class SolveReport:
    """Structured record of what a solve actually did.

    Opt-in via ``Options(solve_report=True)``; drivers append the report to
    their normal return tuple.

    routine:         driver name ("posv", ...).
    info:            final LAPACK-style info code (host int).
    residual:        final residual estimate when the driver computed one.
    precision_used:  dtype the *returned* result was computed in.
    iters:           refinement/restart iterations taken.
    retries:         host-level same-rung retries.
    fallback_chain:  escalation rungs attempted, in order ("mixed", "full").
    recovered:       True when the returned result came from a rung that
                     converged/succeeded; False when every rung failed and
                     the driver surfaced the best effort + nonzero info.
    faults:          (driver, kind, call_index) triples injected during the
                     solve (empty outside chaos tests).
    """

    routine: str
    info: int = 0
    residual: Optional[float] = None
    precision_used: str = ""
    iters: int = 0
    retries: int = 0
    fallback_chain: Tuple[str, ...] = ()
    recovered: bool = True
    faults: Tuple[Tuple[str, str, int], ...] = ()

    def record_rung(self, name: str) -> None:
        self.fallback_chain = self.fallback_chain + (name,)

    def finalize(self) -> "SolveReport":
        """Attach the faults that fired on the active plan (if any) — called
        by drivers just before returning the report."""
        from . import faults as _faults

        plan = _faults.active()
        if plan is not None:
            self.faults = plan.fired
        return self
