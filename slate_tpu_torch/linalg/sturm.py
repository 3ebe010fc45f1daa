"""Sturm-count bisection and inverse iteration for symmetric tridiagonal
eigenproblems.

Reference analogue: ``src/sterf.cc`` and the bisection stage of LAPACK's
``stebz``; ``stein`` (inverse iteration) completes MethodEig::Bisection, which
the reference declares "not yet implemented" (enums.hh:363).

The JAX package runs the Sturm count as one ``lax.scan`` over the n rows with
every shift in the lanes; bisection repeats it ``nmant + 4`` times.  Here the
row recurrence is a Python loop whose step updates all shifts at once, written
into one (n, k) buffer so the count is a single reduction at the end.  A row
is one launch (the divide-subtract); the stebz pivmin guard (3 more) runs only
in a pass where it would fire: the unguarded pass is checked for a pivot
below pivmin (one host sync) and redone with the guard if it holds one, so
the counts are the guarded recurrence's exactly.  A full ``sterf_bisect``
costs about ``n (nmant + 4)`` launches (27 sweeps in f32, 56 in f64) and two
syncs per sweep.  The algorithm and its absolute accuracy envelope,
O(eps·||T||), are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.matrix import as_array

# mantissa bits, the field jnp.finfo(dt).nmant gives (torch.finfo has none)
NMANT = {torch.float32: 23, torch.float64: 52}
# shifts per Sturm pass are chunked so the (n, k) pivot buffer stays under
# this many elements (1 GiB of f32)
_STURM_BUFFER = 1 << 28


def _sturm_counts(d: torch.Tensor, e2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Number of eigenvalues of T(d, e) strictly below each shift in ``x``.

    LDL^T pivots ``q_i = (d_i - x) - e²_{i-1} / q_{i-1}``; the count is
    ``#{i : q_i < 0}`` (Sturm), with stebz's pivmin guard.  Returns int64
    counts on ``x``'s device.  One launch per row of T (4 when the guard has
    to run); two host syncs, pivmin's and the guard check's (per chunk of
    shifts)."""
    dt = d.dtype
    n = d.shape[0]
    tiny = torch.finfo(dt).tiny
    # a host float: a tensor fill value would cost masked_fill_ a sync per row
    pivmin = tiny * max(float(torch.max(e2)), 1.0) if n > 1 else tiny
    k = x.shape[0]
    chunk = max(1, min(k, _STURM_BUFFER // max(n, 1)))
    counts = []
    e2s = e2.unbind(0)

    def recurrence(xs, guard: bool):
        Q = d[:, None] - xs[None, :]          # row i starts as d_i - x
        rows = Q.unbind(0)                    # row views made once, not per step
        for i, row in enumerate(rows):
            if i:
                row.addcdiv_(e2s[i - 1], rows[i - 1], value=-1)
            if guard:
                row.masked_fill_(row.abs() < pivmin, -pivmin)
        return Q

    for c0 in range(0, k, chunk):
        xs = x[c0:c0 + chunk]
        Q = recurrence(xs, guard=False)
        # without a pivot below pivmin the guard never fires, and the
        # unguarded pass is the guarded one bit for bit
        if bool(torch.any(Q.abs() < pivmin)):
            Q = recurrence(xs, guard=True)
        counts.append((Q < 0).sum(dim=0))
    return torch.cat(counts) if len(counts) > 1 else counts[0]


def _prescale(d, e):
    """Scale (d, e) by s so e*e cannot overflow/underflow (shared by the
    bisection entry points)."""
    dt = d.dtype
    emax = torch.max(e.abs()) if e.numel() else torch.zeros((), dtype=dt, device=d.device)
    s = torch.clamp(torch.maximum(torch.max(d.abs()), emax), min=torch.finfo(dt).tiny)
    e2 = (e / s) * (e / s) if e.numel() else torch.zeros((0,), dtype=dt, device=d.device)
    return d / s, e / s, e2, s


def sterf_bisect(d, e, iters: Optional[int] = None, il: int = 0,
                 iu: Optional[int] = None) -> torch.Tensor:
    """Eigenvalues (ascending) with INDICES [il, iu) of the symmetric
    tridiagonal T(d, e) by index-targeted bisection — every targeted bracket
    halves in the same Sturm pass (LAPACK stebz range='I').

    ``iters`` defaults to ``nmant + 4`` sweeps; each costs about n launches
    (one :func:`_sturm_counts` pass) plus 5 for the bracket update, and two
    host syncs."""
    d = as_array(d)
    e = as_array(e, device=d.device)
    dt = d.dtype
    n = d.shape[0]
    if n == 0:
        return d
    if iu is None:
        iu = n
    if not (0 <= il < iu <= n):
        raise ValueError(f"index range [{il}, {iu}) invalid for n={n}")
    if n == 1:
        return d[il:iu]
    if iters is None:
        # enough sweeps to shrink the Gershgorin span to ~4 ulp of ||T||
        iters = NMANT[dt] + 4
    d, e, e2, s = _prescale(d, e)
    zero = torch.zeros((1,), dtype=dt, device=d.device)
    r = torch.cat([e, zero]).abs() + torch.cat([zero, e]).abs()
    lo0 = torch.min(d - r)
    hi0 = torch.max(d + r)
    span = hi0 - lo0
    k = torch.arange(il, iu, device=d.device)
    lo = lo0.expand(iu - il).clone()
    hi = (hi0 + torch.finfo(dt).eps * span).expand(iu - il).clone()
    for _ in range(int(iters)):
        mid = 0.5 * (lo + hi)
        below = _sturm_counts(d, e2, mid) >= k + 1      # lambda_k < mid
        lo = torch.where(below, lo, mid)
        hi = torch.where(below, mid, hi)
    return 0.5 * (lo + hi) * s


def sturm_count_interval(d, e, vl, vu) -> torch.Tensor:
    """Number of eigenvalues of T(d, e) in the half-open interval [vl, vu):
    one Sturm pass over both endpoints (LAPACK stebz range='V' counting).
    Endpoints that coincide with an eigenvalue to rounding are eps-sensitive:
    pick them in gaps.  Returns an int32 scalar tensor."""
    d = as_array(d)
    e = as_array(e, device=d.device)
    dt = d.dtype
    ds, _, e2, s = _prescale(d, e)
    x = torch.stack([torch.as_tensor(vl, dtype=dt, device=d.device),
                     torch.as_tensor(vu, dtype=dt, device=d.device)]) / s
    cnt = _sturm_counts(ds, e2, x)
    # inverted intervals count zero (not negative) — matches the dense path
    return torch.clamp(cnt[1] - cnt[0], min=0).to(torch.int32)


def _gtsv(dl: torch.Tensor, D: torch.Tensor, du: torch.Tensor,
          B: torch.Tensor) -> torch.Tensor:
    """Solve k tridiagonal systems at once, one per column: column j's matrix
    has sub-diagonal ``dl``, diagonal ``D[:, j]`` and super-diagonal ``du``;
    its right-hand side is ``B[:, j]``.  Gaussian elimination with partial
    pivoting, LAPACK gtsv's algorithm (what ``lax.linalg.tridiagonal_solve``
    calls on the CPU), with each column's row interchange chosen by
    ``torch.where``.  A zero pivot leaves inf/NaN in that column, which the
    caller tests.  The rows live in Python lists of (k,) tensors, so a step
    is its arithmetic alone: about 22 launches per row forward, 6 back."""
    n = D.shape[0]
    D, B = list(D.unbind(0)), list(B.unbind(0))
    DU = list(du.unbind(0))       # 0-dim until a row interchange makes it (k,)
    DL = list(dl.unbind(0))
    absDL = list(dl.abs().unbind(0))
    DU2 = [None] * max(n - 2, 0)
    zero = torch.zeros((), dtype=B[0].dtype, device=B[0].device)
    for i in range(n - 1):
        di, dli, dui, dn = D[i], DL[i], DU[i], D[i + 1]
        swap = di.abs() < absDL[i]
        fact = torch.where(swap, di / dli, dli / di)
        D[i] = torch.where(swap, dli, di)
        D[i + 1] = torch.where(swap, dui - fact * dn, dn - fact * dui)
        DU[i] = torch.where(swap, dn, dui)
        if i < n - 2:
            dun = DU[i + 1]
            DU2[i] = torch.where(swap, dun, zero)
            DU[i + 1] = torch.where(swap, -fact * dun, dun)
        bi, bn = B[i], B[i + 1]
        B[i] = torch.where(swap, bn, bi)
        B[i + 1] = torch.where(swap, bi - fact * bn, bn - fact * bi)
    B[n - 1] = B[n - 1] / D[n - 1]
    if n > 1:
        B[n - 2] = (B[n - 2] - DU[n - 2] * B[n - 1]) / D[n - 2]
    for i in range(n - 3, -1, -1):
        B[i] = (B[i] - DU[i] * B[i + 1] - DU2[i] * B[i + 2]) / D[i]
    return torch.stack(B)


def stein(d, e, lam, iters: int = 3) -> torch.Tensor:
    """Eigenvectors of the symmetric tridiagonal T(d, e) for precomputed
    eigenvalues ``lam`` by batched inverse iteration (LAPACK ``stein``).

    Every shifted system solves at once (:func:`_gtsv`, all k columns per
    row step); each sweep normalizes, re-perturbs a column whose solve hit an
    exact zero pivot, and re-orthogonalizes the whole block by one QR (inverse
    subspace iteration, so clusters keep an orthonormal span).

    Returns V (n, k) with columns ordered like ``lam``; T V ≈ V diag(lam) and
    VᵀV ≈ I to O(n·eps·‖T‖).  Launches: about 25n per sweep (the solve and
    its back substitution) plus the QR; no host sync."""
    d = as_array(d)
    e = as_array(e, device=d.device)
    lam = as_array(lam, device=d.device)
    dt = d.dtype
    n = d.shape[0]
    k = lam.shape[0]
    if n == 1:
        return torch.ones((1, k), dtype=dt, device=d.device)
    anorm = torch.clamp(torch.max(d.abs()) + 2 * torch.max(e.abs()),
                        min=torch.finfo(dt).tiny)
    # LAPACK-style perturbation: keep T - λI invertible without moving the
    # shift past the eigenvalue's own ulp neighbourhood
    sep = torch.finfo(dt).eps * anorm
    ii = torch.arange(n, dtype=dt, device=d.device)[:, None]
    jj = torch.arange(k, dtype=dt, device=d.device)[None, :]
    # deterministic start: uniform + an index-dependent perturbation so no
    # start vector is orthogonal to its target eigenvector by symmetry
    V = torch.ones((n, k), dtype=dt, device=d.device) + 1e-3 * torch.sin(ii * (jj + 1.0))
    fails = torch.zeros((k,), dtype=dt, device=d.device)
    fill = 1.0 / math.sqrt(n)
    for _ in range(iters):
        # a column whose solve hit an exact zero pivot re-solves with a GROWN
        # perturbation next sweep (LAPACK stein re-perturbs every failure)
        shift = lam + sep * (1.0 + fails)
        V = _gtsv(e, d[:, None] - shift[None, :], e, V)
        nrm = torch.linalg.vector_norm(V, dim=0, keepdim=True)
        V = V / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        bad = ~torch.isfinite(V).all(dim=0, keepdim=True)
        fails = fails + bad[0].to(dt)
        V = torch.where(bad, torch.full_like(V, fill), V)
        Q, R = torch.linalg.qr(V)
        sgn = torch.sign(torch.diagonal(R))
        V = Q * torch.where(sgn == 0, torch.ones_like(sgn), sgn)[None, :]
    return V
