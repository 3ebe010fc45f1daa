"""Condition number estimation: norm1est power iteration + gecondest / pocondest /
trcondest.

Reference analogue: ``src/norm1est.cc`` (the Hager/Higham power iteration used by
LAPACK's xLACON), ``src/gecondest.cc``, ``src/pocondest.cc``, ``src/trcondest.cc``.

The estimator needs only solve callbacks (A^{-1} x and A^{-H} x from an existing
factorization) and elementwise sign/argmax steps, unrolled to the standard 5
iterations as in the JAX package.  Everything stays on the factor's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.exceptions import SlateError
from ..core.matrix import as_array, resolve_device
from ..core.types import Norm, Uplo
from ..ops import norms as norm_ops
from .lu import _as_perm, lu_factored_solve


def norm1est(solve: Callable, solve_h: Callable, n: int, dtype,
             max_iter: int = 5, device=None) -> torch.Tensor:
    """Estimate ||M||_1 where M is only available through matvec callbacks
    (src/norm1est.cc; Hager-Higham with the classic parity-vector refinement).

    `solve(x)` computes M x, `solve_h(x)` computes M^H x, both on (n,) vectors
    on ``device`` (``cuda`` unless the caller names one; raises without CUDA).
    """
    device = resolve_device(device)
    x = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    est = torch.zeros((), dtype=x.real.dtype, device=device)
    for _ in range(max_iter):
        y = solve(x)
        ay = y.abs()
        est = torch.sum(ay)
        safe = torch.where(ay == 0, torch.ones_like(ay), ay)
        s = torch.where(ay == 0, torch.ones_like(y), y / safe)
        z = solve_h(s.to(dtype))
        j = torch.argmax(z.abs())
        x = torch.zeros((n,), dtype=dtype, device=device)
        x[j] = 1.0
    # refinement with the alternating-parity vector (xLACON's final safeguard)
    i = torch.arange(n, dtype=x.real.dtype, device=device)
    sign = 1.0 - 2.0 * torch.remainder(i, 2.0)
    v = sign * (1.0 + i / max(n - 1, 1))
    alt = torch.sum(solve(v.to(dtype)).abs()) * 2.0 / (3.0 * n)
    return torch.maximum(est, alt)


def _rcond(anorm, inv_norm: torch.Tensor) -> torch.Tensor:
    rcond = 1.0 / (torch.as_tensor(anorm, dtype=inv_norm.dtype,
                                   device=inv_norm.device) * inv_norm)
    return torch.where(torch.isfinite(rcond), rcond, torch.zeros_like(rcond))


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


def gecondest(LU, perm, anorm, opts=None, norm_kind=Norm.One):
    """Reciprocal condition estimate from a packed LU factorization
    (src/gecondest.cc): rcond = 1 / (||A|| * est(||A^{-1}||)) in the 1- or inf-norm.

    ``perm`` is the row permutation of the factorization (P A = L U as
    ``A[perm] = L U``), or None.  A^{-1} x goes through getrs's own solve
    (:func:`.lu.lu_factored_solve`).  The inf-norm estimate uses
    ||A^{-1}||_inf == ||A^{-H}||_1 — pass anorm measured in the matching norm."""
    lu_ = as_array(LU)
    n = lu_.shape[-1]
    norm_kind = Norm.from_string(norm_kind)
    if norm_kind not in (Norm.One, Norm.Inf):
        raise SlateError("gecondest supports One or Inf norms")
    p = None if perm is None else _as_perm(perm, lu_.device)

    def solve(x):
        return lu_factored_solve(lu_, p, _col(x))[:, 0]

    def solve_h(x):
        y = torch.linalg.solve_triangular(lu_.mH, _col(x), upper=False)
        z = torch.linalg.solve_triangular(lu_.mH, y, upper=True,
                                          unitriangular=True)[:, 0]
        if p is not None:
            z = torch.zeros_like(z).index_copy_(0, p, z)
        return z

    if norm_kind == Norm.Inf:
        inv_norm = norm1est(solve_h, solve, n, lu_.dtype, device=lu_.device)
    else:
        inv_norm = norm1est(solve, solve_h, n, lu_.dtype, device=lu_.device)
    return _rcond(anorm, inv_norm)


def pocondest(L, anorm, opts=None, uplo=None):
    """Reciprocal condition estimate from a Cholesky factor (src/pocondest.cc)."""
    f = as_array(L)
    the_uplo = Uplo.from_string(uplo) if uplo else Uplo.Lower
    Lf = torch.tril(f) if the_uplo == Uplo.Lower else torch.triu(f).mH
    n = f.shape[-1]

    def solve(x):
        y = torch.linalg.solve_triangular(Lf, _col(x), upper=False)
        return torch.linalg.solve_triangular(Lf.mH, y, upper=True)[:, 0]

    return _rcond(anorm, norm1est(solve, solve, n, f.dtype, device=f.device))


def trcondest(T, opts=None, uplo=None, diag=None, norm_kind=Norm.One):
    """Triangular condition estimate (src/trcondest.cc); the norm of T goes
    through ``trnorm`` (the masked CUDA reduction on the card)."""
    from ..blas import _diag_of
    t = as_array(T)
    the_uplo = Uplo.from_string(uplo) if uplo else getattr(T, "uplo", Uplo.Lower)
    if the_uplo == Uplo.General:
        the_uplo = Uplo.Lower
    the_diag = _diag_of(T, diag)
    n = t.shape[-1]
    upper = the_uplo == Uplo.Upper
    unit = the_diag.value == "unit"
    anorm = norm_ops.trnorm(norm_kind, the_uplo, the_diag, t)

    def solve(x):
        return torch.linalg.solve_triangular(t, _col(x), upper=upper,
                                             unitriangular=unit)[:, 0]

    def solve_h(x):
        return torch.linalg.solve_triangular(t.mH, _col(x), upper=not upper,
                                             unitriangular=unit)[:, 0]

    # inf-norm: ||T^{-1}||_inf == ||T^{-H}||_1 — same estimator, solves swapped
    if Norm.from_string(norm_kind) == Norm.Inf:
        inv_norm = norm1est(solve_h, solve, n, t.dtype, device=t.device)
    else:
        inv_norm = norm1est(solve, solve_h, n, t.dtype, device=t.device)
    return _rcond(anorm, inv_norm)
