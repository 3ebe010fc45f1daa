"""Distributed matrix inversion and condition estimation over the grid.

Reference analogues: ``src/trtri.cc``, ``src/trtrm.cc`` (L^H·L, the second
half of potri), ``src/potri.cc`` (trtri + trtrm), ``src/getri.cc:242`` (LU
inverse: a solve against the identity), and ``src/{ge,po,tr}condest.cc``.

Each is a composition of the distributed verbs the grid already runs — the
triangular solves, the SUMMA gemm and getrs — as the reference's potri.cc
just calls its trtri + trtrm work routines.
"""

from __future__ import annotations

import torch

from ..obs import instrument
from .distribute import gather, global_index, local_block, wrap
from .mesh import ProcessGrid
from .qr_dist import _transpose
from .solvers import trsm_distributed
from .summa import gemm_padded


def _masked(T, grid, lower: bool, k: int = 0, unit_diagonal: bool = False):
    """tril(T, k) / triu(T, k) of a block-layout operand (optionally with a
    unit diagonal), as a block-layout DTensor; no data moves."""
    m, n = T.shape[-2:]
    t = local_block(T, grid)
    rows, cols = global_index(grid, m, n, device=t.device)
    keep = (rows - cols >= -k) if lower else (cols - rows >= k)
    out = torch.where(keep, t, torch.zeros((), dtype=t.dtype, device=t.device))
    if unit_diagonal:
        out = torch.where(rows == cols, torch.ones_like(out), out)
    return wrap(out, grid, (m, n))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.to_local().device
                     if hasattr(like, "to_local") else like.device)


@instrument
def trtri_distributed(T, grid: ProcessGrid, lower: bool = True,
                      unit_diagonal: bool = False):
    """Distributed triangular inverse (src/trtri.cc): one sharded triangular
    solve against the identity."""
    n = T.shape[-1]
    Tm = _masked(T, grid, lower, unit_diagonal=unit_diagonal)
    X = trsm_distributed(Tm, _eye(n, Tm), grid, lower=lower)
    return _masked(X, grid, lower)


@instrument
def trtrm_distributed(T, grid: ProcessGrid, lower: bool = True):
    """Distributed L^H L (or U U^H) producing the stored triangle — the second
    half of potri (src/trtrm.cc), as one SUMMA gemm."""
    Tm = _masked(T, grid, lower)
    out = (gemm_padded(_transpose(Tm, grid), Tm, grid) if lower
           else gemm_padded(Tm, _transpose(Tm, grid), grid))
    return _masked(out, grid, lower)


@instrument
def potri_distributed(L, grid: ProcessGrid, lower: bool = True):
    """Distributed SPD inverse from the Cholesky factor: A^{-1} = L^{-H} L^{-1}
    (src/potri.cc = trtri + trtrm)."""
    return trtrm_distributed(trtri_distributed(L, grid, lower=lower), grid,
                             lower=lower)


@instrument
def getri_distributed(LU, perm, grid: ProcessGrid):
    """Distributed inverse from the tournament-LU factor (src/getri.cc:242):
    solve A X = I through the sharded getrs sweeps."""
    from .lu_dist import getrs_distributed

    n = LU.shape[-1]
    return getrs_distributed(LU, perm, _eye(n, LU), grid)


def _norm_kind(norm_kind):
    from ..core.exceptions import SlateError
    from ..core.types import Norm

    kind = (Norm.One if norm_kind is None else norm_kind
            if isinstance(norm_kind, Norm) else Norm.from_string(norm_kind))
    if kind not in (Norm.One, Norm.Inf):
        raise SlateError("condition estimates support One or Inf norms")
    return kind


def _rcond(anorm, inv_norm):
    rcond = 1.0 / (torch.as_tensor(anorm, dtype=inv_norm.real.dtype,
                                   device=inv_norm.device) * inv_norm)
    # singular factor / zero norm -> rcond 0, like the single-device API
    return torch.where(torch.isfinite(rcond), rcond, torch.zeros_like(rcond))


@instrument
def gecondest_distributed(LU, perm, anorm, grid: ProcessGrid, norm_kind=None):
    """Distributed 1-norm condition estimate from the tournament-LU factor
    (src/gecondest.cc over the grid): the Hager/Higham iteration of
    ``linalg.condest.norm1est`` with both solve directions on the grid."""
    from ..core.types import Norm
    from ..linalg.condest import norm1est
    from .lu_dist import getrs_distributed

    kind = _norm_kind(norm_kind)
    n = LU.shape[-1]
    L = _masked(LU, grid, True, -1, unit_diagonal=True)
    U = _masked(LU, grid, False)
    p = torch.as_tensor(perm, dtype=torch.int64)

    def solve(x):                      # A^{-1} x
        return gather(getrs_distributed(LU, perm, x[:, None], grid))[:, 0]

    def solve_h(x):                    # A^{-H} x
        y = trsm_distributed(U, x[:, None], grid, lower=False, conj_trans=True)
        z = gather(trsm_distributed(L, y, grid, lower=True, conj_trans=True))
        out = torch.zeros_like(z)
        out[p.to(z.device)] = z
        return out[:, 0]

    dt = L.dtype
    inv = (norm1est(solve_h, solve, n, dt, device=grid.device) if kind == Norm.Inf
           else norm1est(solve, solve_h, n, dt, device=grid.device))
    return _rcond(anorm, inv)


@instrument
def pocondest_distributed(L, anorm, grid: ProcessGrid):
    """Distributed SPD condition estimate from the Cholesky factor
    (src/pocondest.cc over the grid)."""
    from ..linalg.condest import norm1est

    Lf = _masked(L, grid, True)
    n = Lf.shape[-1]

    def solve(x):                      # A^{-1} x = L^{-H} L^{-1} x
        y = trsm_distributed(Lf, x[:, None], grid, lower=True)
        return gather(trsm_distributed(Lf, y, grid, lower=True,
                                       conj_trans=True))[:, 0]

    return _rcond(anorm, norm1est(solve, solve, n, Lf.dtype, device=grid.device))


@instrument
def trcondest_distributed(T, grid: ProcessGrid, lower: bool = True,
                          unit_diagonal: bool = False, norm_kind=None):
    """Distributed triangular condition estimate (src/trcondest.cc over the
    grid): anorm from the distributed triangle norm, the inverse norm from the
    Hager/Higham estimator on the grid's triangular solves.  The Inf-norm
    uses ||T^{-1}||_inf == ||T^{-H}||_1."""
    from ..core.types import Norm
    from ..linalg.condest import norm1est
    from .eig_dist import norm_distributed

    kind = _norm_kind(norm_kind)
    Tf = _masked(T, grid, lower, unit_diagonal=unit_diagonal)
    n = Tf.shape[-1]
    anorm = norm_distributed(kind, Tf, grid, uplo="lower" if lower else "upper")

    def solve(x):
        return gather(trsm_distributed(Tf, x[:, None], grid, lower=lower))[:, 0]

    def solve_h(x):
        return gather(trsm_distributed(Tf, x[:, None], grid, lower=lower,
                                       conj_trans=True))[:, 0]

    inv = (norm1est(solve_h, solve, n, Tf.dtype, device=grid.device) if kind == Norm.Inf
           else norm1est(solve, solve_h, n, Tf.dtype, device=grid.device))
    return _rcond(anorm, inv)
