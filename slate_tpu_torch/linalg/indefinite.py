"""Hermitian/symmetric-indefinite solvers: hetrf / hetrs / hesv (+ sy* aliases).

Reference analogue: ``src/{hetrf,hetrs,hesv}.cc`` — a communication-avoiding
blocked Aasen factorization P A P^H = L T L^H with L unit lower triangular
(first block column the identity) and T a Hermitian band of bandwidth nb,
solved with the band LU (:func:`~slate_tpu_torch.linalg.band.gbsv`'s
factorization).

As in the JAX package, each panel is a few large gemms (the Aasen H-column,
the panel residual), the panel's pivots come from a library LU of the tall
residual, and the permutation is applied two-sidedly to the trailing matrix
and to the computed rows of L.  Ragged n is padded to whole blocks with an
identity diagonal.  The n/nb panels run as a Python loop of library calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.matrix import as_array, dist_operand, distribution_grid, write_back
from ..core.types import Options
from ..robust import SolveReport, inject
from ..utils.trace import trace_block
from .band import BandLU, gbtrf, gbtrs
from .eig import _full_herm, _grid_herm
from .lu import _device_perm, _lu_factor

__all__ = ["HermitianFactors", "hetrf", "hetrs", "hesv", "sytrf", "sytrs", "sysv"]


class HermitianFactors(NamedTuple):
    """Aasen factored form P A P^H = L T L^H (the reference's hetrf output
    bundle).  T is kept both dense-stored (for reconstruction) and band-LU
    factored, so repeated hetrs calls do not refactor."""
    L: torch.Tensor         # (n, n) unit lower triangular, first block column = I
    T: torch.Tensor         # (n, n) dense-stored Hermitian band, bandwidth nb
    T_fac: BandLU           # band LU of T (kl = ku = nb)
    perm: torch.Tensor      # (n,) row permutation: (P A P^H) = A[perm][:, perm]
    inv_perm: torch.Tensor  # (n,) inverse of perm
    nb: int


def _unit_lower_solve(L, b, left=True, conj_t=False):
    """Solve with the unit lower triangle of L (or its conjugate transpose,
    on the left or the right)."""
    M = L.mH if conj_t else L
    return torch.linalg.solve_triangular(M, b, upper=conj_t, left=left,
                                         unitriangular=True)


def _hetrf(a, nb: int):
    """Blocked Aasen over N = ceil(n/nb) panels (the JAX package unrolls the
    same loop at trace time)."""
    n = a.shape[-1]
    N = -(-n // nb)
    np_ = N * nb
    dt, dev = a.dtype, a.device
    ap = torch.zeros((np_, np_), dtype=dt, device=dev)
    ap[:n, :n] = a
    if np_ > n:   # blockdiag(A, I) keeps the factorization exact
        idx = torch.arange(n, np_, device=dev)
        ap[idx, idx] = 1.0
    a = ap
    L = torch.eye(np_, dtype=dt, device=dev)
    T = torch.zeros((np_, np_), dtype=dt, device=dev)
    perm = torch.arange(np_, device=dev)
    for j in range(N):
        j0, j1 = j * nb, (j + 1) * nb
        # H[:, j] for block rows 0..j-1: T is banded, so one gemm
        Hcol = (torch.matmul(T[:j0, :j1 + nb], L[j0:j1, :j1 + nb].mH) if j > 0
                else torch.zeros((0, nb), dtype=dt, device=dev))
        # A[j][j] = sum_{k<j} L[j][k] H[k][j] + L[j][j] H[j][j]
        LjjHjj = a[j0:j1, j0:j1] - torch.matmul(L[j0:j1, :j0], Hcol)
        Ljj = L[j0:j1, j0:j1]
        Hjj = _unit_lower_solve(Ljj, LjjHjj)
        # H[j][j] = T[j][j-1] L[j][j-1]^H + T[j][j] L[j][j]^H
        rhs = Hjj
        if j > 0:
            rhs = rhs - torch.matmul(T[j0:j1, j0 - nb:j0], L[j0:j1, j0 - nb:j0].mH)
        Tjj = _unit_lower_solve(Ljj, rhs, left=False, conj_t=True)
        T[j0:j1, j0:j1] = (Tjj + Tjj.mH) / 2     # Hermitian up to roundoff
        if j < N - 1:
            # panel residual W = L[j+1:, j+1] T[j+1][j] L[j][j]^H
            W = a[j1:, j0:j1]
            if j > 0:
                W = W - torch.matmul(L[j1:, :j0], Hcol)
            W = W - torch.matmul(L[j1:, j0:j1], Hjj)
            plu, piv = _lu_factor(W)
            pperm = _device_perm(plu, piv)
            L_panel = torch.tril(plu, -1)[:, :nb] + torch.eye(plu.shape[0], nb, dtype=dt,
                                                              device=dev)
            Up = torch.triu(plu[:nb, :nb])
            # T[j+1][j] = U_p (L[j][j]^H)^{-1}  (stays upper triangular)
            Tj1j = _unit_lower_solve(L[j0:j1, j0:j1], Up, left=False, conj_t=True)
            T[j1:j1 + nb, j0:j1] = Tj1j
            T[j0:j1, j1:j1 + nb] = Tj1j.mH
            # two-sided permutation of the trailing matrix, the L rows, perm
            gperm = torch.cat([torch.arange(j1, device=dev), j1 + pperm])
            a = a[gperm][:, gperm]
            L[j1:, nb:j1] = L[j1:, nb:j1][pperm]
            perm = perm[gperm]
            L[j1:, j1:j1 + nb] = L_panel
    return L[:n, :n], T[:n, :n], perm[:n]


def hetrf(A, opts=None, uplo=None):
    """Aasen factorization P A P^H = L T L^H with band T (src/hetrf.cc).
    Returns (HermitianFactors, info)."""
    opts = Options.make(opts)
    a = inject("hetrf", _full_herm(A, uplo))
    n = a.shape[-1]
    nb = min(opts.block_size, n)
    with trace_block("hetrf", n=n, nb=nb):
        L, T, perm = _hetrf(a, nb)
        # the band LU of T: its zero-pivot detection is the singularity
        # signal of the whole factorization
        T_fac, info = gbtrf(T, opts.replace(block_size=nb), kl=nb, ku=nb)
    return HermitianFactors(L=L, T=T, T_fac=T_fac, perm=perm,
                            inv_perm=torch.argsort(perm), nb=nb), info


def hetrs(fac: HermitianFactors, B, opts=None):
    """Solve with the Aasen factorization (src/hetrs.cc): forward L sweep, the
    band solve with T, backward L^H sweep, un-permute."""
    b = as_array(B, device=fac.L.device)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    y = _unit_lower_solve(fac.L, b[fac.perm])
    z = gbtrs(fac.T_fac, y, opts)
    x = _unit_lower_solve(fac.L, z, conj_t=True)[fac.inv_perm]
    if squeeze:
        x = x[:, 0]
    return write_back(B, x)


def hesv(A, B, opts=None, uplo=None):
    """Solve a Hermitian-indefinite system (src/hesv.cc): hetrf + hetrs.
    Returns (X, info); with ``Options(solve_report=True)``,
    (X, info, SolveReport), on both the single-device and the grid paths.
    A grid-bound operand runs the distributed CA-Aasen
    (:func:`..parallel.hesv_distributed`) on the full Hermitian matrix,
    assembled shard by shard."""
    opts_ = Options.make(opts)
    grid = distribution_grid(A, B)
    if grid is not None:
        from ..parallel import hesv_distributed

        a = _grid_herm(A, uplo, grid)
        b = dist_operand(B)
        x, info = hesv_distributed(a, b, grid, nb=min(opts_.block_size, a.shape[-1]))
        x = write_back(B, x)
    else:
        fac, info = hetrf(A, opts, uplo)
        x = hetrs(fac, B, opts)
    if opts_.solve_report:
        report = SolveReport(routine="hesv", info=int(info),
                             precision_used=str(as_array(x).dtype).removeprefix("torch."),
                             fallback_chain=("aasen",)).finalize()
        report.recovered = report.info == 0
        return x, info, report
    return x, info


# real-symmetric aliases (the reference's sy* names alias he* for real scalars)
sytrf = hetrf
sytrs = hetrs
sysv = hesv
