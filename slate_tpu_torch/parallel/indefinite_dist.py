"""Distributed Hermitian-indefinite (Aasen) factorization over the grid.

Reference analogues: ``src/hetrf.cc`` (communication-avoiding Aasen over the
grid: panel LU on the Schur-complement column, band T assembly, two-sided
pivoting), ``src/hetrs.cc`` (L sweep + banded-T solve + Lᴴ sweep),
``src/hesv.cc``.

Design, after the JAX package's:

- **1-D block rows over the flattened grid** (the TSLU layout): every rank
  holds all columns of its rows, so Aasen's H-column gemm — the
  flops-dominant step — is a local (n/P × n)·(n × nb) gemm; per panel only
  the nb-row block extractions (masked sums), the H column's all-gather and
  the tournament's candidate gather touch the network.
- **Tournament panel pivoting** (:func:`.pivot.tournament_piv`, the CALU
  round), the pivots on the host as in every distributed LU of the port.
- **Two-sided dirty exchange**: the symmetric permutation moves <= 2nb rows
  (:func:`.pivot.exchange_rows`, one masked sum) and <= 2nb columns (local:
  columns are resident).
- **One loop over the panels**.

T comes back in compact band form (bandwidth nb) factored by the distributed
band LU, so ``hetrs_distributed`` rides ``band_dist.gbtrs_distributed`` and
the distributed unit-lower sweeps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.exceptions import slate_assert
from ..obs import instrument
from .band_dist import BandLUDist, gbtrf_distributed, gbtrs_distributed
from .collectives import axis_allgather, axis_allreduce, axis_index
from .distribute import ROWS, bounds, ceil_mult, gather, local_block, trim, wrap
from .mesh import FLAT, ProcessGrid
from .pivot import exchange_rows, extract_rows, step_permutation, tournament_piv

AX = FLAT


class HermitianFactorsDist(NamedTuple):
    """Distributed Aasen bundle P A Pᴴ = L T Lᴴ (hetrf.cc's output)."""
    L: object            # (n, n) unit lower triangular, row layout
    Tband: torch.Tensor  # T in the LAPACK gb layout (3nb+1, n), row j holding
                         # diagonal j - 2nb (dense_to_band_general(T, nb, nb,
                         # extra=nb)); the same on every rank
    T_fac: BandLUDist    # distributed band LU of T
    perm: np.ndarray     # (n,) on the host, the same on every rank
    nb: int


def _put(X_loc, r0: int, mr: int, rows: int, cols: int, block) -> None:
    """Write ``block`` at global (rows, cols) into the rows this rank owns."""
    lo, hi = max(rows, r0), min(rows + block.shape[0], r0 + mr)
    if hi > lo:
        X_loc[lo - r0:hi - r0, cols:cols + block.shape[1]] = block[lo - rows:hi - rows]


def _hetrf_local(A_loc, grid: ProcessGrid, npad: int, nb: int):
    """Aasen over this rank's block rows (mr, npad).  Returns (L rows, T rows,
    perm)."""
    P = grid.size
    mr = npad // P
    ri = axis_index(grid, AX)
    r0 = ri * mr
    dev, dt = A_loc.device, A_loc.dtype
    grow = torch.arange(r0, r0 + mr, device=dev)
    L_loc = (grow[:, None] == torch.arange(npad, device=dev)[None, :]).to(dt)
    T_loc = torch.zeros_like(A_loc)
    perm = np.arange(npad)
    eye = torch.eye(nb, dtype=dt, device=dev)

    def rows_of(X, start, c0=0, c1=npad):
        return extract_rows(X[:, c0:c1], np.arange(start, start + nb), ri, mr, grid, AX)

    for j0 in range(0, npad, nb):
        j1 = j0 + nb
        cmax = min(j1 + nb, npad)
        # H column: Hcol = T[:, :j1+nb] L[j0:j1, :j1+nb]^H, rows < j0
        Lj = rows_of(L_loc, j0, 0, cmax)                          # (nb, cmax)
        Hloc = torch.matmul(T_loc[:, :cmax], Lj.mH)
        Hloc = torch.where((grow < j0)[:, None], Hloc, torch.zeros((), dtype=dt, device=dev))
        Hcol = axis_allgather(Hloc, grid, AX)                     # (npad, nb)
        # the diagonal identities on every rank (small blocks)
        Ajj = rows_of(A_loc, j0, j0, j1)
        Ljj = Lj[:, j0:j1]
        Hjj = torch.linalg.solve_triangular(Ljj, Ajj - torch.matmul(Lj[:, :j0], Hcol[:j0]),
                                            upper=False, unitriangular=True)
        rhs = Hjj
        if j0 > 0:
            Tprev = rows_of(T_loc, j0, j0 - nb, j0)
            rhs = Hjj - torch.matmul(Tprev, Lj[:, j0 - nb:j0].mH)
        Tjj = torch.linalg.solve_triangular(Ljj.mH, rhs, upper=True, left=False,
                                            unitriangular=True)
        _put(T_loc, r0, mr, j0, j0, (Tjj + Tjj.mH) / 2)
        if j1 >= npad:                   # the last panel has no trailing block
            break
        # Schur panel W = A[:, j0:j1] - L[:, :j0] Hcol - L[:, j0:j1] Hjj
        W = (A_loc[:, j0:j1] - torch.matmul(L_loc[:, :j0], Hcol[:j0])
             - torch.matmul(L_loc[:, j0:j1], Hjj))
        # tournament panel LU over rows >= j1, then the two-sided exchange
        piv = tournament_piv(W, grow, j1, nb, P, grid, AX)
        sp = step_permutation(piv, j1, npad, nb)
        perm = perm[sp]
        S = np.concatenate([j1 + np.arange(nb), piv])
        _swap(A_loc, L_loc, W, S, sp[np.clip(S, 0, npad - 1)], ri, mr, nb, j1, grid)
        # the swapped panel block and its intra-block pivots
        blk = extract_rows(W, np.arange(j1, j1 + nb), ri, mr, grid, AX)
        LUkk, ipiv, _ = torch.linalg.lu_factor_ex(blk)
        bperm = _ipiv_rows(ipiv)
        perm[j1:j1 + nb] = perm[j1 + bperm]
        Sb = j1 + np.arange(nb)
        _swap(A_loc, L_loc, W, Sb, j1 + bperm, ri, mr, nb, j1, grid)
        Up = torch.triu(LUkk)
        dU = torch.diagonal(Up).abs()
        up_safe = Up + torch.diag((dU == 0).to(dt))          # singular pad tail
        X = torch.linalg.solve_triangular(up_safe, W, upper=True, left=False)
        Lblk = torch.tril(LUkk, -1) + eye
        below = (grow >= j1 + nb)[:, None]
        L_loc[:, j1:j1 + nb] = torch.where(below, X, L_loc[:, j1:j1 + nb])
        _put(L_loc, r0, mr, j1, j1, Lblk)
        # T[j1:j1+nb, j0:j1] = Up (L[j0:j1, j0:j1]^H)^{-1} and its mirror
        Tj1j = torch.linalg.solve_triangular(Ljj.mH, Up, upper=True, left=False,
                                             unitriangular=True)
        _put(T_loc, r0, mr, j1, j0, Tj1j)
        _put(T_loc, r0, mr, j0, j1, Tj1j.mH)
    return L_loc, T_loc, perm


def _ipiv_rows(ipiv: torch.Tensor) -> np.ndarray:
    """Row permutation (on the host) of LAPACK's 1-based sequential swaps:
    row i of P·blk is row out[i] of blk."""
    rows = np.arange(ipiv.shape[0])
    for i, one_based in enumerate(ipiv.cpu().numpy().tolist()):
        j = one_based - 1
        rows[i], rows[j] = rows[j], rows[i]
    return rows


def _swap(A_loc, L_loc, W, S, src, ri: int, mr: int, nb: int, j1: int, grid) -> None:
    """The symmetric exchange: rows ``src`` into positions ``S`` of A (rows by
    one masked sum, columns locally), of L inside columns [nb, j1), and of
    the Schur panel W; all in place."""
    exchange_rows(A_loc, S, src, ri, mr, grid, AX)
    S_t = torch.from_numpy(np.asarray(S)).to(A_loc.device)
    A_loc[:, S_t] = A_loc[:, torch.from_numpy(np.asarray(src)).to(A_loc.device)]
    if j1 > nb:                  # L's rows move only inside columns [nb, j1)
        L_loc[:, nb:j1] = exchange_rows(L_loc[:, nb:j1].clone(), S, src, ri, mr,
                                        grid, AX)
    exchange_rows(W, S, src, ri, mr, grid, AX)


@instrument
def hetrf_distributed(A, grid: ProcessGrid, nb: int = 256):
    """Distributed Aasen factorization P A Pᴴ = L T Lᴴ (src/hetrf.cc) of the
    full Hermitian ``A`` (a block-layout DTensor, moved to block rows in one
    all-to-all, or a tensor the same on every rank).  Returns
    ``(HermitianFactorsDist, info)``; T comes back in compact band form
    already factored by the distributed band LU."""
    slate_assert(A.ndim == 2 and A.shape[-1] == A.shape[-2],
                 "hetrf_distributed expects a square Hermitian matrix")
    n = A.shape[-1]
    nb = max(1, min(nb, n))
    npad = ceil_mult(n, nb * grid.size)
    a = local_block(A, grid, (npad, npad), layout=ROWS, eye_from=n)
    L_loc, T_loc, perm = _hetrf_local(a, grid, npad, nb)
    L = trim(L_loc, grid, (npad, npad), (n, n), ROWS)
    Tband = _t_band(T_loc, grid, npad, n, nb)
    T_fac, info = gbtrf_distributed(Tband, grid, nb, nb, nb=nb)
    return HermitianFactorsDist(L=L, Tband=Tband, T_fac=T_fac, perm=perm[:n],
                                nb=nb), info


def _t_band(T_loc, grid: ProcessGrid, npad: int, n: int, nb: int):
    """T[:n, :n] (bandwidth nb) in the gb layout of
    ``dense_to_band_general(T, nb, nb, extra=nb)``, whole on every rank: each
    rank fills the entries of its rows, one masked sum of O(n·nb)."""
    mr = npad // grid.size
    r0 = axis_index(grid, AX) * mr
    dev = T_loc.device
    j = torch.arange(3 * nb + 1, device=dev)[:, None]
    i = torch.arange(n, device=dev)[None, :]
    r = i + j - 2 * nb
    own = (r >= r0) & (r < min(r0 + mr, n))
    vals = T_loc[(r - r0).clamp(0, mr - 1), i.expand_as(r)]
    return axis_allreduce(torch.where(own, vals, torch.zeros((), dtype=vals.dtype,
                                                             device=dev)), grid, AX)


@instrument
def hetrs_distributed(fac: HermitianFactorsDist, B, grid: ProcessGrid):
    """Distributed Aasen solve (src/hetrs.cc): permute, the unit-lower sweep,
    the banded-T solve, the unit-lower-ᴴ sweep, un-permute.  B (n × nrhs) is
    thin and is taken whole; X comes back whole on every rank."""
    from .solvers import trsm_distributed

    vec = B.ndim == 1
    b = gather(B)
    b = b[:, None] if vec else b
    perm = torch.from_numpy(fac.perm).to(b.device)
    n = fac.L.shape[-1]
    Lloc = local_block(fac.L, grid, (n, n), layout=ROWS)
    (r0, r1), _ = bounds(grid, n, n, ROWS)
    rows = torch.arange(r0, r1, device=Lloc.device)[:, None]
    cols = torch.arange(n, device=Lloc.device)[None, :]
    Lu = torch.where(rows > cols, Lloc, (rows == cols).to(Lloc.dtype))
    Lu = wrap(Lu, grid, (n, n), ROWS)
    y = trsm_distributed(Lu, b[perm].to(Lloc.dtype), grid, lower=True, conj_trans=False)
    z = gbtrs_distributed(fac.T_fac, y, grid)
    x = gather(trsm_distributed(Lu, z, grid, lower=True, conj_trans=True))
    out = torch.zeros_like(x)
    out[perm] = x
    return out[:, 0] if vec else out


@instrument
def hesv_distributed(A, B, grid: ProcessGrid, nb: int = 256):
    """Distributed Hermitian-indefinite solve (src/hesv.cc = hetrf + hetrs)."""
    fac, info = hetrf_distributed(A, grid, nb=nb)
    return hetrs_distributed(fac, B, grid), info
