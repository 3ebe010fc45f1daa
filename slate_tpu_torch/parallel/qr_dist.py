"""Distributed communication-avoiding QR over the process grid.

Reference analogues:

* ``src/geqrf.cc:146-253`` — CAQR: Householder panel + triangle-triangle tree
  reduction over grid rows (internal_ttqrt.cc), trailing update.
* ``src/unmqr.cc`` — apply Q; ``src/gels_qr.cc`` — least squares.
* ``src/gelqf.cc`` / ``src/unmlq.cc`` — LQ as CAQR of A^H.

The design follows the JAX package:

- **TSQR rides one all-gather**: every rank factors its rows, the P small R
  triangles are gathered and factored once more on every rank, and each rank
  keeps its own coupling block.
- **Panel QR by block classical Gram-Schmidt with reorthogonalization
  (BCGS2)**: each panel is projected twice against the accumulated Q, then
  TSQR'd along p.  Q is *explicit*, so applying it is one sharded gemm.
"""

from __future__ import annotations

import torch

from ..core.exceptions import slate_assert
from ..obs import instrument
from .collectives import axis_allgather, axis_allreduce, axis_index
from .distribute import (ROWS, bounds, ceil_mult, gather, is_dist, local_block,
                         transpose_local, trim, wrap)
from .mesh import COL_AXIS, FLAT, ProcessGrid, ROW_AXIS


def _qr(a):
    return torch.linalg.qr(a, mode="reduced")


@instrument
def tsqr_distributed(A, grid: ProcessGrid):
    """Tall-skinny QR by one tree round over the whole grid (ttqrt analogue).

    A is 1-D row-sharded over the flattened grid; returns ``(Q row-sharded, R
    whole on every rank)`` with Q explicit reduced m×n.  Unconditionally stable
    (Householder leaves + Householder merge), unlike the Gram-based CholQR."""
    m, n = A.shape[-2:]
    world = grid.size
    slate_assert(m >= n, "tsqr expects a tall matrix")
    mpad = ceil_mult(m, world * max(n, 1))     # every leaf needs >= n rows
    a = local_block(A, grid, (mpad, n), layout=ROWS)
    q_leaf, r_leaf = _qr(a)
    Rs = axis_allgather(r_leaf, grid, FLAT, dim=0)            # (world*n, n)
    q_stack, R = _qr(Rs)
    w = axis_index(grid, FLAT)
    Q = torch.matmul(q_leaf, q_stack[w * n:(w + 1) * n])
    return trim(Q, grid, (mpad, n), (m, n), ROWS), R


@instrument
def unmqr_distributed(Q, C, grid: ProcessGrid, trans: bool = True):
    """Apply the explicit row-sharded Q (or Q^H) to C whole on every rank
    (src/unmqr.cc collapses — Q is explicit): Q^H C is whole on every rank,
    Q C row-sharded."""
    m, n = Q.shape[-2:]
    q = local_block(Q, grid, layout=ROWS)
    (r0, r1), _ = bounds(grid, m, n, ROWS)
    c = gather(C)
    if trans:
        return axis_allreduce(torch.matmul(q.mH, c[r0:r1].to(q.dtype)), grid, FLAT)
    return wrap(torch.matmul(q, c.to(q.dtype)), grid, (m, c.shape[-1]), ROWS)


@instrument
def gels_qr_distributed(A, B, grid: ProcessGrid):
    """Overdetermined least squares via distributed TSQR (src/gels_qr.cc):
    X = R^{-1} (Q^H B), whole on every rank."""
    Q, R = tsqr_distributed(A, grid)
    QhB = unmqr_distributed(Q, B, grid, trans=True)
    return torch.linalg.solve_triangular(R, QhB, upper=True)


def _geqrf_local(A_loc, grid, mpad, npad, nb):
    p, q = grid.p, grid.q
    mr, mc = mpad // p, npad // q
    pi, qi = grid.my_coords
    dev = A_loc.device
    gcol = qi * mc + torch.arange(mc, device=dev)
    zero = torch.zeros((), dtype=A_loc.dtype, device=dev)
    Q_loc = torch.zeros_like(A_loc)
    R_loc = torch.zeros_like(A_loc)

    def project(Qm, Pn):
        """One BCGS pass: my coefficients W and the projected panel."""
        W = axis_allreduce(torch.matmul(Qm.mH, Pn), grid, ROW_AXIS)   # (mc, nb)
        proj = axis_allreduce(torch.matmul(Qm, W), grid, COL_AXIS)
        return W, Pn - proj

    for k0 in range(0, npad, nb):
        qo, off = k0 // mc, k0 % mc
        # panel columns [k0, k0+nb) of the ORIGINAL A (left-looking)
        pan = A_loc[:, off:off + nb].clone() if qi == qo else A_loc.new_zeros((mr, nb))
        pan = axis_allreduce(pan, grid, COL_AXIS)
        Qm = torch.where((gcol < k0)[None, :], Q_loc, zero)
        W1, P1 = project(Qm, pan)
        W2, P2 = project(Qm, P1)
        # TSQR of the projected panel along p
        q_leaf, r_leaf = _qr(P2)
        Rs = axis_allgather(r_leaf, grid, ROW_AXIS, dim=0)             # (p*nb, nb)
        q_stack, Rkk = _qr(Rs)
        Qk = torch.matmul(q_leaf, q_stack[pi * nb:(pi + 1) * nb])
        if qi == qo:
            Q_loc[:, off:off + nb] = Qk
        # the R column block: rows < k0 from W1 + W2 (my Q columns), the
        # diagonal block from Rkk
        W = torch.where((gcol < k0)[:, None], W1 + W2, zero)
        top = k0 + nb
        Rcol = A_loc.new_zeros((top, nb))
        if pi == 0:
            inr = gcol < top
            Rcol[gcol[inr]] = W[inr]
            if qi == 0:
                Rcol[k0:top] = Rkk
            else:
                Rcol[k0:top] = 0
        Rcol = axis_allreduce(Rcol, grid, FLAT)
        if qi == qo:
            r0, r1 = pi * mr, min((pi + 1) * mr, top)
            if r1 > r0:
                R_loc[:r1 - r0, off:off + nb] = Rcol[r0:r1]
    return Q_loc, R_loc


@instrument
def geqrf_distributed(A, grid: ProcessGrid, nb: int = 256):
    """Distributed blocked CAQR of a general m×n matrix (m ≥ n) over the grid
    (src/geqrf.cc:146-253 analogue; BCGS2 + TSQR panels).  Returns ``(Q, R)``:
    Q explicit reduced (m×n), R (n×n), both in the block layout."""
    m, n = A.shape[-2:]
    slate_assert(m >= n, "geqrf_distributed expects m >= n")
    nb = max(1, min(nb, n))
    npad = ceil_mult(n, nb * grid.q)
    mpad = ceil_mult(max(m + (npad - n), npad), nb * grid.p)
    if (mpad, npad) != (m, n):
        a = gather(A)
        full = a.new_zeros((mpad, npad))
        full[:m, :n] = a
        if npad > n:
            # unit columns in the padding keep every panel full rank; they
            # come after the real columns, so R[:n, :n] and Q[:, :n] hold
            idx = torch.arange(npad - n, device=a.device)
            full[m + idx, n + idx] = 1
        A = full
    A_loc = local_block(A, grid, (mpad, npad))
    Q_loc, R_loc = _geqrf_local(A_loc, grid, mpad, npad, min(nb, npad))
    return (trim(Q_loc, grid, (mpad, npad), (m, n)),
            trim(R_loc, grid, (mpad, npad), (n, n)))


def _qh_b_block(Q, B, grid):
    """Q^H B for a block-layout Q and B whole on every rank, whole on every
    rank: local products summed along p, the column blocks gathered along q."""
    m, n = Q.shape[-2:]
    q = local_block(Q, grid)
    (r0, r1), (c0, c1) = bounds(grid, m, n)
    b = gather(B)
    part = axis_allreduce(torch.matmul(q.mH, b[r0:r1].to(q.dtype)), grid, ROW_AXIS)
    c = -(-n // grid.q)
    if part.shape[0] < c:
        part = torch.cat([part, part.new_zeros((c - part.shape[0], part.shape[1]))])
    return axis_allgather(part, grid, COL_AXIS, dim=0)[:n]


@instrument
def gels_caqr_distributed(A, B, grid: ProcessGrid, nb: int = 256):
    """Least squares through the 2-D CAQR (general overdetermined A); X whole
    on every rank."""
    Q, R = geqrf_distributed(A, grid, nb=nb)
    QhB = _qh_b_block(Q, B, grid)
    return torch.linalg.solve_triangular(gather(R), QhB, upper=True)


def _transpose(X, grid, conj=True):
    """op(X) of a block-layout DTensor (or a tensor) as a block-layout DTensor."""
    m, n = X.shape[-2:]
    if not is_dist(X):
        t = X.mH if conj else X.mT
        return wrap(local_block(t, grid), grid, (n, m))
    return wrap(transpose_local(local_block(X, grid), grid, m, n, conj=conj),
                grid, (n, m))


@instrument
def gelqf_distributed(A, grid: ProcessGrid, nb: int = 256):
    """Distributed LQ factorization A = L Q over the grid (src/gelqf.cc): CAQR
    of A^H, A^H = Q1 R1 gives A = R1^H Q1^H.  Returns ``(L, Q)``: L (m×m
    lower), Q (m×n with orthonormal rows), both in the block layout."""
    m, n = A.shape[-2:]
    slate_assert(n >= m, "gelqf_distributed expects a wide matrix (m <= n)")
    Q1, R1 = geqrf_distributed(_transpose(A, grid), grid, nb=nb)
    return _transpose(R1, grid), _transpose(Q1, grid)


@instrument
def unmlq_distributed(Q, C, grid: ProcessGrid, conj_trans: bool = False):
    """Apply the LQ factor's Q (rows orthonormal) to C from the left
    (src/unmlq.cc): op(Q) @ C as one SUMMA gemm."""
    from .summa import gemm_padded

    Qop = _transpose(Q, grid) if conj_trans else Q
    return gemm_padded(Qop, C, grid)


@instrument
def gels_lq_distributed(A, B, grid: ProcessGrid, nb: int = 256):
    """Minimum-norm solution of the underdetermined A X = B over the grid
    (src/gels.cc wide branch): A = L Q, X = Q^H L^{-1} B."""
    from .solvers import trsm_distributed

    L, Q = gelqf_distributed(A, grid, nb=nb)
    Y = trsm_distributed(L, B, grid, lower=True, conj_trans=False)
    return unmlq_distributed(Q, Y, grid, conj_trans=True)
