"""Distributed solvers over the process grid.

Reference analogues:

* ``src/potrf.cc:22-210`` — right-looking Cholesky: the panel broadcast along
  rows and columns, then a shard-local trailing update.
* ``src/work/work_trsm.cc:54-387`` and ``src/trsmA.cc`` — the triangular
  solves, stationary-B and stationary-A.
* ``src/cholqr.cc`` + ``src/gels_cholqr.cc`` — tall-skinny QR through the Gram
  matrix (one all-reduce of the per-rank Grams).

Every body is shard-local with explicit collectives (``collectives.py``): each
rank holds one block of the block layout and moves only panels, never the
whole matrix.  A step's panel is a sum of masked contributions, so a panel
that straddles two shards needs no special case.
"""

from __future__ import annotations

import torch

from ..core.exceptions import slate_assert
from ..linalg.chol import _chol_blocked
from ..obs import instrument
from ..robust import RetryPolicy, Rung, guard_shards, inject, run_ladder
from ..utils.trace import trace_event
from .collectives import axis_allgather, axis_allreduce, axis_index
from .distribute import ROWS, bounds, gather, global_index, lcm, local_block, trim
from .eig_dist import _shard
from .mesh import COL_AXIS, FLAT, ProcessGrid, ROW_AXIS

_TRSM_NB = 256


def _trsm_block(npad: int, grid) -> int:
    """Block rows per trsm step: up to 256, and small enough that the
    replicated diagonal blocks stay a small share of a modest matrix."""
    return min(_TRSM_NB, max(8, npad // (4 * lcm(grid.p, grid.q))))


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def _tril_local(a, grid, n, k=0):
    rows, cols = global_index(grid, n, n, device=a.device)
    return torch.where(rows - cols >= -k, a, _zero(a))


def _triu_local(a, grid, n, k=0):
    rows, cols = global_index(grid, n, n, device=a.device)
    return torch.where(cols - rows >= k, a, _zero(a))


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------


def _potrf_local(a: torch.Tensor, grid: ProcessGrid, n: int, nb: int) -> torch.Tensor:
    """Right-looking lower Cholesky of this rank's block ``a`` of an n×n SPD
    matrix (block layout), in place; returns the block of L.

    Per panel k (potrf.cc:84-195): (1) every rank gets its rows of panel
    columns [k0, k1) from their q-owners (a masked sum along q — the panel
    broadcast along rows); (2) the diagonal block is summed along p and
    factored on every rank; (3) each rank solves its rows of the panel;
    (4) the panel rows matching its columns arrive along p (the broadcast
    down columns); (5) the trailing update is local gemms on the lower
    triangle of the block, one column strip of width nb each."""
    (r0, r1), (c0, c1) = bounds(grid, n, n)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        w = k1 - k0
        lo = max(k0, r0)                      # my rows of the panel: [lo, r1)
        cs, ce = max(k0, c0), min(k1, c1)     # my columns of the panel
        pan = None
        if r1 > lo:
            buf = a.new_zeros((r1 - lo, w))
            if ce > cs:
                buf[:, cs - k0:ce - k0] = a[lo - r0:, cs - c0:ce - c0]
            pan = axis_allreduce(buf, grid, COL_AXIS)
        D = a.new_zeros((w, w))
        rs, re_ = max(k0, r0), min(k1, r1)
        if re_ > rs:
            D[rs - k0:re_ - k0] = pan[rs - lo:re_ - lo]
        Lkk = _chol_blocked(axis_allreduce(D, grid, ROW_AXIS))
        plo = max(k1, r0)                     # my rows below the block
        Pm = None
        if r1 > plo:
            Pm = torch.linalg.solve_triangular(Lkk.mH, pan[plo - lo:],
                                               upper=True, left=False)
        if ce > cs:                           # write my part of the panel
            if re_ > rs:
                a[rs - r0:re_ - r0, cs - c0:ce - c0] = \
                    Lkk[rs - k0:re_ - k0, cs - k0:ce - k0]
            if Pm is not None:
                a[plo - r0:, cs - c0:ce - c0] = Pm[:, cs - k0:ce - k0]
        clo = max(k1, c0)                     # my columns right of the block
        if c1 > clo:
            colbuf = a.new_zeros((c1 - clo, w))
            s2, e2 = max(clo, plo), min(c1, r1)
            if e2 > s2:
                colbuf[s2 - clo:e2 - clo] = Pm[s2 - plo:e2 - plo]
            Pc = axis_allreduce(colbuf, grid, ROW_AXIS)
            # the lower triangle only, a column strip of width nb at a time
            # (rows above a strip's first column are never read again)
            for s0 in range(clo, c1, nb) if Pm is not None else ():
                s1 = min(s0 + nb, c1)
                rlo = max(plo, s0)
                if r1 > rlo:
                    a[rlo - r0:, s0 - c0:s1 - c0] -= torch.matmul(
                        Pm[rlo - plo:], Pc[s0 - clo:s1 - clo].mH)
    return _tril_local(a, grid, n)


def _pad_spd_shape(n: int, mult: int) -> int:
    return -(-n // mult) * mult


@instrument
def potrf_distributed(Af, grid: ProcessGrid, nb: int = 256, method: str = "auto",
                      lookahead: int = 1):
    """Distributed lower Cholesky of a full Hermitian matrix (tensor or
    DTensor).  Returns L in the block layout.

    ``method`` ("auto" | "unroll" | "loop") picks between the JAX package's
    two compiled bodies; eager PyTorch runs the same right-looking loop for
    all three.  ``lookahead >= 2`` routes to the explicit software pipeline
    (:func:`~.pipeline.potrf_pipelined`), the reference's lookahead tasks
    (potrf.cc:84-195)."""
    n0 = Af.shape[-1]
    nb = max(1, min(nb, n0))
    if lookahead >= 2:
        from .pipeline import potrf_pipelined

        return potrf_pipelined(Af, grid, nb=nb)
    npad = _pad_spd_shape(n0, lcm(grid.p, grid.q))
    a = local_block(Af, grid, (npad, npad), eye_from=n0)
    L = _potrf_local(a, grid, npad, min(nb, npad))
    return trim(L, grid, (npad, npad), (n0, n0))


def _panel(src, grid, n, r0, r1, c0, c1, rows, cols, axis):
    """The window rows×cols (global [start, stop) pairs) of a block-layout
    operand, summed from its owners' masked pieces along ``axis``."""
    (a0, a1), (b0, b1) = rows, cols
    buf = src.new_zeros((a1 - a0, b1 - b0))
    rs, re_ = max(a0, r0), min(a1, r1)
    cs, ce = max(b0, c0), min(b1, c1)
    if re_ > rs and ce > cs:
        buf[rs - a0:re_ - a0, cs - b0:ce - b0] = src[rs - r0:re_ - r0, cs - c0:ce - c0]
    return axis_allreduce(buf, grid, axis)


def _trsm_local(Lloc, Bloc, grid: ProcessGrid, n: int, nrhs: int, lower: bool,
                conj_trans: bool, unit_diag: bool = False, nb: int = None):
    """Blocked left triangular solve op(L) X = B on block-layout shards
    (work_trsm.cc): per block row, the diagonal block is summed over the grid,
    B's block row comes down the columns (along p), the solved block updates
    the remaining rows.  The update needs op(L)'s column panel for my rows:
    for op = N that is L's column panel, summed along q; for op = H it is L's
    row panel, summed over the whole grid.  Returns X's shard."""
    (r0, r1), (c0, c1) = bounds(grid, n, n)
    (_, _), (bc0, bc1) = bounds(grid, n, nrhs)
    nb = nb or _trsm_block(n, grid)
    X = Bloc.clone()
    forward = lower != conj_trans
    upper_op = lower == conj_trans
    steps = list(range(0, n, nb))
    for k0 in (steps if forward else reversed(steps)):
        k1 = min(k0 + nb, n)
        D = _panel(Lloc, grid, n, r0, r1, c0, c1, (k0, k1), (k0, k1), FLAT)
        Bk = _panel(X, grid, n, r0, r1, bc0, bc1, (k0, k1), (bc0, bc1), ROW_AXIS)
        Xk = torch.linalg.solve_triangular(D.mH if conj_trans else D, Bk,
                                           upper=upper_op, unitriangular=unit_diag)
        rs, re_ = max(k0, r0), min(k1, r1)
        if re_ > rs:
            X[rs - r0:re_ - r0] = Xk[rs - k0:re_ - k0]
        rem = (k1, n) if forward else (0, k0)
        lo, hi = max(rem[0], r0), min(rem[1], r1)
        if rem[1] <= rem[0]:
            continue
        if not conj_trans:
            if hi > lo:
                P = _panel(Lloc, grid, n, r0, r1, c0, c1, (lo, hi), (k0, k1), COL_AXIS)
                X[lo - r0:hi - r0] -= torch.matmul(P, Xk)
        else:
            R = _panel(Lloc, grid, n, r0, r1, c0, c1, (k0, k1), rem, FLAT)
            if hi > lo:
                X[lo - r0:hi - r0] -= torch.matmul(R[:, lo - rem[0]:hi - rem[0]].mH, Xk)
    return X


def _pad_tri_local(L, grid, n0, npad):
    """Shard of L zero-padded to npad with an identity tail (keeps it invertible)."""
    return local_block(L, grid, (npad, npad), eye_from=n0)


@instrument
def trsm_distributed(L, B, grid: ProcessGrid, lower: bool = True,
                     conj_trans: bool = False):
    """Distributed left triangular solve op(L) X = B, stationary-B
    (work::trsm).  Ragged shapes are padded: L gets an identity tail, B zero
    rows/cols.  X comes back in the block layout."""
    n, nrhs = B.shape[-2:]
    npad = _pad_spd_shape(n, lcm(grid.p, grid.q))
    cpad = _pad_spd_shape(nrhs, grid.q)
    Lp = _pad_tri_local(L, grid, n, npad)
    Bp = local_block(B, grid, (npad, cpad))
    X = _trsm_local(Lp, Bp.to(Lp.dtype) if Bp.dtype != Lp.dtype else Bp, grid,
                    npad, cpad, lower, conj_trans)
    return trim(X, grid, (npad, cpad), (n, nrhs))


@instrument
def posv_distributed(Af, B, grid: ProcessGrid, nb: int = 256):
    """Distributed SPD solve: potrf + two trsm sweeps (src/posv.cc), all
    sharded, under the failed-shard guard (robust.guard_shards)."""

    def run():
        L = potrf_distributed(inject("posv_distributed", Af), grid, nb)
        Y = trsm_distributed(L, B, grid, lower=True, conj_trans=False)
        return trsm_distributed(L, Y, grid, lower=True, conj_trans=True)

    X, _ = guard_shards("posv_distributed", run, RetryPolicy(max_retries=1))
    return X


@instrument
def trsmA_distributed(A, B, grid: ProcessGrid, lower: bool = True,
                      conj_trans: bool = False, unit_diag: bool = False):
    """Distributed left triangular solve, stationary-A dataflow (src/trsmA.cc,
    work/work_trsmA.cc:1-580).  A stays row-sharded over the flattened grid
    and never moves; per block only the solved nb×nrhs X block travels (one
    masked-sum broadcast from its owner, plus one sum of the column-panel
    partials in the conj-transpose sweep).  Pads to a (nproc·nb)-aligned size
    with an identity tail.  X comes back whole on every rank.

    Sweep table: lower/N forward row-panel, lower/H backward column-panel,
    upper/N backward row-panel, upper/H forward column-panel."""
    n, nrhs = B.shape[-2:]
    nproc = grid.size
    nb = max(32, min(256, -(-n // nproc)))
    npad = _pad_spd_shape(n, nproc * nb)
    a_loc = local_block(A, grid, (npad, npad), layout=ROWS, eye_from=n)
    b = gather(B)
    b = torch.cat([b, b.new_zeros((npad - n, b.shape[-1]))]) if npad != n else b
    b = b.to(a_loc.dtype)
    rl = npad // nproc
    nt = npad // nb
    me = axis_index(grid, FLAT)
    forward = (lower and not conj_trans) or (not lower and conj_trans)
    X = torch.zeros_like(b)
    for i in range(nt):
        k = i if forward else nt - 1 - i
        k0 = k * nb
        owner = k0 // rl
        loc = k0 - owner * rl
        bk = b[k0:k0 + nb]
        if not conj_trans:
            # X is zero on every unsolved row, so the owner's full row panel
            # times X is exactly the solved-part update — no communication
            upd = torch.matmul(a_loc[loc:loc + nb], X) if me == owner \
                else torch.zeros_like(bk)
        else:
            part = torch.matmul(a_loc[:, k0:k0 + nb].mH, X[me * rl:(me + 1) * rl])
            upd = axis_allreduce(part, grid, FLAT)
        if me == owner:
            xk = torch.linalg.solve_triangular(
                a_loc[loc:loc + nb, k0:k0 + nb].mH if conj_trans
                else a_loc[loc:loc + nb, k0:k0 + nb], bk - upd,
                upper=(not lower) != conj_trans, unitriangular=unit_diag)
        else:
            xk = torch.zeros_like(bk)
        X[k0:k0 + nb] = axis_allreduce(xk, grid, FLAT)   # broadcast from the owner
    return X[:n]


def _lower_dtype(dt):
    """The precision-ladder policy, shared with the single-device drivers."""
    from ..linalg.chol import _lower_precision

    return _lower_precision(dt)


def _matvec_rows(a_loc, grid, m, n, x):
    """A @ x for a block-layout A (shard ``a_loc``) and x whole on every rank:
    local products summed along q, the row blocks gathered along p."""
    (r0, r1), (c0, c1) = bounds(grid, m, n)
    part = axis_allreduce(torch.matmul(a_loc, x[c0:c1].to(a_loc.dtype)), grid,
                          COL_AXIS)
    c = -(-m // grid.p)
    if part.shape[0] < c:
        part = torch.cat([part, part.new_zeros((c - part.shape[0],) + part.shape[1:])])
    return axis_allgather(part, grid, ROW_AXIS, dim=0)[:m]


def _ir_refine_distributed(Af, B, solve_lo, grid, max_iterations, tol=None):
    """Working-precision iterative refinement around a low-precision sharded
    solve (the gesv_mixed.cc loop over the grid).  The residual uses the
    block-layout matrix (one reduction along q and one gather along p per
    step); the convergence check is one host sync per iteration.

    Returns ``(X, iters, ok)``, X whole on every rank."""
    from .eig_dist import norm_distributed

    b = gather(B)
    dt = b.dtype
    eps = torch.finfo(b.real.dtype if b.is_complex() else b.dtype).eps
    n = Af.shape[-1]
    tol = tol if tol is not None else eps * (n ** 0.5)
    a_loc = local_block(Af, grid)
    anorm = norm_distributed("inf", Af, grid)
    tiny = torch.finfo(anorm.dtype).tiny

    def residual(X):
        R = b - _matvec_rows(a_loc, grid, n, n, X)
        scale = torch.clamp(X.abs().max(), min=tiny) if X.numel() else anorm.new_tensor(tiny)
        good = bool(R.abs().max() <= tol * anorm * scale)
        return R, good

    X = gather(solve_lo(b)).to(dt)
    R, good = residual(X)
    it = 0
    while not good and it < max_iterations:
        X = X + gather(solve_lo(R)).to(dt)
        R, good = residual(X)
        it += 1
    return X, it, good and bool(torch.isfinite(X).all())


@instrument
def posv_mixed_distributed(Af, B, grid: ProcessGrid, nb: int = 256,
                           max_iterations: int = 30):
    """Distributed mixed-precision SPD solve (src/posv_mixed.cc over the grid):
    factor one precision down (f32 has no lower rung), refine at working
    precision, escalate along the mixed→full ladder when IR stalls.
    Returns (X, iters, converged_via_ir)."""
    lo = _lower_dtype(Af.dtype)
    if lo is None:
        return posv_distributed(Af, B, grid, nb=nb), 0, True
    state = {"iters": 0}

    def mixed_rung():
        L = potrf_distributed(
            inject("posv_mixed_distributed", _cast(Af, lo), point="factor"),
            grid, nb=nb)

        def solve_lo(R):
            Y = trsm_distributed(L, R.to(lo), grid, lower=True, conj_trans=False)
            return trsm_distributed(L, Y, grid, lower=True, conj_trans=True)

        X, iters, ok = _ir_refine_distributed(Af, B, solve_lo, grid, max_iterations)
        state["iters"] = int(iters)
        return (_shard(X, grid), True), ok

    def full_rung():
        return (posv_distributed(Af, B, grid, nb=nb), False), True

    X, via_ir = run_ladder("posv_mixed_distributed",
                           [Rung("mixed", mixed_rung), Rung("full", full_rung)])
    return X, state["iters"], via_ir


def _cast(x, dtype):
    """``x`` in ``dtype``; a DTensor is cast shard by shard."""
    from .distribute import is_dist

    if is_dist(x):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(x.to_local().to(dtype), x.device_mesh,
                                  x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return x.to(dtype)


@instrument
def posv_mixed_gmres_distributed(Af, B, grid: ProcessGrid, nb: int = 256,
                                 opts=None):
    """Distributed SPD GMRES-IR (src/posv_mixed_gmres.cc over the grid):
    FGMRES with sharded matvecs, right-preconditioned by the low-precision
    sharded Cholesky solve.  Single-RHS like the reference.  Returns
    (X, restarts, converged); full-precision sharded fallback on stall."""
    from ..core.types import Options
    from ..linalg.lu import _gmres_ir, _require_single_rhs

    opts = Options.make(opts)
    b = gather(B)
    _require_single_rhs(b, "posv_mixed_gmres_distributed")
    vec = b.ndim == 1
    B2 = b[:, None] if vec else b

    def fallback():
        Xf = gather(posv_distributed(Af, B2, grid, nb=nb))
        return Xf[:, 0] if vec else Xf

    lo = opts.factor_precision or _lower_dtype(Af.dtype)
    if lo is None:
        return fallback(), 0, True
    from ..core.matrix import torch_dtype

    lo = torch_dtype(lo)
    n = Af.shape[-1]
    L = potrf_distributed(_cast(Af, lo), grid, nb=nb)
    a_loc = local_block(Af, grid)

    def matvec(x):
        return _matvec_rows(a_loc, grid, n, n, x[:, None])[:, 0]

    def precond(r):
        y = trsm_distributed(L, r.to(lo)[:, None], grid, lower=True)
        z = trsm_distributed(L, y, grid, lower=True, conj_trans=True)
        return gather(z)[:, 0].to(b.dtype)

    X, restarts, converged = _gmres_ir(matvec, precond, b, opts,
                                       "posv_mixed_gmres_distributed")
    if not converged:
        if not opts.use_fallback_solver:
            return X, int(restarts), False
        trace_event("fallback", routine="posv_mixed_gmres_distributed", to="full")
        return fallback(), int(restarts), False
    return X, int(restarts), True


# ---------------------------------------------------------------------------
# Tall-skinny CholQR (communication-avoiding QR)
# ---------------------------------------------------------------------------


@instrument
def cholqr_distributed(A, grid: ProcessGrid, precision=None):
    """Tall-skinny QR via Cholesky of the Gram matrix (src/cholqr.cc).

    A is 1-D row-sharded over the flattened grid; returns (Q row-sharded, R
    whole on every rank).  The sum of the per-rank Grams is the reference's
    listReduce tree (BaseMatrix.hh:2219-2258) as one all-reduce.  A Gram
    Cholesky that fails (rank-deficient input) falls back to Householder QR of
    the gathered matrix, the reference's MethodCholQR -> QR fallback."""
    from ..ops import blas3

    m, n = A.shape[-2:]
    world = grid.size
    slate_assert(m >= n, "cholqr expects a tall matrix")
    mpad = _pad_spd_shape(m, world)
    a = local_block(A, grid, (mpad, n), layout=ROWS)
    g = axis_allreduce(blas3.gram(a), grid, FLAT)
    Rg = _chol_blocked(g).mH                               # g = R^H R
    if bool(torch.isfinite(torch.diagonal(Rg)).all()):
        q = torch.linalg.solve_triangular(Rg, a, upper=True, left=False)
        R = Rg
    else:
        full = axis_allgather(a, grid, FLAT, dim=0)
        Qf, R = torch.linalg.qr(full)
        rl = mpad // world
        w = axis_index(grid, FLAT)
        q = Qf[w * rl:(w + 1) * rl]
    return trim(q, grid, (mpad, n), (m, n), ROWS), R


@instrument
def gels_cholqr_distributed(A, B, grid: ProcessGrid):
    """Overdetermined least squares min ||A X - B|| via CholQR
    (src/gels_cholqr.cc): X = R^{-1} (Q^H B), whole on every rank."""
    from .qr_dist import unmqr_distributed

    Q, R = cholqr_distributed(A, grid)
    QhB = unmqr_distributed(Q, B, grid, trans=True)
    return torch.linalg.solve_triangular(R, QhB.to(R.dtype), upper=True)
