"""Distributed LU with tournament pivoting over the process grid.

Reference analogues:

* ``src/getrf.cc:22-260`` — partial-pivot LU: panel factor + pivot broadcast +
  row swaps + trailing update.
* ``src/getrf_tntpiv.cc:161-230`` + ``src/internal/internal_getrf_tntpiv.cc`` —
  CALU tournament pivoting: block-local partially-pivoted panel LUs, then a
  reduction over the candidate pivot rows.
* ``src/internal/internal_swap.cc`` — permuteRows row exchanges.
* ``src/gesv.cc`` — getrf + getrs.

The design follows the JAX package's shard-local pipeline:

- **Tournament pivoting is the default**: one candidate all-gather per
  *panel* instead of one maxloc all-reduce per column.  Each grid row factors
  its local panel chunk, the winners meet in one stacked LU.
- **Row swaps move only the ≤ 2·nb dirty rows**, fetched with a masked sum
  along p and scattered by their owners.
- Layout is the block layout, padded with an identity tail so panels align
  with shard boundaries.  The trailing update of each panel is one local
  gemm on the rows and columns right of and below the panel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.exceptions import slate_assert
from ..obs import instrument
from ..robust import RetryPolicy, first_bad_index, guard_shards, inject
from ..utils.trace import trace_event
from .collectives import axis_allreduce, axis_index
from .distribute import ROWS, ceil_mult, gather, lcm, local_block, trim, wrap
from .mesh import COL_AXIS, FLAT, ProcessGrid, ROW_AXIS
from .pivot import exchange_rows, select_pivots, step_permutation


def _panel_tail(A_loc, pan, LUkk, k0, grow, gcol, pi, qi, mr, mc, nb, grid,
                row_axis=ROW_AXIS):
    # grow/gcol: global row/col of each local row/col; the local block starts
    # at global (pi*mr, qi*mc)
    """Shared post-factor panel pipeline of the LU variants (tournament and
    nopiv — rbt.py): panel L by a solve against Ukk, packed L\\U write-back on
    the owner grid column, U row band summed along p, trailing gemm."""
    po, roff = k0 // mr, k0 % mr
    qo, off = k0 // mc, k0 % mc
    Ukk = torch.triu(LUkk)
    X = torch.linalg.solve_triangular(Ukk, pan, upper=True, left=False)
    below = grow >= k0 + nb
    zero = torch.zeros((), dtype=pan.dtype, device=pan.device)
    Lmask = torch.where(below[:, None], X, zero)
    if qi == qo:
        # rows < k0 keep U history; block rows get packed L\U; rows below get L
        packed = torch.where(below[:, None], Lmask, pan)
        if pi == po:
            packed[roff:roff + nb] = LUkk
        A_loc[:, off:off + nb] = packed
    # U row band: U = Lkk^{-1} A[k0:k0+nb, :], broadcast along p
    rb = A_loc[roff:roff + nb].clone() if pi == po else \
        A_loc.new_zeros((nb, A_loc.shape[1]))
    rb = axis_allreduce(rb, grid, row_axis)
    U_loc = torch.linalg.solve_triangular(LUkk, rb, upper=False, unitriangular=True)
    ucols = gcol >= k0 + nb
    if pi == po:
        A_loc[roff:roff + nb] = torch.where(ucols[None, :], U_loc, rb)
    # trailing update on the rows below and columns right of the panel
    rlo = min(max(k0 + nb - pi * mr, 0), mr)
    clo = min(max(k0 + nb - qi * mc, 0), A_loc.shape[1])
    if rlo < mr and clo < A_loc.shape[1]:
        A_loc[rlo:, clo:] -= torch.matmul(Lmask[rlo:], U_loc[:, clo:])
    return A_loc


def _lu_diag_info(A_loc, grow, gcol, npad, grid, axes=FLAT):
    """First bad U diagonal (0 or non-finite), summed over the grid — the
    reduce_info analogue shared by the LU variants."""
    on = grow[:, None] == gcol[None, :]
    drow = torch.sum(torch.where(on, A_loc, torch.zeros_like(A_loc)), dim=1)
    diag = A_loc.new_zeros((npad,))
    inr = grow < npad
    diag[grow[inr]] = drow[inr]
    diag = axis_allreduce(diag, grid, axes)
    return first_bad_index((diag == 0) | ~torch.isfinite(diag))


def _getrf_local(A_loc, grid, npad, nb, lu_panel):
    """Tournament (or pp) LU of this rank's npad/p × npad/q block, in place;
    returns (A_loc, perm (numpy), info)."""
    p, q = grid.p, grid.q
    mr, mc = npad // p, npad // q
    pi, qi = grid.my_coords
    dev = A_loc.device
    grow = pi * mr + torch.arange(mr, device=dev)
    gcol = qi * mc + torch.arange(mc, device=dev)
    perm = np.arange(npad)

    def extract_panel(k0):
        """My rows of panel columns [k0, k0+nb): the owner grid column
        contributes, a sum along q (the panel listBcast)."""
        qo, off = k0 // mc, k0 % mc
        pan = A_loc[:, off:off + nb].clone() if qi == qo else A_loc.new_zeros((mr, nb))
        return axis_allreduce(pan, grid, COL_AXIS)

    for k0 in range(0, npad, nb):
        pan = extract_panel(k0)
        piv = select_pivots(lu_panel, pan, grow, k0, nb, p, grid, ROW_AXIS)
        stepperm = step_permutation(piv, k0, npad, nb)
        perm = perm[stepperm]
        S = np.concatenate([k0 + np.arange(nb), piv])
        exchange_rows(A_loc, S, stepperm[S], pi, mr, grid, ROW_AXIS)
        pan = extract_panel(k0)
        po, roff = k0 // mr, k0 % mr
        blk = pan[roff:roff + nb].clone() if pi == po else pan.new_zeros((nb, nb))
        blk = axis_allreduce(blk, grid, ROW_AXIS)      # diagonal block everywhere
        LUkk, blkperm = _lu_packed(blk)
        perm[k0:k0 + nb] = perm[k0 + blkperm]
        if pi == po:
            idx = torch.from_numpy(roff + blkperm).to(dev)
            A_loc[roff:roff + nb] = A_loc[idx].clone()
            pan[roff:roff + nb] = pan[idx].clone()
        A_loc = _panel_tail(A_loc, pan, LUkk, k0, grow, gcol, pi, qi, mr, mc, nb, grid)
    return A_loc, perm, _lu_diag_info(A_loc, grow, gcol, npad, grid)


def _lu_packed(blk):
    """Packed partially-pivoted LU of a square block and its row permutation
    (numpy; row i of P·blk is row perm[i] of blk)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(blk)
    rows = np.arange(blk.shape[0])
    for i, one_based in enumerate(piv.cpu().numpy().tolist()):
        j = one_based - 1
        rows[i], rows[j] = rows[j], rows[i]
    return lu, rows


def _getrf_tall_local(A_loc, grid, mpad, npc, nb, lu_panel):
    """1-D TSLU of this rank's mpad/P × npc row block (every rank owns all
    columns): tournament panels over the flattened grid, trailing updates as
    local gemms.  Returns (A_loc, perm (numpy), info)."""
    nprocs = grid.size
    mr = mpad // nprocs
    dev = A_loc.device
    ri = axis_index(grid, FLAT)
    grow = ri * mr + torch.arange(mr, device=dev)
    gcol = torch.arange(npc, device=dev)
    perm = np.arange(mpad)
    for k0 in range(0, npc, nb):
        pan = A_loc[:, k0:k0 + nb]
        piv = select_pivots(lu_panel, pan, grow, k0, nb, nprocs, grid, FLAT)
        stepperm = step_permutation(piv, k0, mpad, nb)
        perm = perm[stepperm]
        S = np.concatenate([k0 + np.arange(nb), piv])
        exchange_rows(A_loc, S, stepperm[S], ri, mr, grid, FLAT)
        po, roff = k0 // mr, k0 % mr
        blk = A_loc[roff:roff + nb, k0:k0 + nb].clone() if ri == po \
            else A_loc.new_zeros((nb, nb))
        blk = axis_allreduce(blk, grid, FLAT)
        LUkk, blkperm = _lu_packed(blk)
        perm[k0:k0 + nb] = perm[k0 + blkperm]
        if ri == po:
            idx = torch.from_numpy(roff + blkperm).to(dev)
            A_loc[roff:roff + nb] = A_loc[idx].clone()
        pan2 = A_loc[:, k0:k0 + nb].clone()
        A_loc = _panel_tail(A_loc, pan2, LUkk, k0, grow, gcol, ri, 0, mr, npc,
                            nb, grid, row_axis=FLAT)
    # info: first zero diagonal of U over the leading npc rows
    on = grow[:, None] == gcol[None, :]
    drow = torch.sum(torch.where(on, A_loc, torch.zeros_like(A_loc)), dim=1)
    diag = A_loc.new_zeros((npc,))
    inr = grow < npc
    diag[grow[inr]] = drow[inr]
    diag = axis_allreduce(diag, grid, FLAT)
    return A_loc, perm, first_bad_index(diag == 0)


def _info(x, dev):
    return torch.as_tensor(int(x), dtype=torch.int32, device=dev)


@instrument
def getrf_tall_distributed(A, grid: ProcessGrid, nb: int = 256,
                           lu_panel: str = "tournament"):
    """1-D TSLU for tall matrices (m > n) over the flattened grid.

    Returns ``(LU, perm, info)`` with ``A[perm] = L @ U``, LU row-sharded, in
    O(m n²/P) work.  Rows are padded to P·nb blocks and columns to nb
    multiples; pad columns carry unit pivots on pad rows so they never
    disturb the real factorization."""
    m, n = A.shape[-2:]
    slate_assert(m >= n, "getrf_tall_distributed expects m >= n")
    slate_assert(lu_panel in ("tournament", "pp"),
                 f"lu_panel must be 'tournament' or 'pp', got {lu_panel!r}")
    nb = max(1, min(nb, n))
    unit = nb * grid.p * grid.q
    npc = ceil_mult(n, nb)
    mpad = ceil_mult(m, unit)
    if mpad - m < npc - n:       # need a pad row per pad column
        mpad += unit
    a = gather(A) if (mpad, npc) != (m, n) else A
    if (mpad, npc) != (m, n):
        full = a.new_zeros((mpad, npc))
        full[:m, :n] = a
        if npc > n:              # unit pivots for pad columns, on pad rows
            full[m + torch.arange(npc - n), n + torch.arange(npc - n)] = 1
        a = full
    A_loc = local_block(a, grid, (mpad, npc), layout=ROWS)
    LU_loc, perm, info = _getrf_tall_local(A_loc, grid, mpad, npc, nb, lu_panel)
    info = int(info)
    if mpad > m:
        # each pad column swaps one pad row into the head; repair the perm and
        # take the displaced real rows' L from where they now sit
        LU = gather(wrap(LU_loc, grid, (mpad, npc), ROWS))
        head = perm[:m]
        bad = head >= m
        tail = perm[m:]
        key = np.where(tail < m, tail, mpad)
        order = np.argsort(key, kind="stable")
        cum = np.cumsum(bad) - 1
        repl = np.sort(key)[np.clip(cum, 0, key.shape[0] - 1)]
        srcpos = (m + order)[np.clip(cum, 0, order.shape[0] - 1)]
        perm = np.where(bad, repl, head)
        rows = np.where(bad, np.clip(srcpos, 0, mpad - 1), np.arange(m))
        LUm = LU[torch.from_numpy(rows).to(LU.device), :n]
        info = 0 if info > n else info
        out = wrap(local_block(LUm, grid, (m, n), layout=ROWS), grid, (m, n), ROWS)
    else:
        perm = perm[:m]
        info = 0 if info > n else info
        out = trim(LU_loc, grid, (mpad, npc), (m, n), ROWS)
    dev = LU_loc.device
    return out, torch.from_numpy(perm.astype(np.int64)).to(dev), _info(info, dev)


@instrument
def getrf_distributed(A, grid: ProcessGrid, nb: int = 256,
                      lu_panel: str = "tournament"):
    """Distributed tournament-pivoted LU over the process grid.

    Returns ``(LU, perm, info)`` with ``A[perm] = L @ U`` (L unit-lower, U
    upper, packed, in the block layout); ``perm`` (int64) and ``info`` are the
    same on every rank.  ``lu_panel`` ("tournament" | "pp") selects the panel
    pivoting.  Tall inputs route to :func:`getrf_tall_distributed`; wide
    inputs factor the leading m×m block and finish the trailing columns with
    one sharded unit-lower solve, U[:, m:] = L^{-1} (P A)[:, m:]."""
    m, n = A.shape[-2:]
    slate_assert(A.ndim == 2, "getrf_distributed expects a 2-D matrix")
    slate_assert(lu_panel in ("tournament", "pp"),
                 f"lu_panel must be 'tournament' or 'pp', got {lu_panel!r}")
    if m > n:
        return getrf_tall_distributed(A, grid, nb=nb, lu_panel=lu_panel)
    if m < n:
        from .solvers import trsm_distributed

        a = gather(A)
        LU1, perm, info = getrf_distributed(a[:, :m], grid, nb=nb, lu_panel=lu_panel)
        lu1 = gather(LU1)
        L = torch.tril(lu1, -1) + torch.eye(m, dtype=lu1.dtype, device=lu1.device)
        U2 = gather(trsm_distributed(L, a[:, m:][perm], grid, lower=True))
        full = torch.cat([lu1, U2], dim=1)
        return wrap(local_block(full, grid), grid, (m, n)), perm, info
    nb = max(1, min(nb, n))
    unit = nb * lcm(grid.p, grid.q)
    npad = ceil_mult(m, unit)
    A_loc = local_block(A, grid, (npad, npad), eye_from=n if npad > n else None)
    nbe = min(nb, npad)
    LU_loc, perm, info = _getrf_local(A_loc, grid, npad, nbe, lu_panel)
    info = int(info)
    if npad > m:
        # pad rows never win against real rows — except in an exactly singular
        # trailing block, where a zero pad row can tie.  Keep the truncated
        # perm a permutation of [0, m) and do not silence a real failure.
        head = perm[:m]
        bad = head >= m
        tail = perm[m:]
        repl = np.sort(np.where(tail < m, tail, npad))
        perm = np.where(bad, repl[np.clip(np.cumsum(bad) - 1, 0, None)], head)
        fallback = int(np.argmax(bad)) + 1 if bad.any() else 0
        info = fallback if info > n else info
    else:
        perm = perm[:m]
        info = 0 if info > n else info
    dev = LU_loc.device
    return (trim(LU_loc, grid, (npad, npad), (m, n)),
            torch.from_numpy(np.ascontiguousarray(perm).astype(np.int64)).to(dev),
            _info(info, dev))


def _lu_factors_local(LU, grid, n, npad):
    """Shards of the unit-lower L and upper U of a packed LU, padded to npad
    with identity tails."""
    from .solvers import _tril_local, _triu_local

    lu = local_block(LU, grid, (npad, npad), eye_from=n if npad > n else None)
    from .distribute import global_index

    rows, cols = global_index(grid, npad, npad, device=lu.device)
    L = torch.where(rows == cols, torch.ones_like(lu), _tril_local(lu, grid, npad, -1))
    U = _triu_local(lu, grid, npad)
    return L, U


@instrument
def getrs_distributed(LU, perm, B, grid: ProcessGrid):
    """Solve A X = B given the distributed LU: X = U^{-1} L^{-1} B[perm]
    (src/getrs.cc: permuteRows + two work::trsm sweeps)."""
    from .solvers import _trsm_local

    b = gather(B)
    n, nrhs = b.shape[-2:]
    bp = b[torch.as_tensor(perm, dtype=torch.int64, device=b.device)]
    npad = ceil_mult(n, lcm(grid.p, grid.q))
    cpad = ceil_mult(nrhs, grid.q)
    L, U = _lu_factors_local(LU, grid, n, npad)
    Bl = local_block(bp, grid, (npad, cpad)).to(L.dtype)
    Y = _trsm_local(L, Bl, grid, npad, cpad, lower=True, conj_trans=False,
                    unit_diag=True)
    X = _trsm_local(U, Y, grid, npad, cpad, lower=False, conj_trans=False)
    return trim(X, grid, (npad, cpad), (n, nrhs))


@instrument
def gesv_distributed(A, B, grid: ProcessGrid, nb: int = 256,
                     lu_panel: str = "tournament"):
    """Distributed general solve A X = B (src/gesv.cc = getrf + getrs), under
    the failed-shard guard (robust.guard_shards).  Returns ``(X, info)``."""
    state = {}

    def run():
        LU, perm, info = getrf_distributed(inject("gesv_distributed", A), grid,
                                           nb=nb, lu_panel=lu_panel)
        state["info"] = info
        return getrs_distributed(LU, perm, B, grid)

    X, _ = guard_shards("gesv_distributed", run, RetryPolicy(max_retries=1))
    return X, state["info"]


@instrument
def gesv_mixed_distributed(A, B, grid: ProcessGrid, nb: int = 256,
                           max_iterations: int = 30):
    """Distributed mixed-precision solve (src/gesv_mixed.cc over the grid):
    factor one precision down (f64->f32, c128->c64), refine at working
    precision, full-precision sharded fallback when IR stalls.
    Returns (X, perm, info, iters, converged_via_ir)."""
    from .eig_dist import _shard
    from .solvers import _cast, _ir_refine_distributed, _lower_dtype

    lo = _lower_dtype(A.dtype)
    if lo is None:
        LU, perm, info = getrf_distributed(A, grid, nb=nb)
        return getrs_distributed(LU, perm, B, grid), perm, info, 0, True
    LU, perm, info = getrf_distributed(_cast(A, lo), grid, nb=nb)

    def solve_lo(R):
        return getrs_distributed(LU, perm, R.to(lo), grid)

    X, iters, ok = _ir_refine_distributed(A, B, solve_lo, grid, max_iterations)
    if not ok:
        # mixed→full ladder (robust.LADDERS["gesv_mixed_distributed"])
        trace_event("fallback", routine="gesv_mixed_distributed", to="full")
        LU, perm, info = getrf_distributed(A, grid, nb=nb)
        return getrs_distributed(LU, perm, B, grid), perm, info, int(iters), False
    return _shard(X, grid), perm, info, int(iters), True


@instrument
def gesv_mixed_gmres_distributed(A, B, grid: ProcessGrid, nb: int = 256,
                                 opts=None):
    """Distributed GMRES-IR (src/gesv_mixed_gmres.cc over the grid): FGMRES in
    working precision with sharded matvecs, right-preconditioned by the
    low-precision tournament-LU solve.  Single-RHS like the reference.
    Returns (X, perm, info, restarts, converged)."""
    from ..core.matrix import torch_dtype
    from ..core.types import Options
    from ..linalg.lu import _gmres_ir, _require_single_rhs
    from .solvers import _cast, _lower_dtype, _matvec_rows

    opts = Options.make(opts)
    b = gather(B)
    _require_single_rhs(b, "gesv_mixed_gmres_distributed")
    vec = b.ndim == 1
    B2 = b[:, None] if vec else b

    def fallback():
        LUf, permf, infof = getrf_distributed(A, grid, nb=nb)
        Xf = gather(getrs_distributed(LUf, permf, B2, grid))
        return (Xf[:, 0] if vec else Xf), permf, infof

    lo = opts.factor_precision or _lower_dtype(A.dtype)
    if lo is None:
        Xf, permf, infof = fallback()
        return Xf, permf, infof, 0, True
    lo = torch_dtype(lo)
    LU, perm, info = getrf_distributed(_cast(A, lo), grid, nb=nb)
    n = A.shape[-1]
    a_loc = local_block(A, grid)

    def matvec(x):
        return _matvec_rows(a_loc, grid, n, n, x[:, None])[:, 0]

    def precond(r):
        z = getrs_distributed(LU, perm, r.to(lo)[:, None], grid)
        return gather(z)[:, 0].to(b.dtype)

    X, restarts, converged = _gmres_ir(matvec, precond, b, opts,
                                       "gesv_mixed_gmres_distributed")
    if not converged:
        if not opts.use_fallback_solver:
            return X, perm, info, int(restarts), False
        trace_event("fallback", routine="gesv_mixed_gmres_distributed", to="full")
        Xf, permf, infof = fallback()
        return Xf, permf, infof, int(restarts), False
    return X, perm, info, int(restarts), True
