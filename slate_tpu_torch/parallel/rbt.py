"""Distributed random-butterfly solver: gerbt + nopiv LU + IR over the grid.

Reference analogue: ``src/gesv_rbt.cc:94-172`` — apply a depth-d two-sided
random butterfly transform (``src/gerbt.cc``), factor the transformed matrix
*without pivoting* (``src/getrf_nopiv.cc``) and refine in working precision.

* The butterfly applies are elementwise mixes of row (and column) pairs
  (i, i+h).  Each rank applies them to the whole operand it was handed (no
  communication, O(depth·n²) flops) and keeps its shard of the result; a
  distributed operand is gathered first.
* The nopiv LU is the tournament pipeline minus the tournament
  (``lu_dist._panel_tail``): panel sum along q, diagonal block along p, U row
  band along p, local trailing gemm.
* Refinement reuses the distributed IR loop
  (``solvers._ir_refine_distributed``) with the sharded full-precision
  pivoted solve as fallback (gesv_rbt.cc's refinement + fallback contract).
"""

from __future__ import annotations

import torch

from ..core.exceptions import slate_assert
from ..obs import instrument
from .collectives import axis_allreduce
from .distribute import ceil_mult, gather, lcm, local_block, trim as _trim, wrap
from .mesh import COL_AXIS, ProcessGrid, ROW_AXIS


def _getrf_nopiv_local(A_loc, grid, npad, nb):
    from ..linalg.lu import _lu_nopiv_blocked
    from .lu_dist import _lu_diag_info, _panel_tail

    p, q = grid.p, grid.q
    mr, mc = npad // p, npad // q
    pi, qi = grid.my_coords
    dev = A_loc.device
    grow = pi * mr + torch.arange(mr, device=dev)
    gcol = qi * mc + torch.arange(mc, device=dev)
    for k0 in range(0, npad, nb):
        qo, off = k0 // mc, k0 % mc
        pan = A_loc[:, off:off + nb].clone() if qi == qo else A_loc.new_zeros((mr, nb))
        pan = axis_allreduce(pan, grid, COL_AXIS)
        po, roff = k0 // mr, k0 % mr
        blk = pan[roff:roff + nb].clone() if pi == po else pan.new_zeros((nb, nb))
        LUkk = _lu_nopiv_blocked(axis_allreduce(blk, grid, ROW_AXIS))
        A_loc = _panel_tail(A_loc, pan, LUkk, k0, grow, gcol, pi, qi, mr, mc, nb, grid)
    return A_loc, _lu_diag_info(A_loc, grow, gcol, npad, grid)


@instrument
def getrf_nopiv_distributed(A, grid: ProcessGrid, nb: int = 256, trim: bool = True):
    """Distributed LU without pivoting (src/getrf_nopiv.cc over the grid).

    Returns ``(LU, info)``; info = 1-based index of the first zero U diagonal
    (breakdown), 0 on success.  Identity-tail padding to shard boundaries;
    ``trim=False`` returns the factor at its padded size."""
    n = A.shape[-1]
    slate_assert(A.ndim == 2 and A.shape[0] == n,
                 "getrf_nopiv_distributed expects a square matrix")
    nb = max(1, min(nb, n))
    npad = ceil_mult(n, nb * lcm(grid.p, grid.q))
    a = local_block(A, grid, (npad, npad), eye_from=n if npad > n else None)
    LU, info = _getrf_nopiv_local(a, grid, npad, min(nb, npad))
    info = info if int(info) <= n else torch.zeros_like(info)  # pad diag is never 0
    if not trim:
        return wrap(LU, grid, (npad, npad)), info
    return _trim(LU, grid, (npad, npad), (n, n)), info


@instrument
def gesv_rbt_distributed(A, B, grid: ProcessGrid, depth: int = 2, nb: int = 256,
                         key=None, max_iterations: int = 30,
                         use_fallback: bool = True, tol=None):
    """Distributed solve via random butterfly transform + nopiv LU +
    refinement (src/gesv_rbt.cc:94-172 over the grid).

    Returns ``(X, info, iters, via_rbt)``: info from the nopiv factor, iters
    from the IR loop; on IR stall the sharded pivoted solve takes over
    (Option::UseFallbackSolver) and ``via_rbt`` is False.  ``key`` is a
    ``torch.Generator`` (default: seed 42 on the operand's device)."""
    from ..linalg.lu import _butterfly_apply, _two_sided, rbt_generate
    from .lu_dist import _lu_factors_local, gesv_distributed
    from .eig_dist import _shard
    from .solvers import _ir_refine_distributed, _trsm_local

    a = gather(A)
    b = gather(B)
    n = a.shape[-1]
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if key is None:
        key = torch.Generator(device=a.device).manual_seed(42)
    np_ = ceil_mult(n, 2 ** depth)
    Wu = rbt_generate(key, np_, depth, a.dtype).to(a.device)
    Wv = rbt_generate(key, np_, depth, a.dtype).to(a.device)
    ap = a.new_zeros((np_, np_))
    ap[:n, :n] = a
    if np_ > n:
        ap[n:, n:].diagonal().fill_(1)
    at = _two_sided(Wu, Wv, ap)
    LUp, info = getrf_nopiv_distributed(at, grid, nb=nb, trim=False)
    npad2 = LUp.shape[-1]
    L, U = _lu_factors_local(LUp, grid, npad2, npad2)
    nrhs = b2.shape[-1]
    cpad = ceil_mult(max(nrhs, 1), grid.q)

    def solve_lo(R):                      # R: (n, nrhs) working precision
        rp = torch.zeros((np_, cpad), dtype=R.dtype, device=R.device)
        rp[:n, :nrhs] = R
        y = _butterfly_apply(Wu, rp, transpose=True)
        y = torch.cat([y, y.new_zeros((npad2 - np_, cpad))]) if npad2 > np_ else y
        yl = local_block(y, grid, (npad2, cpad)).to(L.dtype)
        z = _trsm_local(L, yl, grid, npad2, cpad, lower=True, conj_trans=False,
                        unit_diag=True)
        w = gather(wrap(_trsm_local(U, z, grid, npad2, cpad, lower=False,
                                    conj_trans=False), grid, (npad2, cpad)))
        return _butterfly_apply(Wv, w[:np_], transpose=False)[:n, :nrhs]

    X, iters, ok = _ir_refine_distributed(a, b2, solve_lo, grid, max_iterations,
                                          tol=tol)
    via_rbt = bool(ok)
    X = _shard(X, grid)
    if use_fallback and not via_rbt:
        # rbt→partialpiv ladder (robust.LADDERS["gesv_rbt_distributed"])
        from ..utils.trace import trace_event

        trace_event("fallback", routine="gesv_rbt_distributed", to="partialpiv")
        X, info = gesv_distributed(a, b2, grid, nb=nb)
    if vec:
        X = gather(X)[:, 0]
    return X, info, iters, via_rbt
