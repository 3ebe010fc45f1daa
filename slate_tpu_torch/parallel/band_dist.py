"""Distributed band factorizations and solves over the process grid.

Reference analogues: ``src/pbtrf.cc:22-200`` (distributed band Cholesky),
``src/gbtrf.cc`` (distributed band LU, pivoting confined to the kl window),
``src/tbsm.cc`` (distributed banded triangular solve, with and without pivot
replay), ``src/pbtrs.cc`` / ``src/gbtrs.cc`` / ``src/pbsv.cc`` /
``src/gbsv.cc``.

Design, after the JAX package's:

- **Compact band storage, sharded by columns.**  The lower band is stored
  LAPACK-style (``Ab[j, i] = A[i+j, i]``) and spread over the flattened grid
  in the column layout (``distribute.COLS``), so each rank holds
  O((kd+1)·n/P) elements; a right-hand side is spread the same way by rows.
- **Each diagonal window rides one masked sum.**  A band factorization is a
  chain of small diagonal windows.  Per window, the ranks owning its columns
  contribute them and one all-reduce puts the (kd+1)×w window on every rank;
  every rank factors it (w ≪ n, cheaper than shipping factors) and keeps
  only its own columns of the result.  The same masked sums move the
  right-hand side's window rows in the solves.
- **Pivoting stays in the window** (gbtrf): partial pivoting of a band
  matrix cannot leave the kl window, so each window's permutation is a
  (wr,)-vector every rank computes itself from the same window; it never
  travels and stays on the rank's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.exceptions import slate_assert
from ..obs import instrument
from .collectives import axis_allreduce, axis_index
from .distribute import COLS, ROWS, ceil_mult, local_block, trim
from .mesh import FLAT, ProcessGrid

AX = FLAT


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _band_lu_geometry(n: int, kl: int, ku: int, nb: int, nprocs: int):
    """Window and padding geometry shared by the band-LU factor and its
    solves: (wr, wc, nd, npad) — window rows and columns, factored-form
    storage depth, and the padded problem size."""
    klt = max(1, _ceil_div(kl, nb))
    kut = max(1, _ceil_div(ku, nb))
    wr = (klt + 1) * nb
    wc = (klt + kut + 1) * nb
    nd = wr + kl + ku
    unit = nb * nprocs
    npad = ceil_mult(max(n + wc, unit), unit)
    return wr, wc, nd, npad


def _chol_geometry(n: int, kd: int, nb: int, nprocs: int):
    """(w, npad): the band Cholesky's window and padded size (room for the
    last window)."""
    w = (max(1, _ceil_div(kd, nb)) + 1) * nb
    unit = nb * nprocs
    return w, ceil_mult(max(n + w, unit), unit)


def dense_to_band_lower(A, kd: int):
    """Compact lower band: ``Ab[j, i] = A[i+j, i]``, zero beyond the edge."""
    n = A.shape[-1]
    j = torch.arange(kd + 1, device=A.device)[:, None]
    i = torch.arange(n, device=A.device)[None, :]
    vals = A[(i + j).clamp(0, n - 1), i.expand(kd + 1, n)]
    return torch.where(i + j < n, vals, torch.zeros((), dtype=A.dtype, device=A.device))


def band_lower_to_dense(Ab, n: int):
    """Inverse of :func:`dense_to_band_lower`."""
    kd = Ab.shape[0] - 1
    r = torch.arange(n, device=Ab.device)[:, None]
    c = torch.arange(n, device=Ab.device)[None, :]
    j = r - c
    ok = (j >= 0) & (j <= kd)
    return torch.where(ok, Ab[j.clamp(0, kd), c.expand(n, n)],
                       torch.zeros((), dtype=Ab.dtype, device=Ab.device))


def dense_to_band_general(A, kl: int, ku: int, extra: int = 0):
    """Compact general band with ``extra`` superdiagonal fill rows: row j
    holds diagonal j - ku - extra, ``Gb[j, i] = A[i + j - ku - extra, i]``."""
    n = A.shape[-1]
    nd = kl + ku + extra + 1
    j = torch.arange(nd, device=A.device)[:, None]
    i = torch.arange(n, device=A.device)[None, :]
    r = i + j - ku - extra
    ok = (r >= 0) & (r < n)
    return torch.where(ok, A[r.clamp(0, n - 1), i.expand(nd, n)],
                       torch.zeros((), dtype=A.dtype, device=A.device))


def band_general_to_dense(Gb, n: int, kl: int, ku: int, extra: int = 0):
    """Inverse of :func:`dense_to_band_general`."""
    nd = Gb.shape[0]
    slate_assert(nd == kl + ku + extra + 1, "band_general_to_dense: storage depth "
                 f"{nd} != kl + ku + extra + 1")
    r = torch.arange(n, device=Gb.device)[:, None]
    c = torch.arange(n, device=Gb.device)[None, :]
    j = r - c + ku + extra
    ok = (j >= 0) & (j < nd)
    return torch.where(ok, Gb[j.clamp(0, nd - 1), c.expand(n, n)],
                       torch.zeros((), dtype=Gb.dtype, device=Gb.device))


def _compact_of(A, grid: ProcessGrid, kl: int, ku: int, extra: int = 0):
    """``dense_to_band_general(A, kl, ku, extra)`` of a square operand, whole
    on every rank.  A block-layout DTensor is never gathered: each rank fills
    the band entries its block holds and one masked sum of O(n·(kl+ku))
    assembles the compact storage."""
    from .distribute import BLOCK, bounds, is_dist, layout_of

    if not is_dist(A) or layout_of(A) != BLOCK:
        from .distribute import gather

        return dense_to_band_general(gather(A), kl, ku, extra)
    n = A.shape[-1]
    loc = A.to_local()
    (r0, r1), (c0, c1) = bounds(grid, n, n)
    nd = kl + ku + extra + 1
    dev = loc.device
    j = torch.arange(nd, device=dev)[:, None]
    i = torch.arange(c0, c1, device=dev)[None, :]
    r = i + j - ku - extra
    own = (r >= r0) & (r < r1)
    out = loc.new_zeros((nd, n))
    if loc.numel():
        vals = loc[(r - r0).clamp(0, max(r1 - r0 - 1, 0)), (i - c0).expand(nd, c1 - c0)]
        out[:, c0:c1] = torch.where(own, vals, torch.zeros((), dtype=loc.dtype, device=dev))
    return axis_allreduce(out, grid, AX)


def _dense_of(Gb, grid: ProcessGrid, n: int, kl: int, ku: int, extra: int = 0):
    """``band_general_to_dense(Gb, n, kl, ku, extra)`` as a block-layout
    DTensor: the compact storage comes whole to every rank (O(n·depth)) and
    each rank builds its own block."""
    from .distribute import bounds, gather, wrap

    g = gather(Gb)
    (r0, r1), (c0, c1) = bounds(grid, n, n)
    nd = g.shape[0]
    r = torch.arange(r0, r1, device=g.device)[:, None]
    c = torch.arange(c0, c1, device=g.device)[None, :]
    jj = r - c + ku + extra
    ok = (jj >= 0) & (jj < nd)
    blk = torch.where(ok, g[jj.clamp(0, nd - 1), c.expand_as(jj)],
                      torch.zeros((), dtype=g.dtype, device=g.device))
    return wrap(blk, grid, (n, n))


def _expand(win, wr: int, wc: int, fill: int):
    """Dense (wr, wc) window from compact columns: row r, column c is
    diagonal r - c, storage row r - c + fill."""
    nd = win.shape[0]
    r = torch.arange(wr, device=win.device)[:, None]
    c = torch.arange(wc, device=win.device)[None, :]
    j = r - c + fill
    ok = (j >= 0) & (j < nd)
    return torch.where(ok, win[j.clamp(0, nd - 1), c.expand(wr, wc)],
                       torch.zeros((), dtype=win.dtype, device=win.device))


def _compress(dense, win_old, wr: int, fill: int):
    """Compact columns from a dense (wr, wc) window; entries whose row falls
    outside the window are later windows' and keep their old values."""
    nd, wc = win_old.shape
    jj = torch.arange(nd, device=dense.device)[:, None]
    cc = torch.arange(wc, device=dense.device)[None, :]
    rr = jj + cc - fill
    inside = (rr >= 0) & (rr < wr)
    return torch.where(inside, dense[rr.clamp(0, wr - 1), cc.expand(nd, wc)], win_old)


class _Windows:
    """The masked-sum window moves over column-sharded compact storage and
    row-sharded right-hand sides — one implementation shared by every
    windowed sweep (factor, forward, backward), as the JAX package's
    ``_window_ops``.  This rank owns global columns (rows) [c0, c0 + nc)."""

    def __init__(self, grid: ProcessGrid, npad: int):
        self.grid = grid
        self.nc = npad // grid.size
        self.c0 = axis_index(grid, AX) * self.nc

    def _overlap(self, k0: int, width: int):
        lo, hi = max(k0, self.c0), min(k0 + width, self.c0 + self.nc)
        return lo, hi

    def cols(self, X_loc, k0: int, width: int):
        """Columns [k0, k0 + width) of the compact storage on every rank."""
        win = X_loc.new_zeros((X_loc.shape[0], width))
        lo, hi = self._overlap(k0, width)
        if hi > lo:
            win[:, lo - k0:hi - k0] = X_loc[:, lo - self.c0:hi - self.c0]
        return axis_allreduce(win, self.grid, AX)

    def rows(self, B_loc, k0: int, width: int):
        """Rows [k0, k0 + width) of a row-sharded right-hand side on every rank."""
        win = B_loc.new_zeros((width,) + tuple(B_loc.shape[1:]))
        lo, hi = self._overlap(k0, width)
        if hi > lo:
            win[lo - k0:hi - k0] = B_loc[lo - self.c0:hi - self.c0]
        return axis_allreduce(win, self.grid, AX)

    def put_cols(self, X_loc, vals, k0: int, width: int) -> None:
        lo, hi = self._overlap(k0, width)
        if hi > lo:
            X_loc[:, lo - self.c0:hi - self.c0] = vals[:, lo - k0:hi - k0]

    def put_rows(self, B_loc, vals, k0: int, width: int) -> None:
        lo, hi = self._overlap(k0, width)
        if hi > lo:
            B_loc[lo - self.c0:hi - self.c0] = vals[lo - k0:hi - k0]


def _cols_operand(X, grid: ProcessGrid, rows: int, npad: int, unit_row: int):
    """This rank's columns of compact storage padded to npad, with ones in
    storage row ``unit_row`` of the padded columns (an identity tail)."""
    n = X.shape[-1]
    x = local_block(X, grid, (rows, npad), layout=COLS)
    nc = npad // grid.size
    c0 = axis_index(grid, AX) * nc
    lo = max(n, c0)
    if c0 + nc > lo:
        x[unit_row, lo - c0:] = 1
    return x


def _rhs(B, grid: ProcessGrid, npad: int):
    """(my rows of B padded to npad, vec, n, nrhs) for a vector or matrix B."""
    vec = B.ndim == 1
    B2 = B[:, None] if vec else B
    n, nrhs = B2.shape
    return local_block(B2, grid, (npad, nrhs), layout=ROWS), vec, n, nrhs


def _rhs_out(X_loc, grid: ProcessGrid, npad: int, n: int, nrhs: int, vec: bool):
    X = trim(X_loc, grid, (npad, nrhs), (n, nrhs), ROWS)
    if vec:
        from .distribute import gather

        return gather(X)[:, 0]
    return X


def _first_bad(bad_loc: torch.Tensor, c0: int, grid: ProcessGrid) -> torch.Tensor:
    """LAPACK info from each rank's columns: 1 + the first bad column over
    the grid (one all-reduce), or 0."""
    big = torch.iinfo(torch.int64).max
    idx = torch.nonzero(bad_loc)
    first = torch.full((), big, dtype=torch.int64, device=bad_loc.device)
    if idx.numel():
        first = (idx[0, 0] + c0 + 1).to(torch.int64)
    first = axis_allreduce(first, grid, AX, "min")
    return torch.where(first == big, torch.zeros_like(first), first).to(torch.int32)


@instrument
def pbtrf_distributed(Ab, grid: ProcessGrid, kd: int, nb: int = 256):
    """Distributed band Cholesky on compact lower storage (src/pbtrf.cc).

    ``Ab`` is (kd+1, n) with ``Ab[j, i] = A[i+j, i]`` (a column-layout
    DTensor, or a tensor the same on every rank).  Returns ``(Lb, info)``:
    Lb in the same compact form and the column layout.  Memory
    O((kd+1)·n/P) per rank; one masked sum of (kd+1)×w per window."""
    from ..linalg.chol import _cholesky

    slate_assert(Ab.ndim == 2 and Ab.shape[0] == kd + 1,
                 "pbtrf_distributed expects compact (kd+1, n) lower band")
    n = Ab.shape[1]
    nb = max(1, min(nb, n))
    w, npad = _chol_geometry(n, kd, nb, grid.size)
    x = _cols_operand(Ab, grid, kd + 1, npad, 0)
    win_ops = _Windows(grid, npad)
    for k0 in range(0, npad, nb):
        win = win_ops.cols(x, k0, w)
        dense = _expand(win, w, w, 0)
        lkk = torch.tril(_cholesky(dense[:nb, :nb]))
        panel = torch.linalg.solve_triangular(lkk.mH, dense[nb:, :nb], upper=True,
                                              left=False)
        trail = dense[nb:, nb:] - torch.matmul(panel, panel.mH)
        dense[:nb, :nb] = lkk
        dense[nb:, :nb] = panel
        dense[nb:, nb:] = torch.tril(trail)
        win_ops.put_cols(x, _compress(dense, win, w, 0), k0, w)
    d = x[0].real
    info = _first_bad(~(torch.isfinite(d) & (d > 0)), win_ops.c0, grid)
    return trim(x, grid, (kd + 1, npad), (kd + 1, n), COLS), info


def _tbsm_local(Lx, B_loc, win_ops: _Windows, npad: int, kd: int, nb: int,
                trans: bool, unit: bool):
    """Windowed block substitution with the compact lower factor: L x = b
    forward, or Lᴴ x = b backward (two masked sums per window)."""
    w = (max(1, _ceil_div(kd, nb)) + 1) * nb
    steps = range(0, npad, nb)
    for k0 in (reversed(steps) if trans else steps):
        dense = _expand(win_ops.cols(Lx, k0, w), w, w, 0)
        bwin = win_ops.rows(B_loc, k0, w)
        if not trans:
            xk = torch.linalg.solve_triangular(dense[:nb, :nb], bwin[:nb], upper=False,
                                               unitriangular=unit)
            rest = bwin[nb:] - torch.matmul(dense[nb:, :nb], xk)
            win_ops.put_rows(B_loc, torch.cat([xk, rest]), k0, w)
        else:
            rhs = bwin[:nb] - torch.matmul(dense[nb:, :nb].mH, bwin[nb:])
            xk = torch.linalg.solve_triangular(dense[:nb, :nb].mH, rhs, upper=True,
                                               unitriangular=unit)
            win_ops.put_rows(B_loc, xk, k0, nb)
    return B_loc


@instrument
def tbsm_distributed(Lb, B, grid: ProcessGrid, kd: int, nb: int = 256,
                     trans: bool = False, unit_diagonal: bool = False):
    """Distributed banded triangular solve (src/tbsm.cc): L x = b, or Lᴴ x = b
    with ``trans``, on compact lower storage.  X comes back in the row layout
    (a vector B: a vector, the same on every rank)."""
    slate_assert(Lb.ndim == 2 and Lb.shape[0] == kd + 1,
                 "tbsm_distributed expects compact (kd+1, n) lower band")
    n = Lb.shape[1]
    nb = max(1, min(nb, n))
    _, npad = _chol_geometry(n, kd, nb, grid.size)
    Lx = _cols_operand(Lb, grid, kd + 1, npad, 0)
    b, vec, n, nrhs = _rhs(B, grid, npad)
    b = b.to(Lx.dtype)
    X = _tbsm_local(Lx, b, _Windows(grid, npad), npad, kd, nb, trans, unit_diagonal)
    return _rhs_out(X, grid, npad, n, nrhs, vec)


@instrument
def pbtrs_distributed(Lb, B, grid: ProcessGrid, kd: int, nb: int = 256):
    """Solve L Lᴴ X = B from the distributed band factor (src/pbtrs.cc)."""
    slate_assert(Lb.ndim == 2 and Lb.shape[0] == kd + 1,
                 "pbtrs_distributed expects compact (kd+1, n) lower band")
    n = Lb.shape[1]
    nb = max(1, min(nb, n))
    _, npad = _chol_geometry(n, kd, nb, grid.size)
    Lx = _cols_operand(Lb, grid, kd + 1, npad, 0)
    b, vec, n, nrhs = _rhs(B, grid, npad)
    ops = _Windows(grid, npad)
    y = _tbsm_local(Lx, b.to(Lx.dtype), ops, npad, kd, nb, False, False)
    x = _tbsm_local(Lx, y, ops, npad, kd, nb, True, False)
    return _rhs_out(x, grid, npad, n, nrhs, vec)


@instrument
def pbsv_distributed(Ab, B, grid: ProcessGrid, kd: int, nb: int = 256):
    """Distributed SPD band solve (src/pbsv.cc = pbtrf + pbtrs)."""
    Lb, info = pbtrf_distributed(Ab, grid, kd, nb=nb)
    return pbtrs_distributed(Lb, B, grid, kd, nb=nb), info


# ---------------------------------------------------------------------------
# band LU (gbtrf / gbtrs / gbsv)
# ---------------------------------------------------------------------------


class BandLUDist(NamedTuple):
    """Distributed band LU factored form: compact factored storage (row j =
    diagonal j - kl - ku; wr - 1 rows below the diagonal, for the window
    multipliers) in the column layout, and the per-window permutations, the
    same on every rank (the window-local Pivots).  ``npad`` records the
    padded size the factor ran at, so the solves replay its windows."""
    lub: object          # (wr + kl + ku, n) compact factored form
    perms: torch.Tensor  # (nt, wr) window permutations
    kl: int
    ku: int
    nb: int
    npad: int


@instrument
def gbtrf_distributed(Gb, grid: ProcessGrid, kl: int, ku: int, nb: int = 256):
    """Distributed band LU (src/gbtrf.cc) on compact storage with kl fill
    rows: input (2kl+ku+1, n) where row j holds diagonal j - kl - ku (the
    LAPACK gb layout: ``dense_to_band_general(A, kl, ku, extra=kl)``).
    Per window: one masked sum, the window's partially pivoted LU, a row
    trsm and the trailing gemm on every rank.  Returns
    ``(BandLUDist, info)``."""
    from ..linalg.lu import _device_perm, _lu_factor

    nd_in = 2 * kl + ku + 1
    slate_assert(Gb.ndim == 2 and Gb.shape[0] == nd_in,
                 "gbtrf_distributed expects compact (2kl+ku+1, n) storage")
    n = Gb.shape[1]
    nb = max(1, min(nb, n))
    wr, wc, nd, npad = _band_lu_geometry(n, kl, ku, nb, grid.size)
    fill = kl + ku
    x = _cols_operand(Gb, grid, nd, npad, fill)
    ops = _Windows(grid, npad)
    nt = npad // nb
    perms = torch.zeros((nt, wr), dtype=torch.int64, device=x.device)
    for k in range(nt):
        k0 = k * nb
        win = ops.cols(x, k0, wc)
        dense = _expand(win, wr, wc, fill)
        plu, piv = _lu_factor(dense[:, :nb])
        pperm = _device_perm(plu, piv)
        dense = dense[pperm]
        dense[:, :nb] = plu
        rest = torch.linalg.solve_triangular(plu[:nb], dense[:nb, nb:], upper=False,
                                             unitriangular=True)
        dense[:nb, nb:] = rest
        dense[nb:, nb:] -= torch.matmul(plu[nb:, :nb], rest)
        ops.put_cols(x, _compress(dense, win, wr, fill), k0, wc)
        perms[k] = pperm
    diag = x[fill]
    info = _first_bad(~torch.isfinite(diag) | (diag == 0), ops.c0, grid)
    lub = trim(x, grid, (nd, npad), (nd, n), COLS)
    return BandLUDist(lub, perms, kl, ku, nb, npad), info


@instrument
def gbtrs_distributed(fac: BandLUDist, B, grid: ProcessGrid):
    """Solve from the distributed band LU (src/gbtrs.cc): the forward sweep
    with each window's permutation replayed on the right-hand side rows (tbsm
    with Pivots), then the banded backward sweep with U (bandwidth kl+ku),
    both windowed over the grid."""
    lub, perms, kl, ku, nb, npad = fac
    n = lub.shape[1]
    wr, wc, nd, npad_geom = _band_lu_geometry(n, kl, ku, nb, grid.size)
    slate_assert(npad == npad_geom,
                 "band LU factor was built on a different grid size; "
                 "re-factor on this grid")
    fill = kl + ku
    x = _cols_operand(lub, grid, nd, npad, fill)
    b, vec, n, nrhs = _rhs(B, grid, npad)
    b = b.to(x.dtype)
    ops = _Windows(grid, npad)
    nt = npad // nb
    for k in range(nt):                    # forward, with the window pivots
        k0 = k * nb
        Lpan = _expand(ops.cols(x, k0, nb), wr, nb, fill)
        bwin = ops.rows(b, k0, wr)[perms[k]]
        xk = torch.linalg.solve_triangular(Lpan[:nb], bwin[:nb], upper=False,
                                           unitriangular=True)
        rest = bwin[nb:] - torch.matmul(Lpan[nb:], xk)
        ops.put_rows(b, torch.cat([xk, rest]), k0, wr)
    for k in range(nt - 1, -1, -1):        # backward with U
        k0 = k * nb
        Urows = _expand(ops.cols(x, k0, wc), nb, wc, fill)
        bwin = ops.rows(b, k0, wc)
        rhs = bwin[:nb] - torch.matmul(Urows[:, nb:], bwin[nb:])
        xk = torch.linalg.solve_triangular(Urows[:, :nb], rhs, upper=True)
        ops.put_rows(b, xk, k0, nb)
    return _rhs_out(b, grid, npad, n, nrhs, vec)


@instrument
def gbsv_distributed(Gb, B, grid: ProcessGrid, kl: int, ku: int, nb: int = 256):
    """Distributed general band solve (src/gbsv.cc = gbtrf + gbtrs)."""
    fac, info = gbtrf_distributed(Gb, grid, kl, ku, nb=nb)
    return gbtrs_distributed(fac, B, grid), info
