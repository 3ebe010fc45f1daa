"""Band matrix drivers: gbmm/hbmm/tbsm multiplies and solves, band LU
(gbtrf/gbtrs/gbsv) and band Cholesky (pbtrf/pbtrs/pbsv).

Reference analogue: ``src/{gbmm,hbmm,tbsm,tbsmPivots}.cc`` and the band solvers
``src/{gbtrf,gbtrs,gbsv,pbtrf,pbtrs,pbsv}.cc``.

The JAX package's design carries over: storage is a dense tensor with (kl, ku)
metadata, and every driver's compute is windowed — a loop over block columns
whose body touches only an O(band) window around the diagonal, so the flops
are the band's, O(n·band²).  Matrices are padded to whole tiles with an
identity diagonal so edge windows keep their shape.  ``gbtrf`` pivots within
the band (pivot rows within kl of the diagonal), U's bandwidth grows to
kl+ku, and L stays as per-panel permuted elementary transforms that the
forward solve applies (tbsmPivots).  The JAX package's ``lax.fori_loop``
bodies run as Python loops over block columns: n/nb steps of a few library
calls each (panel LU or Cholesky, triangular solve, gemm).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.exceptions import SlateError, slate_assert
from ..core.matrix import (BaseBandMatrix, as_array, dist_operand, distribution_grid,
                           write_back)
from ..core.types import Diag, Options, Side, Uplo
from ..robust import first_bad_index
from ..utils.trace import trace_block
from .chol import _cholesky
from .lu import _device_perm, _lu_factor, _lu_info

__all__ = [
    "gbmm", "hbmm", "tbsm", "gbtrf", "gbtrs", "gbsv", "pbtrf", "pbtrs", "pbsv",
    "BandLU",
]


def _band_meta(A, kl, ku):
    """Resolve (tensor, kl, ku) from a Band wrapper or explicit keywords."""
    if isinstance(A, BaseBandMatrix):
        return A.array, A.kl, A.ku
    a = as_array(A)
    slate_assert(kl is not None and ku is not None,
                 "band routines need a Band matrix or explicit kl=/ku=")
    return a, int(kl), int(ku)


def _band_mask(m, n, kl, ku, device):
    r = torch.arange(m, device=device)[:, None]
    c = torch.arange(n, device=device)[None, :]
    return (c - r <= ku) & (r - c <= kl)


def _masked(a, kl, ku):
    """a with the entries outside the (kl, ku) band set to zero."""
    m, n = a.shape[-2:]
    return torch.where(_band_mask(m, n, kl, ku, a.device), a,
                       torch.zeros((), dtype=a.dtype, device=a.device))


def _pad_to(a, rows, cols, diag_val=0.0):
    """a padded with zeros to (rows, cols), with diag_val on the padded
    diagonal."""
    m, n = a.shape[-2:]
    out = torch.zeros((rows, cols), dtype=a.dtype, device=a.device)
    out[:m, :n] = a
    if diag_val != 0.0 and rows > m:
        idx = torch.arange(m, min(rows, cols), device=a.device)
        out[idx, idx] = diag_val
    return out


def _ceil_div(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# band matrix multiply: gbmm / hbmm
# ---------------------------------------------------------------------------


def _gbmm(alpha, a, b, beta, c, kl, ku, nb):
    """C = alpha A_band B + beta C by block diagonals: one batched matmul per
    in-band tile diagonal (src/gbmm.cc's batched gemm over in-band tiles)."""
    m, k = a.shape[-2:]
    mt, kt = _ceil_div(m, nb), _ceil_div(k, nb)
    klt, kut = _ceil_div(kl, nb), _ceil_div(ku, nb)
    mp, kp = mt * nb, kt * nb
    nrhs = b.shape[-1]
    a = _pad_to(_masked(a, kl, ku), mp, kp)
    bpad = _pad_to(b, kp, nrhs)
    abl = a.reshape(mt, nb, kt, nb).transpose(1, 2)
    bbl = bpad.reshape(kt, nb, nrhs)
    acc = torch.zeros((mt, nb, nrhs), dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    i = torch.arange(mt, device=a.device)
    for dd in range(-klt, kut + 1):
        j = i + dd
        valid = (j >= 0) & (j < kt)
        jc = j.clamp(0, kt - 1)
        contrib = torch.matmul(abl[i, jc], bbl[jc])
        acc = acc + torch.where(valid[:, None, None], contrib,
                                torch.zeros((), dtype=contrib.dtype, device=a.device))
    return alpha * acc.reshape(mp, nrhs)[:m] + beta * c


def gbmm(alpha, A, B, beta, C, opts=None, kl=None, ku=None):
    """C = alpha A B + beta C with A a general band matrix (src/gbmm.cc).
    op(A) comes through transposed BandMatrix views; raw tensors are taken
    as they are."""
    opts = Options.make(opts)
    a, kl, ku = _band_meta(A, kl, ku)
    b, c = as_array(B, device=a.device), as_array(C, device=a.device)
    m, k = a.shape[-2:]
    squeeze = b.ndim == 1
    if squeeze:
        b, c = b[:, None], c[:, None]
    nb = min(opts.block_size, m, k)
    with trace_block("gbmm", m=m, k=k, kl=kl, ku=ku):
        out = _gbmm(alpha, a, b, beta, c, kl, ku, nb)
    if squeeze:
        out = out[:, 0]
    return write_back(C, out)


def hbmm(side, alpha, A, B, beta, C, opts=None, uplo=None, kd=None):
    """C = alpha A B + beta C with A Hermitian band, one triangle stored
    (src/hbmm.cc); side='left' only, the reference's implemented case."""
    opts = Options.make(opts)
    if Side.from_string(side) != Side.Left:
        raise SlateError("hbmm: only side='left' (reference implements left)")
    if isinstance(A, BaseBandMatrix):
        a, u = A.array, A.uplo
        kd_v = getattr(A, "kd", max(A.kl, A.ku))
    else:
        a = as_array(A)
        u = Uplo.from_string(uplo)
        slate_assert(kd is not None, "hbmm on a raw array needs kd=")
        kd_v = int(kd)
    lower = u == Uplo.Lower
    tri = torch.tril(a, 0) if lower else torch.triu(a, 0)
    tri = _masked(tri, kd_v if lower else 0, 0 if lower else kd_v)
    strict = torch.tril(tri, -1) if lower else torch.triu(tri, 1)
    if tri.is_complex():
        # the imaginary part of a Hermitian diagonal is not referenced
        tri = tri.clone()
        tri.diagonal().copy_(tri.diagonal().real.to(tri.dtype))
    full = tri + strict.mH
    return gbmm(alpha, full, B, beta, C, opts, kl=kd_v, ku=kd_v)


# ---------------------------------------------------------------------------
# triangular band solve: tbsm
# ---------------------------------------------------------------------------


def _tbsm(a, b, kd: int, nb: int, lower: bool, unit: bool, trans: bool):
    """Blocked band substitution: per block row one triangular solve and one
    windowed update of the next (previous) kd rows (src/tbsm.cc)."""
    n = a.shape[-1]
    nrhs = b.shape[-1]
    nt = _ceil_div(n, nb)
    w = _ceil_div(kd, nb) * nb            # update window beyond the diagonal block
    np_ = nt * nb
    a = _pad_to(a, np_ + w, np_ + w, diag_val=1.0)
    a = _masked(a, kd if lower else 0, 0 if lower else kd)
    if unit:
        a.diagonal().fill_(1.0)
    b = _pad_to(b, np_ + w, nrhs)
    opa = (lambda x: x.mH) if trans else (lambda x: x)
    fwd = lower != trans                  # forward substitution order
    for t in range(nt):
        kk = t if fwd else nt - 1 - t
        k0 = kk * nb
        diag = opa(a[k0:k0 + nb, k0:k0 + nb])
        x_k = torch.linalg.solve_triangular(diag, b[k0:k0 + nb], upper=not fwd,
                                            unitriangular=unit)
        b[k0:k0 + nb] = x_k
        if fwd:
            off = (opa(a[k0:k0 + nb, k0 + nb:k0 + nb + w]) if trans
                   else a[k0 + nb:k0 + nb + w, k0:k0 + nb])
            b[k0 + nb:k0 + nb + w] -= torch.matmul(off, x_k)
        else:
            # the rows above block k inside the band: [max(k0-w, 0), k0)
            r0 = max(k0 - w, 0)
            off = (opa(a[k0:k0 + nb, r0:k0]) if trans else a[r0:k0, k0:k0 + nb])
            b[r0:k0] -= torch.matmul(off, x_k)
    return b[:n]


def tbsm(side, alpha, A, B, opts=None, uplo=None, diag=None, trans=False,
         kd=None, pivots=None):
    """Solve op(A) X = alpha B with A triangular band (src/tbsm.cc); with
    ``pivots`` (a BandLU or its per-panel permutations) this is the
    tbsmPivots forward sweep.  Returns X."""
    opts = Options.make(opts)
    if Side.from_string(side) != Side.Left:
        raise SlateError("tbsm: only side='left' implemented (matches tests usage)")
    if isinstance(A, BaseBandMatrix):
        a, u = A.array, A.uplo
        kd_v = getattr(A, "kd", max(A.kl, A.ku))
        d = getattr(A, "diag", Diag.NonUnit) if diag is None else Diag.from_string(diag)
    else:
        a = as_array(A)
        u = Uplo.from_string(uplo)
        d = Diag.from_string(diag or "nonunit")
        slate_assert(kd is not None or isinstance(pivots, BandLU),
                     "tbsm on a raw array needs kd= (or BandLU pivots, "
                     "which carry their own bandwidth)")
        kd_v = int(kd) if kd is not None else 0   # BandLU overrides below
    b = as_array(B, device=a.device)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n = a.shape[-1]
    nb = min(opts.block_size, n)
    if pivots is not None:
        slate_assert(u == Uplo.Lower and not trans,
                     "pivots only apply to the forward lower sweep (gbtrs)")
        if isinstance(pivots, BandLU):  # carries its own factor-time nb/kl
            nb, kd_v, pivots = pivots.nb, pivots.kl, pivots.perms
        pivots = as_array(pivots, device=a.device)
        klt = max(1, _ceil_div(kd_v, nb))
        slate_assert(pivots.shape[-1] == (klt + 1) * nb,
                     f"pivot window {pivots.shape[-1]} does not match "
                     f"kd={kd_v}, nb={nb} (pass the BandLU, or the block_size "
                     "used at factorization time)")
        x = _gbtrs_forward(a, pivots, b, kd_v, nb)
    else:
        x = _tbsm(a, b, kd_v, nb, u == Uplo.Lower, d == Diag.Unit, bool(trans))
    x = alpha * x
    if squeeze:
        x = x[:, 0]
    return write_back(B, x)


def tbsm_pivots(side, alpha, A, pivots, B, opts=None, **kw):
    """Band triangular solve that applies LU row pivots ahead of each block
    step (src/tbsmPivots.cc); the forward sweep of gbtrs."""
    return tbsm(side, alpha, A, B, opts=opts, pivots=pivots, **kw)


tbsmPivots = tbsm_pivots    # the reference's own camelCase spelling


# ---------------------------------------------------------------------------
# band Cholesky: pbtrf / pbtrs / pbsv
# ---------------------------------------------------------------------------


def _pbtrf(a, kd: int, nb: int):
    """Windowed blocked band Cholesky (src/pbtrf.cc): per block column one
    Cholesky, a panel triangular solve and a windowed herk on a static
    (kdt+1)·nb window."""
    n = a.shape[-1]
    nt = _ceil_div(n, nb)
    w = (max(1, _ceil_div(kd, nb)) + 1) * nb
    np_ = nt * nb
    # lower-band storage, padded with identity so edge windows stay SPD
    a = _masked(_pad_to(a, np_ + w, np_ + w, diag_val=1.0), kd, 0)
    for k in range(nt):
        k0 = k * nb
        win = a[k0:k0 + w, k0:k0 + w]
        # lower-triangle storage: mirror the diagonal block before factoring
        # (its upper part holds zeros or junk from trailing updates)
        dkk = torch.tril(win[:nb, :nb])
        dkk = dkk + torch.tril(dkk, -1).mH
        lkk = _cholesky(dkk)
        panel = torch.linalg.solve_triangular(lkk.mH, win[nb:, :nb], upper=True,
                                              left=False)
        win[nb:, nb:] -= torch.matmul(panel, panel.mH)
        win[:nb, :nb] = lkk
        win[nb:, :nb] = panel
    return torch.tril(a[:n, :n])


def pbtrf(A, opts=None, uplo=None, kd=None):
    """Band Cholesky A = L L^H (src/pbtrf.cc), lower band form in and out.
    Returns (L_band, info)."""
    opts = Options.make(opts)
    if isinstance(A, BaseBandMatrix):
        a, u, kd_v = A.array, A.uplo, getattr(A, "kd", max(A.kl, A.ku))
    else:
        a = as_array(A)
        u = Uplo.from_string(uplo or "lower")
        slate_assert(kd is not None, "pbtrf on a raw array needs kd=")
        kd_v = int(kd)
    if u == Uplo.Upper:  # stored lower internally (the reference's restriction too)
        a = a.mH
    n = a.shape[-1]
    nb = min(opts.block_size, n)
    with trace_block("pbtrf", n=n, kd=kd_v):
        L = _pbtrf(a, kd_v, nb)
    diag = torch.diagonal(L, dim1=-2, dim2=-1).real
    info = first_bad_index(~(torch.isfinite(diag) & (diag > 0)))
    return write_back(A, L), info


def pbtrs(L, B, opts=None, kd=None):
    """Solve L L^H X = B with the band factor (src/pbtrs.cc)."""
    opts = Options.make(opts)
    if isinstance(L, BaseBandMatrix):
        lb, kd_v = L.array, getattr(L, "kd", max(L.kl, L.ku))
    else:
        lb = as_array(L)
        slate_assert(kd is not None, "pbtrs on a raw array needs kd=")
        kd_v = int(kd)
    y = tbsm("left", 1.0, lb, as_array(B, device=lb.device), opts, uplo="lower", kd=kd_v)
    x = tbsm("left", 1.0, lb, y, opts, uplo="lower", kd=kd_v, trans=True)
    return write_back(B, as_array(x))


def pbsv(A, B, opts=None, uplo=None, kd=None):
    """Solve an SPD band system (src/pbsv.cc): pbtrf + pbtrs.
    Returns (X, info).  With a grid-bound operand the windowed factorization
    runs on compact storage over the grid
    (:func:`..parallel.band_dist.pbsv_distributed`); the band comes off the
    wrapper's blocks without a gather, and the factor L writes back into A
    shard by shard (a later pbtrs on the wrapper sees L)."""
    slate_assert(isinstance(A, BaseBandMatrix) or kd is not None,
                 "pbsv on a raw array needs kd=")
    kd_v = (getattr(A, "kd", max(A.kl, A.ku)) if isinstance(A, BaseBandMatrix)
            else int(kd))
    grid = distribution_grid(A, B)
    if grid is not None:
        return _pbsv_grid(A, B, opts, uplo, kd_v, grid)
    L, info = pbtrf(A, opts, uplo, kd)
    return pbtrs(as_array(L), B, opts, kd=kd_v), info


def _pbsv_grid(A, B, opts, uplo, kd: int, grid):
    from ..parallel.band_dist import (_compact_of, _dense_of, pbtrf_distributed,
                                      pbtrs_distributed)

    opts = Options.make(opts)
    a = dist_operand(A)
    n = a.shape[-1]
    u = A.uplo if isinstance(A, BaseBandMatrix) else Uplo.from_string(uplo or "lower")
    if u == Uplo.Upper:
        # the lower band of A^H: Ab[j, i] = conj(A[i, i+j]) from the upper band
        G = _compact_of(a, grid, 0, kd)
        j = torch.arange(kd + 1, device=G.device)[:, None]
        i = torch.arange(n, device=G.device)[None, :]
        c = i + j
        Ab = torch.where(c < n, G[kd - j, c.clamp(max=n - 1)].conj(),
                         torch.zeros((), dtype=G.dtype, device=G.device))
    else:
        Ab = _compact_of(a, grid, kd, 0)
    with trace_block("pbsv", n=n, kd=kd, target="distributed"):
        Lb, info = pbtrf_distributed(Ab, grid, kd, nb=opts.block_size)
        write_back(A, _dense_of(Lb, grid, n, kd, 0))
        x = pbtrs_distributed(Lb, dist_operand(B), grid, kd, nb=opts.block_size)
    return write_back(B, x), info


# ---------------------------------------------------------------------------
# band LU: gbtrf / gbtrs / gbsv
# ---------------------------------------------------------------------------


class BandLU(NamedTuple):
    """Band LU factored form: the dense tensor holding L (unit, within the kl
    band, permuted per panel) and U (bandwidth kl+ku), plus the per-panel
    window permutations — the ``Pivots`` analogue in window-local form."""
    lu: torch.Tensor      # (n, n) dense with band factors
    perms: torch.Tensor   # (nt, w) per-panel window permutation
    kl: int
    ku: int
    nb: int


def _gbtrf(a, kl: int, ku: int, nb: int):
    """Windowed blocked band LU with partial pivoting (src/gbtrf.cc): pivot
    rows stay within kl of the diagonal, so each panel's window is rows
    [k0, k0+nb+kl) and columns [k0, k0+nb+kl+ku)."""
    n = a.shape[-1]
    nt = _ceil_div(n, nb)
    klt = max(1, _ceil_div(kl, nb))
    kut = max(1, _ceil_div(ku, nb))
    wr = (klt + 1) * nb
    wc = (klt + kut + 1) * nb
    np_ = nt * nb
    a = _masked(_pad_to(a, np_ + wr, np_ + wc, diag_val=1.0), kl, ku)
    perms = torch.zeros((nt, wr), dtype=torch.int64, device=a.device)
    for k in range(nt):
        k0 = k * nb
        win = a[k0:k0 + wr, k0:k0 + wc]
        plu, piv = _lu_factor(win[:, :nb])
        pperm = _device_perm(plu, piv)
        win.copy_(win[pperm])
        win[:, :nb] = plu
        rest = torch.linalg.solve_triangular(plu[:nb], win[:nb, nb:], upper=False,
                                             unitriangular=True)
        win[:nb, nb:] = rest
        win[nb:, nb:] -= torch.matmul(plu[nb:, :nb], rest)
        perms[k] = pperm
    return a[:n, :n].clone(), perms


def _gbtrs_forward(lu, perms, b, kl, nb):
    """Forward sweep with the per-panel pivoting interleaved (tbsmPivots):
    apply the panel's window permutation, then eliminate with its L."""
    n = lu.shape[-1]
    nt = _ceil_div(n, nb)
    wr = (max(1, _ceil_div(kl, nb)) + 1) * nb
    nrhs = b.shape[-1]
    np_ = nt * nb
    lu = _pad_to(lu, np_ + wr, np_ + wr, diag_val=1.0)
    b = _pad_to(b, np_ + wr, nrhs)
    for k in range(nt):
        k0 = k * nb
        win_b = b[k0:k0 + wr]
        win_b.copy_(win_b[perms[k]])
        Lwin = lu[k0:k0 + wr, k0:k0 + nb]
        y = torch.linalg.solve_triangular(Lwin[:nb], win_b[:nb], upper=False,
                                          unitriangular=True)
        win_b[nb:] -= torch.matmul(Lwin[nb:], y)
        win_b[:nb] = y
    return b[:n]


def gbtrf(A, opts=None, kl=None, ku=None):
    """Band LU with partial pivoting (src/gbtrf.cc).  Returns (BandLU, info)."""
    opts = Options.make(opts)
    a, kl, ku = _band_meta(A, kl, ku)
    n = a.shape[-1]
    slate_assert(a.shape[-2] == n, "gbtrf expects square")
    nb = min(opts.block_size, n)
    with trace_block("gbtrf", n=n, kl=kl, ku=ku):
        lu_arr, perms = _gbtrf(a, kl, ku, nb)
    info = _lu_info(torch.diagonal(lu_arr, dim1=-2, dim2=-1))
    fac = BandLU(lu=write_back(A, lu_arr), perms=perms, kl=kl, ku=ku, nb=nb)
    return fac, info


def gbtrs(fac: BandLU, B, opts=None):
    """Solve with a band LU (src/gbtrs.cc): the pivoted forward band sweep,
    then band back substitution with U (bandwidth kl+ku)."""
    b = as_array(B, device=fac.lu.device)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    y = _gbtrs_forward(fac.lu, fac.perms, b, fac.kl, fac.nb)
    x = _tbsm(fac.lu, y, fac.kl + fac.ku, fac.nb, lower=False, unit=False, trans=False)
    if squeeze:
        x = x[:, 0]
    return write_back(B, x)


def gbsv(A, B, opts=None, kl=None, ku=None):
    """Solve a general band system (src/gbsv.cc): gbtrf + gbtrs.
    Returns (X, info).  With a grid-bound operand the windowed band LU runs
    on compact storage over the grid
    (:func:`..parallel.band_dist.gbsv_distributed`), and its factored form
    writes back into A shard by shard — except into a band wrapper whose
    storage holds only kl subdiagonals, where pivoting's wider multipliers
    (up to wr - 1 below the diagonal) would be truncated; the solve uses the
    factor either way."""
    grid = distribution_grid(A, B)
    if grid is not None:
        return _gbsv_grid(A, B, opts, kl, ku, grid)
    fac, info = gbtrf(A, opts, kl, ku)
    return gbtrs(fac, B, opts), info


def _gbsv_grid(A, B, opts, kl, ku, grid):
    from ..parallel.band_dist import (_compact_of, _dense_of, gbtrf_distributed,
                                      gbtrs_distributed)

    opts = Options.make(opts)
    if isinstance(A, BaseBandMatrix):
        kl, ku = A.kl, A.ku
    slate_assert(kl is not None and ku is not None,
                 "band routines need a Band matrix or explicit kl=/ku=")
    kl, ku = int(kl), int(ku)
    a = dist_operand(A)
    n = a.shape[-1]
    with trace_block("gbsv", n=n, kl=kl, ku=ku, target="distributed"):
        fac, info = gbtrf_distributed(_compact_of(a, grid, kl, ku, extra=kl), grid,
                                      kl, ku, nb=opts.block_size)
        wr = fac.lub.shape[0] - kl - ku
        if not (isinstance(A, BaseBandMatrix) and A.kl < wr - 1):
            write_back(A, _dense_of(fac.lub, grid, n, wr - 1, ku, extra=kl))
        x = gbtrs_distributed(fac, dist_operand(B), grid)
    return write_back(B, x), info
