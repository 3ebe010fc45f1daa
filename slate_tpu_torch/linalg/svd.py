"""SVD drivers: svd / svd_vals / svd_range and the two-stage building blocks
ge2tb / ge2tb_band / tb2bd / bdsqr.

Reference analogue: ``src/svd.cc:99-141`` — scale -> [QR/LQ pre-step for tall or
wide matrices] -> ge2tb (full->band) -> tb2bd (band->bidiagonal bulge chase)
-> bdsqr -> unmbr_tb2bd / unmbr_ge2tb.

As in the JAX package, ``method="fused"`` (the default) hands the core to one
library SVD, after the QR/LQ pre-step for tall/wide inputs; ``"two_stage"``
runs the reference pipeline on the device.  On the card the library SVD is
cuSOLVER's: ``_SVD_DRIVER`` names the driver passed to
``torch.linalg.svd``/``svdvals`` for CUDA tensors (gesvd; PyTorch's default
tries gesvdj first).  ``tb2bd``'s two
chases are those of :mod:`.eig`'s ``hb2st`` (sequential: ``n·m_max`` steps;
``pipeline=True``: ``2(n-1) + m_max`` batched rounds of about 80 launches;
every chase switch defaults to the pipelined chase for a CUDA tensor).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.exceptions import slate_assert
from ..core.matrix import as_array, distribution_grid
from ..core.types import MethodSVD, Options
from ..obs import instrument
from ..robust import inject
from ..utils.trace import Timers, record_phases, trace_block
from . import householder as hh
from .eig import (_STEV_DENSE_MAX, _apply_q, _chase_setup, _pipeline_schedule,
                  _pipelined, _safe_scale, default_band_nb, unmtr_he2hb)
from .qr import geqrf, unmqr

# cuSOLVER driver of the fused SVD on the card: gesvd.  PyTorch's default
# (None) tries Jacobi (gesvdj) first; at n = 4096 f32 on an H100 that missed
# the tester's gate and was slower than gesvd (PERF.md, chip_smoke.py's
# eig_svd_driver lines)
_SVD_DRIVER: Optional[str] = "gesvd"


def _library_svd(a: torch.Tensor, compute_uv: bool):
    """Every library SVD of the module (the fused path, the dense bdsqr, the
    tiny svd_range): (U, S, Vh) with reduced factors, or S."""
    driver = _SVD_DRIVER if a.is_cuda else None
    if compute_uv:
        return torch.linalg.svd(a, full_matrices=False, driver=driver)
    return torch.linalg.svdvals(a, driver=driver)


@instrument
def svd(A, opts=None, want_u: bool = True, want_vt: bool = True,
        method: str = "fused", chase_pipeline: Optional[bool] = None,
        chase_distributed: bool = False):
    """Singular value decomposition A = U S V^H (src/svd.cc).

    Returns (S descending, U or None, VT or None).  Tall/wide inputs take the
    QR/LQ pre-step (svd.cc:224+) on the fused path.  ``method="two_stage"``
    runs ge2tb -> tb2bd -> bdsqr -> back-transforms; ``MethodSVD.Bisection``
    takes that path on its own (bisection needs a bidiagonal to bisect).  A
    wrapper bound to a grid of more than one rank runs
    :func:`..parallel.svd_distributed` whatever ``method`` (U a row-layout
    and VT a column-layout DTensor)."""
    opts = Options.make(opts)
    timers = Timers()
    grid = distribution_grid(A)
    if grid is not None:
        from ..parallel import svd_distributed

        a = inject("svd", A.dist_array())
        S, U, VT = svd_distributed(a, grid, nb=default_band_nb(min(a.shape[-2:]), opts),
                                   want_vectors=want_u or want_vt,
                                   chase_pipeline=chase_pipeline,
                                   method_svd=str(opts.method_svd),
                                   chase_distributed=chase_distributed)
        return S, (U if want_u else None), (VT if want_vt else None)
    slate_assert(not chase_distributed,
                 "chase_distributed requires a grid-bound wrapper "
                 "(Matrix.from_array(..., grid=...)); the single-device "
                 "two-stage path has nothing to distribute")
    a = inject("svd", as_array(A))
    timers.device = a.device    # one sync per phase on the card under trace.on()
    m, n = a.shape[-2:]
    want_vectors = want_u or want_vt
    if opts.method_svd == MethodSVD.Bisection and method == "fused":
        method = "two_stage"
    if method == "two_stage":
        with trace_block("svd_two_stage", m=m, n=n):
            with timers.time("svd::scale"):
                a, factor = _safe_scale(a)
            with timers.time("svd::ge2tb"):
                d, e, U1, VT1 = ge2tb(a, opts, chase_pipeline=chase_pipeline)
            with timers.time("svd::bdsqr"):
                bd_method = {MethodSVD.Bisection: "bisect",
                             MethodSVD.DC: "dense"}.get(opts.method_svd, "auto")
                Sv, Ub, VTb = bdsqr(d, e, opts, want_vectors=want_vectors,
                                    method=bd_method)
            if want_vectors:
                with timers.time("svd::unmbr"):
                    U = torch.matmul(U1, Ub.to(U1.dtype))
                    VT = torch.matmul(VTb.to(VT1.dtype), VT1)
            else:
                U = VT = None
            Sv = Sv * factor
        svd.timers = timers
        record_phases("svd", timers)
        return Sv, (U if want_u else None), (VT if want_vt else None)
    with trace_block("svd", m=m, n=n):
        with timers.time("svd::scale"):
            a, factor = _safe_scale(a)
        qr_pre = m >= 2 * n   # the reference's tall threshold for the QR pre-step
        lq_pre = n >= 2 * m
        if qr_pre:
            with timers.time("svd::geqrf"):
                fac = geqrf(a, opts)
                core = fac.R()
        elif lq_pre:
            with timers.time("svd::gelqf"):
                fac = geqrf(a.mH, opts)
                core = fac.R().mH
        else:
            core = a
        with timers.time("svd::bdsqr"):
            if want_vectors:
                U, S, VT = _library_svd(core, True)
            else:
                S = _library_svd(core, False)
                U = VT = None
        if want_vectors and qr_pre:
            with timers.time("svd::unmbr"):
                Upad = torch.cat([U, torch.zeros((m - U.shape[-2],) + U.shape[-1:],
                                                 dtype=U.dtype, device=U.device)], dim=-2)
                U = unmqr("left", "n", fac, Upad)
        if want_vectors and lq_pre:
            with timers.time("svd::unmbr"):
                VTpad = torch.cat([VT.mH, torch.zeros((n - VT.shape[-2], VT.shape[-2]),
                                                      dtype=VT.dtype, device=VT.device)],
                                  dim=-2)
                VT = unmqr("left", "n", fac, VTpad).mH.resolve_conj()
        S = S * factor
    svd.timers = timers
    record_phases("svd", timers)
    return S, (U if want_u else None), (VT if want_vt else None)


def _gk_form(d, e):
    """Golub–Kahan form of the bidiagonal B(d, e): the 2k symmetric
    tridiagonal with zero diagonal and interleaved (d_0, e_0, d_1, ...)
    off-diagonal, whose eigenvalues are ±σ_i."""
    k = d.shape[0]
    off = torch.zeros((2 * k - 1,), dtype=d.dtype, device=d.device)
    off[0::2] = d
    if k > 1:
        off[1::2] = e
    return torch.zeros((2 * k,), dtype=d.dtype, device=d.device), off


def _gk_split(Z, dtype):
    """Split TGK eigenvectors for +σ into (U, V): z[0::2] = v/√2,
    z[1::2] = u/√2, each column renormalized."""
    root2 = 2.0 ** 0.5

    def renorm(M):
        nrm = torch.linalg.vector_norm(M, dim=0, keepdim=True)
        return (M / torch.where(nrm > 0, nrm, torch.ones_like(nrm))).to(dtype)

    return renorm(root2 * Z[1::2, :]), renorm(root2 * Z[0::2, :])


def svd_range(A, opts=None, *, il: int = 0, iu: Optional[int] = None,
              want_vectors: bool = True, chase_pipeline: Optional[bool] = None):
    """Subset SVD: the singular values with DESCENDING indices [il, iu)
    (il=0 is the largest) and optionally their U/V columns.

    Two-stage reduction -> bidiagonal chase -> index-targeted Sturm bisection
    on the Golub–Kahan form -> ``stein`` for the interleaved vectors -> both
    chase back-transforms on the thin blocks -> thin stage-1 back-transforms.
    Returns ``(S, U, VT)`` with S (j,) descending, U (m, j), VT (j, n)
    (None without vectors); accuracy is bisection's absolute O(eps·σ_max).
    A grid-bound wrapper runs :func:`..parallel.svd_range_distributed`."""
    opts = Options.make(opts)
    grid = distribution_grid(A)
    if grid is not None:
        from ..parallel import svd_range_distributed

        a = A.dist_array()
        kmin = min(a.shape[-2:])
        return svd_range_distributed(a, grid, il, kmin if iu is None else iu,
                                     nb=default_band_nb(kmin, opts),
                                     want_vectors=want_vectors,
                                     chase_pipeline=chase_pipeline)
    a = as_array(A)
    m, n = a.shape[-2:]
    if m < n:
        S, V, UT = svd_range(a.mH, opts, il=il, iu=iu, want_vectors=want_vectors,
                             chase_pipeline=chase_pipeline)
        if not want_vectors:
            return S, None, None
        return S, UT.mH.resolve_conj(), V.mH.resolve_conj()
    k = n
    if iu is None:
        iu = k
    slate_assert(0 <= il < iu <= k, f"index range [{il}, {iu}) invalid for min(m,n)={k}")
    j = iu - il
    if k < 8:
        if want_vectors:
            U, S, VT = _library_svd(a, True)
            return S[il:iu], U[:, il:iu], VT[il:iu, :]
        return _library_svd(a, False)[il:iu], None, None
    from .sturm import stein, sterf_bisect

    with trace_block("svd_range", m=m, n=n, k=j):
        a, factor = _safe_scale(a)
        nb = int(max(2, min(default_band_nb(k, opts), max(2, k - 1))))
        band, Uf, Vf = ge2tb_band(a, opts, nb=nb)
        sq = band[:k, :k]
        if want_vectors:
            d_c, e_c, Us, tauus, Vcs, tauvs = tb2bd_reflectors(sq, nb, pipeline=chase_pipeline)
        else:
            d_c, e_c, *_ = _tb2bd_run_chase(sq, nb, chase_pipeline)
        d, e = d_c.abs(), e_c.abs()
        # TGK eigenvalues are ±σ ascending: descending σ indices [il, iu)
        # are TGK ascending indices [2k-iu, 2k-il)
        zero_d, tgk_off = _gk_form(d, e)
        lam_desc = sterf_bisect(zero_d, tgk_off, il=2 * k - iu, iu=2 * k - il).flip(0)
        sig = torch.clamp(lam_desc, min=0.0)
        if not want_vectors:
            return sig * factor, None, None
        Z = stein(zero_d, tgk_off, lam_desc)
        U2t, V2t = _gk_split(Z, sq.dtype)
        pu, pw = _bidiag_phases(d_c, e_c, sq.dtype)
        Uu = hh.sweep_accumulate(Us, tauus, k, nb, Q0=(pu[:, None] * U2t).mH,
                                 reverse=True).mH
        Vv = hh.sweep_accumulate(Vcs, tauvs, k, nb, Q0=(pw[:, None] * V2t).mH,
                                 reverse=True).mH
        U = torch.zeros((m, j), dtype=sq.dtype, device=sq.device)
        U[:k] = Uu
        U = unmbr_ge2tb_factors("left", "n", Uf, U)
        Vfull = torch.zeros((n, j), dtype=sq.dtype, device=sq.device)
        Vfull[:k] = Vv
        Vfull = unmbr_ge2tb_factors("left", "n", Vf, Vfull)
        return sig * factor, U, Vfull.mH.resolve_conj()


def svd_vals(A, opts=None):
    """Singular values only (src/svd.cc svd_vals entry)."""
    S, _, _ = svd(A, opts, want_u=False, want_vt=False)
    return S


# ---------------------------------------------------------------------------
# explicit pipeline stages
# ---------------------------------------------------------------------------


def ge2tb(A, opts=None, nb: Optional[int] = None,
          chase_pipeline: Optional[bool] = None):
    """Full bidiagonalization, general -> real bidiagonal: ge2tb_band then the
    tb2bd chase.  Returns (d, e, U, VT) with A = U B V^H, B upper bidiagonal,
    U (m, k), VT (k, n), k = min(m, n).  Wide inputs take an LQ pre-step."""
    opts = Options.make(opts)
    a = as_array(A)
    m, n = a.shape[-2:]
    k = min(m, n)
    if m < n:
        # LQ pre-step: A^H = Q_l R => A = R^H Q_l^H; bidiagonalize L = R^H
        Ql, R = torch.linalg.qr(a.mH, mode="reduced")
        d, e, U, VT_L = ge2tb(R.mH, opts, nb=nb, chase_pipeline=chase_pipeline)
        return d, e, U, torch.matmul(VT_L, Ql.mH)
    nb_eff = default_band_nb(k, opts) if nb is None else nb
    nb_eff = int(max(2, min(nb_eff, max(2, k - 1))))
    band, Uf, Vf = ge2tb_band(a, opts, nb=nb_eff)
    if k > 2:
        d, e, U2, VT2 = tb2bd(band[..., :k, :k], nb_eff, opts, want_vectors=True,
                              pipeline=chase_pipeline)
    else:
        # k <= 2: the band already is the bidiagonal; normalize the phases
        sq = band[:k, :k]
        d_c = torch.diagonal(sq)
        e_c = torch.diagonal(sq, 1)
        pu, pw = _bidiag_phases(d_c, e_c, a.dtype)
        d, e = d_c.abs(), e_c.abs()
        U2 = torch.diag(pu)
        VT2 = torch.diag(pw).mH
    U = torch.zeros((m, k), dtype=a.dtype, device=a.device)
    U[:k, :k] = U2.to(a.dtype)
    U = unmbr_ge2tb_factors("left", "n", Uf, U)
    Vh = torch.zeros((n, k), dtype=a.dtype, device=a.device)
    Vh[:k, :k] = VT2.to(a.dtype).mH
    return d, e, U, unmbr_ge2tb_factors("left", "n", Vf, Vh).mH.resolve_conj()


def ge2tb_band(A, opts=None, nb: Optional[int] = None):
    """Stage 1 proper: general -> upper band (bandwidth nb) by alternating
    blocked QR column panels and LQ row panels (src/ge2tb.cc).  Requires
    m >= n.  The work array is padded by nb rows and columns so the last
    panels stay in range.

    Returns ``(band, (Vu, Tu), (Vv, Tv))`` with ``A = U band V^H``,
    ``U = prod_j (I - Vu[j] Tu[j] Vu[j]^H)`` and likewise V."""
    opts = Options.make(opts)
    a = as_array(A)
    m, n = a.shape[-2:]
    if m < n:
        raise ValueError("ge2tb_band requires m >= n; LQ-pre-step wide inputs")
    if nb is None:
        nb = default_band_nb(n, opts)
    return _ge2tb_band_core(a, nb)


def _ge2tb_band_core(a, nb: int):
    """The block loop of ge2tb_band: per block, a masked QR of the column
    panel (pivots on the diagonal) applied from the left, then a masked LQ of
    the row panel (pivots one block right) applied from the right."""
    m, n = a.shape[-2:]
    nt = max(-(-n // nb), 1)
    mp, np_ = m + nb, n + nb
    dt, dev = a.dtype, a.device
    Acur = torch.zeros((mp, np_), dtype=dt, device=dev)
    Acur[:m, :n] = a
    Vu = torch.zeros((nt, mp, nb), dtype=dt, device=dev)
    Tu = torch.zeros((nt, nb, nb), dtype=dt, device=dev)
    Vv = torch.zeros((nt, np_, nb), dtype=dt, device=dev)
    Tv = torch.zeros((nt, nb, nb), dtype=dt, device=dev)
    for j in range(nt):
        k0 = j * nb
        _, V, taus = hh.panel_qr_masked(Acur[:, k0:k0 + nb], k0, nb)
        T = hh.build_T(V, taus)
        Acur = hh.block_apply_left(V, T, Acur, conj_q=True)
        Vu[j], Tu[j] = V, T
        _, Vr, tausr = hh.panel_lq_masked(Acur[k0:k0 + nb, :], k0 + nb, nb)
        Tr = hh.build_T(Vr, tausr)
        Acur = hh.block_apply_right(Vr, Tr, Acur)
        Vv[j], Tv[j] = Vr, Tr
    ri = torch.arange(m, device=dev)[:, None]
    ci = torch.arange(n, device=dev)[None, :]
    inband = (ci >= ri) & (ci - ri <= nb)
    band = torch.where(inband, Acur[:m, :n], torch.zeros((), dtype=dt, device=dev))
    return band, (Vu[:, :m, :], Tu), (Vv[:, :n, :], Tv)


def unmbr_ge2tb_factors(side, op, factors, C):
    """Apply a stacked block-reflector factor of ge2tb_band ((Vu, Tu) for U,
    (Vv, Tv) for V) to C without forming Q (src/unmbr_ge2tb.cc)."""
    Vs, Ts = factors
    return unmtr_he2hb(side, op, Vs, Ts, C)


def _gebr1(Bp, s: int, b: int):
    """gebr1 on the (b+1, b) window at (s, s+1), in place: a right reflector
    zeroes row s beyond the superdiagonal, then a left one zeroes column s+1
    below its first subdiagonal row.  Returns (u, tauu, v, tauv)."""
    W = Bp[s:s + b + 1, s + 1:s + 1 + b]
    v, tauv, _ = hh.larfg(W[0, :].conj())
    W = hh.apply_right(tauv, v, W)
    u, tauu, _ = hh.larfg(W[1:, 0])
    W[1:, :] = hh.apply_left(tauu, u, W[1:, :])
    Bp[s:s + b + 1, s + 1:s + 1 + b] = W
    return u, tauu, v, tauv


def _tb2bd_chase(Bfull: torch.Tensor, kd: int):
    """Sequential bidiagonal bulge chase: square upper band (bandwidth
    kd >= 2) -> complex bidiagonal, through the reference's task types
    (internal_gebr.cc gebr1/gebr2/gebr3; windows tb2bd.cc:77-131).

    Per sweep s: gebr1; then per block r >= 1, gebr2 left-applies the previous
    u to the superdiagonal window at ((r-1)kd+1+s, r·kd+1+s) and a new right
    reflector zeroes its first row, and gebr3 right-applies that v to the
    diagonal window and a new left u zeroes its first column.  Steps past the
    edge are skipped (the JAX package's zero-padding no-ops, which store the
    reflector ``e_0`` with tau 0, stored here directly).  About 45 launches
    per active step.  Returns (d_c, e_c, Us, tauus, Vs, tauvs)."""
    n = Bfull.shape[-1]
    b = kd
    Bp, _, m_max = _chase_setup(Bfull, kd)
    n_sweeps = max(n - 1, 0)
    dt, dev = Bfull.dtype, Bfull.device
    Us = torch.zeros((n_sweeps, m_max, b), dtype=dt, device=dev)
    tauus = torch.zeros((n_sweeps, m_max), dtype=dt, device=dev)
    Vs = torch.zeros((n_sweeps, m_max, b), dtype=dt, device=dev)
    tauvs = torch.zeros((n_sweeps, m_max), dtype=dt, device=dev)
    for s in range(n_sweeps):
        u, tauu, v, tauv = _gebr1(Bp, s, b)
        Us[s, 0], tauus[s, 0], Vs[s, 0], tauvs[s, 0] = u, tauu, v, tauv
        r = 1
        while r < m_max and r * b + 1 + s < n:
            i = (r - 1) * b + 1 + s
            j = r * b + 1 + s
            W = hh.apply_left(tauu, u, Bp[i:i + b, j:j + b])
            v, tauv, _ = hh.larfg(W[0, :].conj())
            Bp[i:i + b, j:j + b] = hh.apply_right(tauv, v, W)
            D = hh.apply_right(tauv, v, Bp[j:j + b, j:j + b])
            u, tauu, _ = hh.larfg(D[:, 0])
            Bp[j:j + b, j:j + b] = hh.apply_left(tauu, u, D)
            Us[s, r], tauus[s, r], Vs[s, r], tauvs[s, r] = u, tauu, v, tauv
            r += 1
        Us[s, r:, 0] = 1.0
        Vs[s, r:, 0] = 1.0
    B = Bp[:n, :n]
    return (torch.diagonal(B).clone(), torch.diagonal(B, 1).clone(),
            Us, tauus, Vs, tauvs)


def _tb2bd_chase_pipelined(Bfull: torch.Tensor, kd: int):
    """Multi-sweep pipelined bidiagonal chase (tb2bd.cc:163-196, the same
    dependency rule as hb2st) in batched rounds: sweep s starts at round 2s
    and advances one block per round, two blocks behind the sweep before it,
    so window footprints are element-disjoint.  Each round: the gebr1 of the
    starting sweep, then batched gebr2+gebr3 pairs over all slots, dead slots
    reading and writing zeros in the padding (so their shared indices write
    only zeros).  About 80 launches per round, ``2(n-1) + m_max`` rounds, no
    host sync.  Returns (d_c, e_c, Us, tauus, Vs, tauvs) like the sequential
    chase (dead steps store zero reflectors; both mean H = I)."""
    n = Bfull.shape[-1]
    b = kd
    Bp, N, m_max = _chase_setup(Bfull, kd)
    n_sweeps = max(n - 1, 0)
    dt, dev = Bfull.dtype, Bfull.device
    B, T, start, R, S, LIVE = _pipeline_schedule(n, b, n_sweeps, m_max, bidiag=True)
    zi, zj = n + b + 1, n + 1
    I = np.where(LIVE, (R - 1) * b + 1 + S, zj)
    J = np.where(LIVE, R * b + 1 + S, zi)
    SR = np.where(LIVE, S * m_max + R, n_sweeps * m_max)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    baseW = up(I) * N + up(J)
    baseD = up(J) * N + up(J)
    sr = up(SR)
    ar = torch.arange(b, device=dev)
    off = ar[:, None] * N + ar[None, :]
    nslot = (n_sweeps + 1) * m_max
    Us = torch.zeros((nslot, b), dtype=dt, device=dev)
    tauus = torch.zeros((nslot,), dtype=dt, device=dev)
    Vs = torch.zeros((nslot, b), dtype=dt, device=dev)
    tauvs = torch.zeros((nslot,), dtype=dt, device=dev)
    uprev = torch.zeros((B, b), dtype=dt, device=dev)
    tuprev = torch.zeros((B,), dtype=dt, device=dev)
    Bf = Bp.view(-1)
    for t in range(T):
        s0 = int(start[t])
        if s0 >= 0:
            u0, tauu0, v0, tauv0 = _gebr1(Bp, s0, b)
            Us[s0 * m_max], tauus[s0 * m_max] = u0, tauu0
            Vs[s0 * m_max], tauvs[s0 * m_max] = v0, tauv0
            uprev[s0 % B], tuprev[s0 % B] = u0, tauu0
        iw = baseW[t][:, None, None] + off
        Wb = Bf[iw]
        # gebr2: left-apply the previous u, then a new right v zeroing row 0
        uW = torch.matmul(uprev.conj()[:, None, :], Wb)
        Wb = Wb - (tuprev.conj()[:, None, None] * uprev[:, :, None]) * uW
        v, tauv, _ = hh.larfg(Wb[:, 0, :].conj())
        Wv = torch.matmul(Wb, v[:, :, None])
        Wb = Wb - (tauv[:, None, None] * Wv) * v.conj()[:, None, :]
        Bf[iw] = Wb
        # gebr3: right-apply v on the diagonal window, new left u zeroing col 0
        idd = baseD[t][:, None, None] + off
        Db = Bf[idd]
        Dv = torch.matmul(Db, v[:, :, None])
        Db = Db - (tauv[:, None, None] * Dv) * v.conj()[:, None, :]
        u, tauu, _ = hh.larfg(Db[:, :, 0])
        uD = torch.matmul(u.conj()[:, None, :], Db)
        Db = Db - (tauu.conj()[:, None, None] * u[:, :, None]) * uD
        Bf[idd] = Db
        # dead slots: e_0 / tau 0 into the dropped scratch row (see hb2st)
        Vs[sr[t]], tauvs[sr[t]] = v, tauv
        Us[sr[t]], tauus[sr[t]] = u, tauu
        uprev, tuprev = u, tauu
    Bm = Bp[:n, :n]
    keep = lambda x: x.view(n_sweeps + 1, m_max, *x.shape[1:])[:n_sweeps]
    return (torch.diagonal(Bm).clone(), torch.diagonal(Bm, 1).clone(),
            keep(Us), keep(tauus), keep(Vs), keep(tauvs))


def _phase(x: torch.Tensor, dt) -> torch.Tensor:
    mag = x.abs()
    one = torch.ones((), dtype=dt, device=x.device)
    return torch.where(mag > 0, x / torch.where(mag > 0, mag, 1.0).to(x.dtype), one).to(dt)


def _bidiag_phases(d_c, e_c, dt):
    """Unitary diagonal phases (pu, pw) with B_c = diag(pu) B_real diag(pw)^H:
    pu_j conj(pw_j) = phase(d_j), pu_j conj(pw_{j+1}) = phase(e_j)."""
    pd, pe = _phase(d_c, dt), _phase(e_c, dt)
    if d_c.shape[-1] > 1:
        pw = torch.cat([torch.ones((1,), dtype=dt, device=d_c.device),
                        torch.cumprod(pe.conj() * pd[:-1], 0)])
    else:
        pw = torch.ones(d_c.shape, dtype=dt, device=d_c.device)
    return pd * pw, pw


def tb2bd_reflectors(band, kd, pipeline: Optional[bool] = None):
    """Stage-2 bidiagonal chase at the reflector level:
    (d_c, e_c, Us, tauus, Vs, tauvs) without forming U2/VT2.  Requires
    kd > 1."""
    b = as_array(band)
    slate_assert(kd > 1, "tb2bd_reflectors needs kd > 1 (no chase below)")
    kb = min(b.shape[-2:])
    return _tb2bd_run_chase(b[..., :kb, :kb], kd, pipeline)


def _tb2bd_run_chase(sq, kd: int, pipeline: Optional[bool]):
    chase = _tb2bd_chase_pipelined if _pipelined(pipeline, sq) else _tb2bd_chase
    return chase(sq, kd)


def tb2bd(band, kd, opts=None, want_vectors: bool = False,
          pipeline: Optional[bool] = None):
    """Stage 2: band -> bidiagonal bulge chasing (src/tb2bd.cc).  kd = 1 is
    the phase-normalized extraction; kd >= 2 runs the chase
    (``pipeline=True``: the batched multi-sweep form, the default for a CUDA
    tensor).
    With want_vectors, returns (d, e, U2, VT2) with band = U2 B VT2."""
    b = as_array(band)
    if kd > 1:
        kb = min(b.shape[-2:])
        d_c, e_c, Us, tauus, Vs, tauvs = tb2bd_reflectors(b, kd, pipeline=pipeline)
        pu, pw = _bidiag_phases(d_c, e_c, b.dtype)
        d, e = d_c.abs(), e_c.abs()
        if not want_vectors:
            return d, e
        U2 = hh.sweep_accumulate(Us, tauus, kb, kd) * pu[None, :]
        V2 = hh.sweep_accumulate(Vs, tauvs, kb, kd) * pw[None, :]
        return d, e, U2, V2.mH.resolve_conj()
    k = min(b.shape[-2:])
    m, n = b.shape[-2:]
    d_c = torch.diagonal(b, dim1=-2, dim2=-1)[:k]
    e_c = torch.diagonal(b, 1, dim1=-2, dim2=-1)[: k - 1]
    if not b.is_complex():
        if not want_vectors:
            return d_c, e_c
        eye = lambda r, c: torch.eye(r, c, dtype=b.dtype, device=b.device)
        return d_c, e_c, eye(m, k), eye(k, n)
    # complex band: B_c = diag(u) B_real diag(w)^T with u_j w_j = phase(d_j),
    # u_j w_{j+1} = phase(e_j): w_0 = 1, u_j = pd_j / w_j,
    # w_{j+1} = w_j pd_j^* pe_j
    pd, pe = _phase(d_c, b.dtype), _phase(e_c, b.dtype)
    w = torch.cat([torch.ones_like(pd[:1]), torch.cumprod(pd[:-1].conj() * pe, 0)])
    u = pd / w
    d, e = d_c.abs(), e_c.abs()
    if not want_vectors:
        return d, e
    U2 = torch.eye(m, k, dtype=b.dtype, device=b.device) * u[None, :]
    VT2 = torch.eye(k, n, dtype=b.dtype, device=b.device) * w[:, None]
    return d, e, U2, VT2


def unmbr_ge2tb(side, op, Q, C, opts=None):
    """Apply the stage-1 bidiagonalization factor (U or V^H of ge2tb) to C
    (src/unmbr_ge2tb.cc): one matmul, the factor being formed."""
    return _apply_q(side, op, Q, C)


def unmbr_tb2bd(side, op, Q, C, opts=None):
    """Apply the stage-2 (band -> bidiagonal) factor of
    ``tb2bd(..., want_vectors=True)`` to C (src/unmbr_tb2bd.cc)."""
    return _apply_q(side, op, Q, C)


def bdsqr(d, e, opts=None, want_vectors: bool = False, method: str = "auto"):
    """Bidiagonal SVD (src/bdsqr.cc).

    ``method``: "auto" bisects the Golub–Kahan form above
    ``_STEV_DENSE_MAX`` for values only, else one library SVD of B; "dense"
    always takes the library SVD; "bisect" always bisects, with vectors from
    ``stein`` on the same form (the bdsvdx route).  Bisection's accuracy is
    absolute, O(eps·σ_max)."""
    slate_assert(method in ("auto", "dense", "bisect"), f"bdsqr: unknown method '{method}'")
    d = as_array(d)
    e = as_array(e, device=d.device)
    k = d.shape[-1]
    use_bisect = (method == "bisect"
                  or (method == "auto" and k > _STEV_DENSE_MAX and not want_vectors))
    if use_bisect:
        from .sturm import stein, sterf_bisect

        zero_d, tgk_off = _gk_form(d, e)
        lam = sterf_bisect(zero_d, tgk_off)
        # +σ branch, descending; clamp the ~eps·||B|| bisection noise at σ≈0
        sig = torch.clamp(lam[k:].flip(0), min=0.0)
        if not want_vectors:
            return sig, None, None
        Z = stein(zero_d, tgk_off, lam[k:].flip(0))
        U, V = _gk_split(Z, Z.dtype)
        return sig, U, V.transpose(-1, -2)
    B = torch.diag_embed(d)
    if k > 1:
        B = B + torch.diag_embed(e, offset=1)
    if want_vectors:
        U, S, VT = _library_svd(B, True)
        return S, U, VT
    return _library_svd(B, False), None, None

