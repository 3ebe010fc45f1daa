"""Hermitian eigensolvers: heev / hegv / hegst, the subset solvers heev_range /
hegv_range / eig_count, and the two-stage building blocks (he2hb band
reduction, hb2st bulge chase, sterf/steqr/stedc tridiagonal solvers).

Reference analogue: ``src/heev.cc:68-225`` — scale -> he2hb -> hb2st ->
sterf / steqr / stedc -> unmtr_hb2st / unmtr_he2hb -> rescale; generalized
``src/hegv.cc`` / ``src/hegst.cc``.

As in the JAX package, ``method="fused"`` (the default) hands the whole solve
to one library call (``torch.linalg.eigh`` / ``eigvalsh``: cuSOLVER on the
card), and ``method="two_stage"`` runs the reference pipeline stage by stage
on the device.  The JAX package's jitted loops become Python loops over
tensor ops here; what each costs in launches is written beside it:

* ``he2hb``: one masked panel QR (about 25 launches per column, nb columns)
  and six gemms per block column, n/nb - 1 block columns.
* ``hb2st``: the sequential chase runs ``n·m_max`` window steps of about 35
  launches each (``m_max = ceil((n-1)/kd)``) — fine on the CPU and for small
  n, not at scale.  ``pipeline=True`` runs the multi-sweep chase in
  ``2(n-2) + m_max`` rounds of about 60 launches, every live sweep front of a
  round in one batched gather / update / scatter.  Its schedule does not
  depend on the data, so it is built on the host once and uploaded; neither
  chase waits for the card.  Every chase switch (``chase_pipeline``,
  ``pipeline``) defaults to the pipelined chase for a CUDA tensor and to the
  sequential one elsewhere.
* ``sterf``: Sturm bisection above ``_STEV_DENSE_MAX`` (:mod:`.sturm`).

The heev scaling reads the max norm inline (``_safe_scale``), as the JAX
package's does; it does not reach :mod:`slate_tpu_torch.ops.norms`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.exceptions import NumericalError, SlateError, slate_assert
from ..core.matrix import (HermitianMatrix, SymmetricMatrix, as_array,
                           distribution_grid, write_back)
from ..core.types import MethodEig, Op, Options, Side, Uplo
from ..obs import instrument
from ..robust import inject
from ..utils.trace import Timers, record_phases, trace_block
from . import householder as hh
from .chol import _full_spd, potrf
from .stedc import _assemble_tridiag, _library_eigh


def _full_herm(A, uplo):
    if isinstance(A, (HermitianMatrix, SymmetricMatrix)):
        return A.full_array()
    return _full_spd(A, uplo or Uplo.Lower)


def _grid_herm(A, uplo, grid):
    """The full Hermitian operand of a grid-bound wrapper, in the block
    layout: its stored triangle and the mirrored one, assembled shard by
    shard (``distribute.full_hermitian``), never gathered."""
    from ..parallel.distribute import full_hermitian

    half = isinstance(A, (HermitianMatrix, SymmetricMatrix))
    lower = Uplo.from_string(A.uplo if half else (uplo or Uplo.Lower)) == Uplo.Lower
    return full_hermitian(A.dist_array(), grid, lower,
                          herm=not isinstance(A, SymmetricMatrix))


def _method_name(opts: Options) -> str:
    """The distributed drivers' tridiagonal method of ``opts.method_eig``."""
    return {MethodEig.QR: "qr", MethodEig.Bisection: "bisection"}.get(
        opts.method_eig, "dc")


def _symmetrize(a: torch.Tensor) -> torch.Tensor:
    """(a + a^H) / 2: what ``jnp.linalg.eigh`` does to its input
    (symmetrize_input=True) before the library reads one triangle."""
    return (a + a.mH) * 0.5


def _safe_scale(a):
    """Pre-scale like heev.cc:105-122: bring ||A||_max into the safe range.
    Returns (scaled, factor) with eigenvalues of `a` = factor * eig(scaled).
    No host sync."""
    anorm = torch.max(a.abs())
    fi = torch.finfo(a.real.dtype)
    rmin = fi.tiny ** 0.5 / fi.eps ** 0.5
    rmax = (1.0 / fi.tiny) ** 0.5 * fi.eps ** 0.5
    one = torch.ones((), dtype=anorm.dtype, device=anorm.device)
    sigma = torch.where(anorm > rmax, rmax / anorm,
                        torch.where((anorm < rmin) & (anorm > 0), rmin / anorm, one))
    return a * sigma.to(a.dtype), 1.0 / sigma


def _method_tridiag_vectors(opts: Options, d, e):
    """The tridiagonal eigensolve with vectors that ``opts.method_eig`` names:
    QR -> steqr, Bisection -> sterf_bisect + stein, else (Auto, DC, MRRR) ->
    stedc, the performance path."""
    if opts.method_eig == MethodEig.QR:
        return steqr(d, e)
    if opts.method_eig == MethodEig.Bisection:
        from .sturm import stein, sterf_bisect

        lam = sterf_bisect(d, e)
        return lam, stein(d, e, lam)
    return stedc(d, e)


@instrument
def heev(A, opts=None, uplo=None, want_vectors: bool = True,
         method: str = "fused", chase_pipeline: Optional[bool] = None,
         chase_distributed: bool = False):
    """Hermitian eigensolve (src/heev.cc).  Returns (Lambda ascending, Z or None).

    method:
      - "fused" (default): one library eigensolve of the whole matrix.
      - "two_stage": he2hb -> hb2st -> sterf/steqr/stedc -> unmtr_hb2st ->
        unmtr_he2hb on the device; ``opts.method_eig`` selects the
        tridiagonal solver (Auto/DC -> stedc, QR -> steqr, Bisection ->
        sterf_bisect + stein; values alone: DC -> stedc, else sterf).

    ``heev.timers`` holds the phase map (the reference's --timer-level 2).
    The call stays asynchronous on the card: its phases time the host's
    launches, unless tracing is on (``trace.on()``), when each phase ends in
    a device sync and the map is the device's phase split
    (:class:`~..utils.trace.Timers`).

    A wrapper bound to a grid of more than one rank runs the distributed
    pipeline (:func:`..parallel.heev_distributed`: stage 1 on block rows, the
    band on every rank, the chase replicated or, with ``chase_distributed``,
    segment-parallel) whatever ``method``; Z then comes back as a DTensor in
    the row layout."""
    opts = Options.make(opts)
    timers = Timers()
    grid = distribution_grid(A)
    if grid is not None:
        from ..parallel import heev_distributed

        a = inject("heev", _grid_herm(A, uplo, grid))
        lam, z = heev_distributed(
            a, grid, nb=default_band_nb(a.shape[-1], opts), want_vectors=want_vectors,
            method_eig=_method_name(opts), chase_pipeline=chase_pipeline,
            chase_distributed=chase_distributed)
        return (lam, z) if want_vectors else (lam, None)
    slate_assert(not chase_distributed,
                 "chase_distributed requires a grid-bound wrapper "
                 "(Matrix.from_array(..., grid=...)); the single-device "
                 "two-stage path has nothing to distribute")
    a = inject("heev", _full_herm(A, uplo))
    n = a.shape[-1]
    timers.device = a.device
    if method == "two_stage" and n < 8:
        method = "fused"  # no meaningful band structure below one panel
    with trace_block("heev", n=n):
        with timers.time("heev::scale"):
            a, factor = _safe_scale(a)
        if method == "two_stage":
            nb = default_band_nb(n, opts)
            with timers.time("heev::he2hb"):
                band, Vs, Ts = he2hb(a, opts, nb=nb)
            with timers.time("heev::hb2st"):
                out = hb2st(band, kd=nb, want_vectors=want_vectors,
                            pipeline=chase_pipeline)
            with timers.time("heev::stev"):
                if want_vectors:
                    d, e, Q2 = out
                    lam, Zt = _method_tridiag_vectors(opts, d, e)
                    with timers.time("heev::unmtr_hb2st"):
                        z = torch.matmul(Q2, Zt.to(Q2.dtype))
                    with timers.time("heev::unmtr_he2hb"):
                        z = unmtr_he2hb("left", "n", Vs, Ts, z)
                else:
                    d, e = out
                    lam = (stedc(d, e)[0] if opts.method_eig == MethodEig.DC
                           else sterf(d, e))
                    z = None
        else:
            with timers.time("heev::solve"):
                a = _symmetrize(a)
                lam, z = _library_eigh(a, want_vectors)
        with timers.time("heev::rescale"):
            lam = lam * factor
    heev.timers = timers
    record_phases("heev", timers)
    return (lam, z) if want_vectors else (lam, None)


@instrument
def heev_range(A, opts=None, uplo=None, *, il: int = 0,
               iu: Optional[int] = None, want_vectors: bool = True,
               chase_pipeline: Optional[bool] = None):
    """Subset Hermitian eigensolve: the ascending eigenvalues with INDICES
    [il, iu) and optionally their vectors (LAPACK heevx range='I').

    Two-stage reduction, index-targeted Sturm bisection of the k = iu - il
    wanted eigenvalues, ``stein`` for their vectors, and the chase
    back-transform applied to the thin (n, k) block by the reverse sweep
    accumulation (the (n, n) Q2 is never formed).  Returns ``(lam, Z)`` with
    lam (k,) ascending, Z (n, k) or None.  A grid-bound wrapper runs
    :func:`..parallel.heev_range_distributed` (Z a row-layout DTensor)."""
    opts = Options.make(opts)
    grid = distribution_grid(A)
    a = _grid_herm(A, uplo, grid) if grid is not None else _full_herm(A, uplo)
    n = a.shape[-1]
    if iu is None:
        iu = n
    slate_assert(0 <= il < iu <= n, f"index range [{il}, {iu}) invalid for n={n}")
    if grid is not None:
        from ..parallel import heev_range_distributed

        lam, z = heev_range_distributed(a, grid, il, iu, nb=default_band_nb(n, opts),
                                        want_vectors=want_vectors,
                                        chase_pipeline=chase_pipeline)
        return (lam, z) if want_vectors else (lam, None)
    if n < 8:
        lam, z = _library_eigh(_symmetrize(a))
        return (lam[il:iu], z[:, il:iu]) if want_vectors else (lam[il:iu], None)
    from .sturm import stein, sterf_bisect

    with trace_block("heev_range", n=n, k=iu - il):
        a, factor = _safe_scale(a)
        nb = default_band_nb(n, opts)
        band, Vs1, Ts1 = he2hb(a, opts, nb=nb)
        if not want_vectors:
            d, e = hb2st(band, kd=nb, want_vectors=False, pipeline=chase_pipeline)
            return sterf_bisect(d, e, il=il, iu=iu) * factor, None
        d, e_c, Vcs, tcs = hb2st_reflectors(band, kd=nb, pipeline=chase_pipeline)
        e = e_c.abs()
        lam = sterf_bisect(d, e, il=il, iu=iu)
        Zt = stein(d, e, lam).to(band.dtype)
        # band = Q2 T Q2^H with Q2 = Qraw · diag(phase): Q2 @ Zt =
        # Qraw @ (phase ⊙ Zt), from the reverse sweep accumulation
        X = _phase_vector(e_c.to(band.dtype))[:, None] * Zt
        z = hh.sweep_accumulate(Vcs, tcs, n, nb, Q0=X.mH, reverse=True).mH
        z = unmtr_he2hb("left", "n", Vs1, Ts1, z)
        return lam * factor, z


def eig_count(A, vl, vu, opts=None, uplo=None):
    """Number of eigenvalues of the Hermitian A in the half-open interval
    [vl, vu): two-stage reduction and one Sturm pass over both endpoints
    (LAPACK stebz range='V' counting).  Endpoints coinciding with an
    eigenvalue are eps-sensitive: pick them in spectral gaps.  Returns an
    int32 scalar tensor.  The chase is the default of :func:`hb2st`
    (pipelined on a CUDA tensor, sequential elsewhere).  A grid-bound wrapper
    is refused, as in the JAX package: the Sturm count has no distributed
    form."""
    opts = Options.make(opts)
    slate_assert(distribution_grid(A) is None,
                 "eig_count has no distributed pipeline: the Sturm-count "
                 "stage is replicated-only.  Gather the wrapper to a plain "
                 "array explicitly (eig_count(A.array, ...)) to accept the "
                 "single-device cost, or use heev_range for subset spectra.")
    a = _full_herm(A, uplo)
    n = a.shape[-1]
    if n < 8:
        lam, _ = _library_eigh(_symmetrize(a), want_vectors=False)
        return ((lam >= vl) & (lam < vu)).sum().to(torch.int32)
    from .sturm import sturm_count_interval

    a, factor = _safe_scale(a)
    nb = default_band_nb(n, opts)
    band, _, _ = he2hb(a, opts, nb=nb)
    d, e = hb2st(band, kd=nb, want_vectors=False)
    return sturm_count_interval(d, e, vl / factor, vu / factor)


def hegst(itype: int, A, B_factor, opts=None, uplo=None):
    """Transform the generalized problem to standard form (src/hegst.cc):
    itype=1: A x = lambda B x -> C = L^{-1} A L^{-H}; itype=2/3:
    A B x = lambda x -> C = L^H A L, with B = L L^H (lower)."""
    a = _full_herm(A, uplo)
    L = torch.tril(as_array(B_factor, device=a.device))
    if itype == 1:
        W = torch.linalg.solve_triangular(L, a, upper=False)
        C = torch.linalg.solve_triangular(L, W.mH, upper=False)
        return C.mH.resolve_conj()
    if itype in (2, 3):
        return torch.matmul(torch.matmul(L.mH, a), L)
    raise SlateError(f"hegst itype must be 1, 2, or 3, got {itype}")


def _hegv_pipeline(itype: int, A, B, opts, uplo, want_vectors, solve, label: str):
    """Shared generalized-eigensolve body (src/hegv.cc): potrf(B) -> hegst ->
    ``solve`` on the standard form -> the itype's back-transform.  One host
    sync: the Cholesky ``info``."""
    b = _full_herm(B, uplo)
    with trace_block(label, n=b.shape[-1]):
        L, info = potrf(b, opts)
        if int(info) != 0:
            raise NumericalError(f"{label}: B not positive definite (info={int(info)})")
        C = hegst(itype, A, L, opts, uplo)
        lam, z = solve(C)
        if want_vectors:
            if itype in (1, 2):
                # x = L^{-H} y (LAPACK hegv back-transform for itypes 1 and 2)
                z = torch.linalg.solve_triangular(L.mH, z, upper=True)
            else:
                z = torch.matmul(torch.tril(L), z)      # itype=3: x = L y
    return lam, (z if want_vectors else None)


@instrument
def hegv(itype: int, A, B, opts=None, uplo=None, want_vectors: bool = True):
    """Generalized Hermitian eigensolve A x = lambda B x (src/hegv.cc:
    potrf(B) -> hegst -> heev -> back-transform)."""
    opts = Options.make(opts)
    return _hegv_pipeline(
        itype, A, B, opts, uplo, want_vectors,
        lambda C: heev(C, opts, uplo="lower", want_vectors=want_vectors), "hegv")


def hegv_range(itype: int, A, B, opts=None, uplo=None, *, il: int = 0,
               iu: Optional[int] = None, want_vectors: bool = True):
    """Generalized subset eigensolve for the eigenvalue INDICES [il, iu)
    (LAPACK hegvx range='I'): hegv's reduction with ``heev_range`` as the
    standard stage."""
    opts = Options.make(opts)
    return _hegv_pipeline(
        itype, A, B, opts, uplo, want_vectors,
        lambda C: heev_range(C, opts, uplo="lower", il=il, iu=iu,
                             want_vectors=want_vectors), "hegv_range")


# ---------------------------------------------------------------------------
# explicit pipeline stages (two-stage scaffolding + tridiagonal solvers)
# ---------------------------------------------------------------------------


def default_band_nb(n: int, opts: Optional[Options] = None) -> int:
    """Bandwidth for the two-stage reduction: the Options block size capped at
    64 and at n/4 (the JAX package's rule)."""
    nb = opts.block_size if opts is not None else 256
    return max(2, min(nb, 64, max(2, n // 4)))


def he2hb(A, opts=None, uplo=None, nb: Optional[int] = None):
    """Stage 1: reduce Hermitian to nb-band form by blocked Householder QR
    panels (src/he2hb.cc).  Each block column QRs the sub-panel below the band
    (full-height masked panel) and applies the compact-WY block reflector
    two-sided to the whole matrix.  A leading batch dimension reduces each
    matrix in turn.

    Returns ``(band, Vs, Ts)`` with ``A = Q band Q^H``,
    ``Q = prod_j (I - Vs[j] Ts[j] Vs[j]^H)``; band keeps both triangles."""
    opts = Options.make(opts)
    a = _full_herm(A, uplo)
    n = a.shape[-1]
    if nb is None:
        nb = default_band_nb(n, opts)
    if a.ndim > 2:
        outs = [he2hb(x, opts, nb=nb) for x in a.reshape(-1, n, n)]
        lead = a.shape[:-2]
        return tuple(torch.stack([o[i] for o in outs]).reshape(lead + outs[0][i].shape)
                     for i in range(3))
    nj = max(-(-n // nb) - 1, 0)
    if nj == 0:
        z = torch.zeros
        return (a, z((0, n, nb), dtype=a.dtype, device=a.device),
                z((0, nb, nb), dtype=a.dtype, device=a.device))
    return _he2hb_core(a, nb)


def _he2hb_core(a, nb: int):
    """The block-column loop of he2hb (every slice is in range: the last
    panel starts at (nj-1)·nb, below n - nb)."""
    n = a.shape[-1]
    nj = max(-(-n // nb) - 1, 0)
    Acur = a
    Vs = torch.zeros((nj, n, nb), dtype=a.dtype, device=a.device)
    Ts = torch.zeros((nj, nb, nb), dtype=a.dtype, device=a.device)
    for j in range(nj):
        k0 = j * nb
        _, V, taus = hh.panel_qr_masked(Acur[:, k0:k0 + nb], k0 + nb, nb)
        T = hh.build_T(V, taus)
        Acur = hh.block_apply_left(V, T, Acur, conj_q=True)
        Acur = hh.block_apply_right(V, T, Acur)
        Vs[j] = V
        Ts[j] = T
    idx = torch.arange(n, device=a.device)
    inband = (idx[:, None] - idx[None, :]).abs() <= nb
    return torch.where(inband, Acur, torch.zeros((), dtype=a.dtype, device=a.device)), Vs, Ts


def _apply_q(side, op, Q, C):
    """C <- op(Q) C (Side.Left) or C op(Q) (Side.Right)."""
    side = Side.from_string(side) if not isinstance(side, Side) else side
    op = Op.from_string(op) if not isinstance(op, Op) else op
    q = as_array(Q)
    if op == Op.Trans:
        q = q.transpose(-1, -2)
    elif op == Op.ConjTrans:
        q = q.mH
    c = as_array(C, device=q.device)
    out = torch.matmul(q, c) if side == Side.Left else torch.matmul(c, q)
    return write_back(C, out)


def he2hb_q(Vs, Ts) -> torch.Tensor:
    """Materialize the stage-1 Q from he2hb's stacked block reflectors
    (ungtr analogue; two gemms per block)."""
    Vs = as_array(Vs)
    Ts = as_array(Ts, device=Vs.device)
    nj, n, _ = Vs.shape
    Q = torch.eye(n, dtype=Vs.dtype, device=Vs.device)
    for j in range(nj - 1, -1, -1):
        Q = hh.block_apply_left(Vs[j], Ts[j], Q)
    return Q


def unmtr_he2hb(side, op, Vs, Ts, C, opts=None):
    """Apply the stage-1 (full -> band) orthogonal factor to C
    (src/unmtr_he2hb.cc) block reflector by block reflector; Q is never
    formed."""
    side = Side.from_string(side) if not isinstance(side, Side) else side
    op = Op.from_string(op) if not isinstance(op, Op) else op
    if op not in (Op.NoTrans, Op.ConjTrans, Op.Trans):
        raise SlateError(f"unmtr_he2hb: bad op {op}")
    Vs = as_array(Vs)
    Ts = as_array(Ts, device=Vs.device)
    c = as_array(C, device=Vs.device)
    nj = Vs.shape[0]
    if nj == 0:
        return C
    conj_q = op != Op.NoTrans
    if op == Op.Trans and c.is_complex():
        raise SlateError("unmtr_he2hb: Op.Trans unsupported for complex; use 'c'")
    # Q = Q_0 Q_1 ... Q_{nj-1}: Q C / C Q^H apply blocks descending;
    # Q^H C / C Q apply ascending
    descending = (side == Side.Left) == (not conj_q)
    order = range(nj - 1, -1, -1) if descending else range(nj)
    for j in order:
        if side == Side.Left:
            c = hh.block_apply_left(Vs[j], Ts[j], c, conj_q=conj_q)
        else:
            c = hh.block_apply_right(Vs[j], Ts[j], c, conj_q=conj_q)
    return write_back(C, c)


def unmtr_hb2st(side, op, V, C, opts=None):
    """Apply the stage-2 (band -> tridiagonal) factor to C
    (src/unmtr_hb2st.cc).  ``V`` is the dense Q2 of
    ``hb2st(..., want_vectors=True)``."""
    return _apply_q(side, op, V, C)


def _two_sided(tau, v, D):
    """D := H^H D H for H = I - tau v v^H (herf, internal_hebr.cc)."""
    D = D - torch.outer(v * tau.conj(), torch.matmul(v.conj(), D))
    return D - torch.outer(torch.matmul(D, v) * tau, v.conj())


def _hebr1_window(W):
    """hebr1 on a (b+1, b+1) diagonal window: the reflector zeroing column 0
    below the first subdiagonal, and the two-sided update.  Returns
    (W_updated, v, tau)."""
    W = W.clone()
    x = W[1:, 0]
    v, tau, _ = hh.larfg(x)
    xn = x - v * (tau.conj() * torch.vdot(v, x))
    W[0, 1:] = xn.conj()
    W[1:, 0] = xn
    W[1:, 1:] = _two_sided(tau, v, W[1:, 1:])
    return W, v, tau


def _chase_extract(Ap, n):
    """(d, e_complex) from the chased padded array."""
    T = Ap[:n, :n]
    return torch.diagonal(T).real.clone(), torch.diagonal(T, -1).clone()


def _chase_setup(Afull, kd):
    """The zero-padded (N, N) work array of a chase, N, and m_max (the chase
    blocks of the longest sweep), shared by the hb2st and tb2bd chases."""
    n = Afull.shape[-1]
    N = n + 2 * kd + 2
    Ap = torch.zeros((N, N), dtype=Afull.dtype, device=Afull.device)
    Ap[:n, :n] = Afull
    return Ap, N, max(-(-(n - 1) // kd), 1)


def _hb2st_chase(Afull: torch.Tensor, kd: int):
    """The sequential bulge chase: full Hermitian band (bandwidth kd >= 2) ->
    complex-subdiagonal tridiagonal, through the reference's task types
    (internal_hebr.cc hebr1/hebr2/hebr3; scheduling hb2st.cc:44-160).

    Per sweep s: hebr1 zeroes column s below its first subdiagonal; then for
    r = 1, 2, ... hebr2 right-applies the previous reflector to the window at
    (r·kd+1+s, (r-1)·kd+1+s), a new reflector zeroes the window's first
    column, and hebr3 two-sides the diagonal window.  The JAX package sends
    steps past the matrix edge into the zero padding, where they are no-ops
    that store the reflector ``e_0`` with tau 0; here they are skipped and
    that reflector is stored directly.  About 35 launches per active step.

    Returns (d, e_complex, Vs, taus), reflectors stacked (n_sweeps, m_max, kd).
    """
    n = Afull.shape[-1]
    b = kd
    Ap, _, m_max = _chase_setup(Afull, kd)
    n_sweeps = max(n - 2, 0)
    dt, dev = Afull.dtype, Afull.device
    Vs = torch.zeros((n_sweeps, m_max, b), dtype=dt, device=dev)
    taus = torch.zeros((n_sweeps, m_max), dtype=dt, device=dev)
    for s in range(n_sweeps):
        W, v, tau = _hebr1_window(Ap[s:s + b + 1, s:s + b + 1])
        Ap[s:s + b + 1, s:s + b + 1] = W
        Vs[s, 0] = v
        taus[s, 0] = tau
        m_s = -(-(n - 1 - s) // b)          # steps whose window starts inside
        Vs[s, m_s:, 0] = 1.0
        for r in range(1, m_s):
            i = r * b + 1 + s
            j = (r - 1) * b + 1 + s
            W = Ap[i:i + b, j:j + b]
            W = W - torch.outer(torch.matmul(W, v) * tau, v.conj())
            v, tau, _ = hh.larfg(W[:, 0])
            W = W - torch.outer(v * tau.conj(), torch.matmul(v.conj(), W))
            Ap[i:i + b, j:j + b] = W
            Ap[j:j + b, i:i + b] = W.mH
            Ap[i:i + b, i:i + b] = _two_sided(tau, v, Ap[i:i + b, i:i + b])
            Vs[s, r] = v
            taus[s, r] = tau
    d, e_c = _chase_extract(Ap, n)
    return d, e_c, Vs, taus


def _pipeline_schedule(n: int, b: int, n_sweeps: int, m_max: int,
                       bidiag: bool = False):
    """The static schedule of the pipelined chases (hb2st.cc:147-182): sweep s
    starts at round 2s and advances one block per round; ``B = m_max//2 + 2``
    slots hold the live fronts (slot s % B).  Returns ``(B, T, start, R, S,
    LIVE)``: the slot count, the round count, per round the sweep starting
    (-1 if none), and per round and slot the block index r, the sweep s and
    whether the slot is live — ``r < ceil((n-1-s)/b)`` for hb2st, the column
    block ``r·b+1+s`` inside the matrix for the bidiagonal chase."""
    B = m_max // 2 + 2
    T = 2 * n_sweeps + m_max
    s_st = np.full(B, -1, np.int64)
    r_st = np.zeros(B, np.int64)
    start = np.full(T, -1, np.int64)
    R = np.zeros((T, B), np.int64)
    S = np.zeros((T, B), np.int64)
    LIVE = np.zeros((T, B), bool)
    for t in range(T):
        s0 = t // 2
        if t % 2 == 0 and s0 < n_sweeps:
            start[t] = s0
            s_st[s0 % B] = s0
            r_st[s0 % B] = 1
        if bidiag:    # tb2bd: live while the column block starts inside
            live = (s_st >= 0) & (r_st >= 1) & (r_st * b + 1 + s_st < n)
        else:         # hb2st: live while r < m_s
            live = (s_st >= 0) & (r_st >= 1) & (r_st < (n - 1 - s_st + b - 1) // b)
        R[t], S[t], LIVE[t] = r_st, s_st, live
        r_st = np.where(live, r_st + 1, r_st)
    return B, T, start, R, S, LIVE


def _hb2st_chase_pipelined(Afull: torch.Tensor, kd: int):
    """Multi-sweep pipelined bulge chase: the reference's pass/step scheduling
    (hb2st.cc:147-182) in batched rounds.  Concurrent sweeps sit two blocks
    apart, so their window footprints are element-disjoint; each round runs
    the hebr1 of the starting sweep (if any) and one batched hebr2+hebr3 pair
    over all slots.  Dead slots point at the zero padding: they gather zeros
    and scatter zeros, so the duplicate indices they share write only zeros
    and the unordered ``index_put_`` on the card cannot matter.  Their
    reflectors (all ``e_0`` with tau 0) go to a scratch row that is dropped.

    About 60 launches per round, ``2(n-2) + m_max`` rounds, no host sync.
    Returns (d, e_complex, Vs, taus) like ``_hb2st_chase`` (dead steps store
    zero reflectors where the sequential chase stores ``e_0``; both are H=I).
    """
    n = Afull.shape[-1]
    b = kd
    Ap, N, m_max = _chase_setup(Afull, kd)
    n_sweeps = max(n - 2, 0)
    dt, dev = Afull.dtype, Afull.device
    B, T, start, R, S, LIVE = _pipeline_schedule(n, b, n_sweeps, m_max)
    zi, zj = n + b + 1, n + 1      # zero-padding anchors for dead slots
    I = np.where(LIVE, R * b + 1 + S, zi)
    J = np.where(LIVE, (R - 1) * b + 1 + S, zj)
    SR = np.where(LIVE, S * m_max + R, n_sweeps * m_max)   # flat (s, r) slot
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    baseW = up(I) * N + up(J)       # flat index of each window's corner
    baseM = up(J) * N + up(I)
    baseD = up(I) * N + up(I)
    ar = torch.arange(b, device=dev)
    off = ar[:, None] * N + ar[None, :]
    sr = up(SR)
    Vs = torch.zeros(((n_sweeps + 1) * m_max, b), dtype=dt, device=dev)
    taus = torch.zeros(((n_sweeps + 1) * m_max,), dtype=dt, device=dev)
    vprev = torch.zeros((B, b), dtype=dt, device=dev)
    tprev = torch.zeros((B,), dtype=dt, device=dev)
    Apf = Ap.view(-1)
    for t in range(T):
        s0 = int(start[t])
        if s0 >= 0:                                    # hebr1 of sweep s0
            W, v0, tau0 = _hebr1_window(Ap[s0:s0 + b + 1, s0:s0 + b + 1])
            Ap[s0:s0 + b + 1, s0:s0 + b + 1] = W
            Vs[s0 * m_max] = v0
            taus[s0 * m_max] = tau0
            vprev[s0 % B] = v0
            tprev[s0 % B] = tau0
        iw = baseW[t][:, None, None] + off
        Wb = Apf[iw]                                   # (B, b, b) gather
        # hebr2: right-apply the previous reflector (the bulge), then a new
        # left reflector zeroing the window's first column
        Wv = torch.matmul(Wb, vprev[:, :, None])
        Wb = Wb - (tprev[:, None, None] * Wv) * vprev.conj()[:, None, :]
        v, tau, _ = hh.larfg(Wb[:, :, 0])
        vW = torch.matmul(v.conj()[:, None, :], Wb)
        Wb = Wb - (tau.conj()[:, None, None] * v[:, :, None]) * vW
        Apf[iw] = Wb
        Apf[baseM[t][:, None, None] + off] = Wb.mH
        # hebr3: two-sided on the diagonal window
        idd = baseD[t][:, None, None] + off
        Db = Apf[idd]
        Dv = torch.matmul(v.conj()[:, None, :], Db)
        Db = Db - (tau.conj()[:, None, None] * v[:, :, None]) * Dv
        Dw = torch.matmul(Db, v[:, :, None])
        Db = Db - (tau[:, None, None] * Dw) * v.conj()[:, None, :]
        Apf[idd] = Db
        # dead slots: v = e_0, tau = 0, into the dropped scratch row; their
        # vprev is never read before the slot's next start overwrites it
        Vs[sr[t]] = v
        taus[sr[t]] = tau
        vprev, tprev = v, tau
    d, e_c = _chase_extract(Ap, n)
    Vs = Vs.view(n_sweeps + 1, m_max, b)[:n_sweeps]
    taus = taus.view(n_sweeps + 1, m_max)[:n_sweeps]
    return d, e_c, Vs, taus


def _hb2st_q(Vs, taus, n: int, b: int) -> torch.Tensor:
    """Materialize Q2 = prod_{s,r} H_{s,r} (chronological) from the chase
    reflectors (unmtr_hb2st.cc analogue)."""
    return hh.sweep_accumulate(Vs, taus, n, b)


def _band_full(b_arr: torch.Tensor) -> torch.Tensor:
    """The full dense Hermitian band from full, lower- or upper-stored input
    (two host syncs: which triangles hold data)."""
    lower = torch.tril(b_arr, -1)
    upper = torch.triu(b_arr, 1)
    diag_part = torch.diag_embed(torch.diagonal(b_arr).real.to(b_arr.dtype))
    have_lower = bool(torch.any(lower.abs() > 0))
    if have_lower and bool(torch.any(upper.abs() > 0)):
        return diag_part + lower + upper
    if have_lower:
        return diag_part + lower + lower.mH
    return diag_part + upper + upper.mH


def _pipelined(pipeline: Optional[bool], t: torch.Tensor) -> bool:
    """The chase switch of every driver and stage here and in :mod:`.svd`:
    ``None`` (the default) picks the pipelined chase for a CUDA tensor, where
    the sequential chase's ``n·m_max`` window steps are launch-bound, and the
    sequential one elsewhere (the JAX package's default); a bool forces it."""
    return t.is_cuda if pipeline is None else bool(pipeline)


def _hb2st_run_chase(b_arr: torch.Tensor, kd: int, pipeline: Optional[bool]):
    """Normalize band storage and run the chase; returns (d, e_c, Vs, taus)."""
    chase = _hb2st_chase_pipelined if _pipelined(pipeline, b_arr) else _hb2st_chase
    return chase(_band_full(b_arr), kd)


def hb2st_reflectors(band, kd: Optional[int] = None,
                     pipeline: Optional[bool] = None):
    """Stage-2 chase returning the reflector-level output (d, e_c, Vs, taus)
    without materializing Q2 (the hook of the thin back-transforms).
    Requires kd > 1 and n > 2."""
    b_arr = as_array(band)
    if kd is None:
        kd = _infer_bandwidth(b_arr)
    n = b_arr.shape[-1]
    slate_assert(kd > 1 and n > 2, "hb2st_reflectors needs kd > 1 and n > 2 (no chase below)")
    return _hb2st_run_chase(b_arr, kd, pipeline)


def _infer_bandwidth(b) -> int:
    """The bandwidth of a concrete band matrix (one host copy)."""
    arr = np.asarray(b.detach().cpu()) if isinstance(b, torch.Tensor) else np.asarray(b)
    nz = np.nonzero(np.abs(arr).sum(axis=tuple(range(arr.ndim - 2))) > 0)
    if len(nz[0]) == 0:
        return 1
    return max(1, int(np.max(np.abs(nz[0] - nz[1]))))


def hb2st(band, kd: Optional[int] = None, opts=None, want_vectors: bool = False,
          pipeline: Optional[bool] = None):
    """Stage 2: band -> real symmetric tridiagonal by bulge chasing
    (src/hb2st.cc; task kernels internal_hebr.cc).

    ``kd`` is the bandwidth (inferred from the data when omitted).  The band
    may be full, lower- or upper-stored.  Returns (d, e) or (d, e, Q2) with
    band = Q2 T Q2^H.  ``pipeline=True`` runs the multi-sweep batched chase
    (``2(n-2) + m_max`` rounds in place of ``n·m_max`` steps), the default
    for a CUDA tensor (:func:`_pipelined`).  A leading batch dimension
    chases each band in turn."""
    b_arr = as_array(band)
    if kd is None:
        kd = _infer_bandwidth(b_arr)
    if b_arr.ndim > 2:
        n = b_arr.shape[-1]
        outs = [hb2st(x, kd=kd, opts=opts, want_vectors=want_vectors, pipeline=pipeline)
                for x in b_arr.reshape(-1, n, n)]
        lead = b_arr.shape[:-2]
        return tuple(torch.stack([o[i] for o in outs]).reshape(lead + outs[0][i].shape)
                     for i in range(len(outs[0])))
    n = b_arr.shape[-1]
    if kd > 1 and n > 2:
        d, e_c, Vs, taus = _hb2st_run_chase(b_arr, kd, pipeline)
        e = e_c.abs()
        if not want_vectors:
            return d, e
        Q2 = _hb2st_q(Vs, taus, n, kd) * _phase_vector(e_c.to(b_arr.dtype))[None, :]
        return d, e, Q2
    # kd == 1 (or trivial n): extraction + phase rotation only
    d = torch.diagonal(b_arr, dim1=-2, dim2=-1).real
    if n > 1:
        e_c = torch.diagonal(b_arr, -1)
        e_c = torch.where(e_c.abs() > 0, e_c, torch.diagonal(b_arr, 1).conj())
    else:
        e_c = torch.zeros((0,), dtype=b_arr.dtype, device=b_arr.device)
    e = e_c.abs()
    if not want_vectors:
        return d, e
    return d, e, torch.diag_embed(_phase_vector(e_c))


def _phase_vector(e_c: torch.Tensor) -> torch.Tensor:
    """Cumulative phases p (p[0]=1, p[k+1] = p[k]·e_k/|e_k|), so that with
    D = diag(p) the complex tridiagonal T_c = D T_real D^H."""
    mag = e_c.abs()
    one = torch.ones((), dtype=e_c.dtype, device=e_c.device)
    ph = torch.where(mag > 0, e_c / torch.where(mag > 0, mag, 1.0).to(e_c.dtype), one)
    return torch.cat([torch.ones_like(ph[..., :1]), torch.cumprod(ph, dim=-1)], dim=-1)


# below this, one library eigvalsh beats the setup of the O(n²) paths; above
# it the dense formulations are the wrong complexity class
_STEV_DENSE_MAX = 512


def sterf(d, e, opts=None):
    """Eigenvalues of a real symmetric tridiagonal (src/sterf.cc): Sturm
    bisection (:func:`.sturm.sterf_bisect`) above ``_STEV_DENSE_MAX``, one
    library eigvalsh at or below it."""
    d = as_array(d)
    if d.shape[-1] <= _STEV_DENSE_MAX:
        return _library_eigh(_assemble_tridiag(d, as_array(e, device=d.device)),
                             want_vectors=False)[0]
    from .sturm import sterf_bisect

    return sterf_bisect(d, e)


def steqr(d, e, Z: Optional[torch.Tensor] = None, opts=None):
    """Tridiagonal QR iteration with optional eigenvector accumulation
    (src/steqr.cc; the (ascending lam, Z @ Q) contract of stedc), implicit
    shifts at every size (:mod:`.steqr_qr`).  ``opts`` is accepted for the
    driver signature; the iteration has no tunables."""
    del opts
    from .steqr_qr import steqr_qr

    return steqr_qr(d, e, Z)


def stedc(d, e, Z: Optional[torch.Tensor] = None, opts=None):
    """Divide & conquer tridiagonal eigensolver (src/stedc.cc family; see
    :mod:`.stedc`)."""
    from .stedc import stedc as _stedc_impl

    return _stedc_impl(d, e, Z, opts)


steqr2 = steqr   # the reference's steqr2 is a deprecated alias (slate.hh:1295)

# real-symmetric spellings (slate.hh declares syev/sygv/sygst beside he*)
syev = heev
sygv = hegv
sygst = hegst
