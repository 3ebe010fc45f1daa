"""QR/LQ factorizations and least squares: geqrf / gelqf / unmqr / unmlq / tsqr (CAQR)
/ cholqr / gels.

Reference analogue: ``src/geqrf.cc``, ``src/gelqf.cc``, ``src/{unmqr,unmlq}.cc``,
``src/cholqr.cc``, ``src/{gels,gels_qr,gels_cholqr}.cc``; ``TriangularFactors`` is
the reference's ``vector<Matrix>`` of block-reflector T factors (slate.hh:857).

As in the JAX package:

* **Panel QR** is the library Householder factorization (``torch.geqrf``, already
  in LAPACK's packed layout: R above the diagonal, the reflectors V below).
* **Block reflector T** in closed form: with V the unit lower trapezoid and
  S = V^H V, ``T = inv(triu(S, 1) + diag(1/tau))`` — one gemm plus one k x k
  triangular solve.
* **Applying Q** (unmqr/unmlq) is three gemms: Q^H C = C - V (T^H (V^H C)).
* **TSQR** is leaf QRs over row blocks (one batched QR) and a binary tree of
  stacked-R QRs; Q is rebuilt down the tree.
* **CholQR** is CholeskyQR2 with a shifted retry when the Gram matrix is
  numerically indefinite and a Householder escape when it is rank-deficient;
  the least squares take corrected semi-normal equations (CSNE) with the same
  escape.

The JAX package runs cholqr's and CSNE's branches as ``lax.cond`` inside one
compiled program.  Here each branch is a host decision: cholqr syncs twice
(the first pass's and the second pass's ``info``), CSNE once (its health
verdict), and only the taken branch runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.exceptions import SlateError
from ..core.matrix import BaseMatrix, as_array, distribution_grid, to_tensor, write_back
from ..core.types import MethodGels, Op, Options, Side
from ..obs import instrument
from ..ops.blas3 import gram
from ..robust import inject
from ..utils.trace import trace_block
from .chol import _chol_blocked, _chol_info


@dataclasses.dataclass
class TriangularFactors:
    """Block-Householder factors (reference TriangularFactors, slate.hh:857):
    ``packed`` holds R in the upper triangle and the reflector columns V below the
    diagonal (LAPACK geqrf layout); ``tau`` the reflector scalars; ``T`` the k x k
    block-reflector triangle."""

    packed: torch.Tensor   # (m, n)
    tau: torch.Tensor      # (k,)
    T: Optional[torch.Tensor]   # (k, k) upper triangular

    @classmethod
    def from_reference(cls, d, device=None) -> "TriangularFactors":
        """The port's factors from a JAX-package ``TriangularFactors``.

        ``d`` is that object or a dict with its ``packed``, ``tau`` and ``T``
        (numpy arrays; ``T`` None or absent rebuilds it from V and tau).
        Placed on ``device`` (default ``cuda``)."""
        get = d.get if isinstance(d, dict) else lambda k, v=None: getattr(d, k, v)
        packed = to_tensor(get("packed"), device)
        tau = to_tensor(get("tau"), packed.device)
        T = get("T")
        fac = cls(packed=packed, tau=tau, T=None)
        fac.T = _block_T(fac.V(), tau) if T is None else to_tensor(T, packed.device)
        return fac

    @property
    def m(self):
        return self.packed.shape[-2]

    @property
    def k(self):
        return self.tau.shape[-1]

    def V(self) -> torch.Tensor:
        """Unit lower-trapezoid reflector matrix."""
        V = torch.tril(self.packed, -1)[..., :, :self.k]
        V.diagonal(dim1=-2, dim2=-1).fill_(1)
        return V

    def Q(self, full: bool = False) -> torch.Tensor:
        """Materialize the (reduced) orthogonal factor via householder_product."""
        if not full:
            return torch.linalg.householder_product(self.packed, self.tau)
        m, k = self.m, self.k
        pad = self.packed.new_zeros(self.packed.shape[:-1] + (m - k,))
        packed_f = torch.cat([self.packed[..., :, :k], pad], dim=-1)
        tau_f = torch.cat([self.tau, self.tau.new_zeros(self.tau.shape[:-1] + (m - k,))],
                          dim=-1)
        return torch.linalg.householder_product(packed_f, tau_f)

    def R(self) -> torch.Tensor:
        return torch.triu(self.packed[..., : self.k, :])


def _block_T(V, tau):
    """Closed-form block-reflector triangle: T = inv(triu(S,1) + diag(1/tau)),
    S = V^H V (see module docstring)."""
    S = torch.matmul(V.mH, V)
    inv_tau = torch.where(tau == 0, torch.full_like(tau, float("inf")), 1.0 / tau)
    Tinv = torch.triu(S, 1) + torch.diag_embed(inv_tau)
    k = tau.shape[-1]
    eye = torch.eye(k, dtype=V.dtype, device=V.device)
    T = torch.linalg.solve_triangular(Tinv, eye, upper=True)
    # zero columns where tau == 0 (identity reflectors contribute nothing)
    return torch.where(tau[..., None, :] == 0, torch.zeros_like(T), T)


@instrument
def geqrf(A, opts=None):
    """QR factorization A = Q R (src/geqrf.cc). Returns TriangularFactors; writes the
    packed factor back into a Matrix wrapper (R in the upper triangle, V below)."""
    opts = Options.make(opts)
    a = inject("geqrf", as_array(A))
    m, n = a.shape[-2:]
    with trace_block("geqrf", m=m, n=n):
        packed, tau = torch.geqrf(a)
        fac = TriangularFactors(packed=packed, tau=tau, T=None)
        fac.T = _block_T(fac.V(), tau)
    if isinstance(A, BaseMatrix):
        write_back(A, packed)
    return fac


@instrument
def gelqf(A, opts=None):
    """LQ factorization A = L Q (src/gelqf.cc) via QR of A^H: A^H = Q1 R1 =>
    A = R1^H Q1^H. Returns TriangularFactors of A^H."""
    a = as_array(A)
    fac = geqrf(a.mH, opts)
    if isinstance(A, BaseMatrix):
        write_back(A, fac.packed.mH.resolve_conj())
    return fac


def unmqr(side, op, factors: TriangularFactors, C, opts=None):
    """Multiply by Q from geqrf (src/unmqr.cc): C := op(Q) C or C op(Q) using the
    compact WY form, Q = I - V T V^H."""
    side = Side.from_string(side)
    op = Op.from_string(op)
    V = factors.V()
    T = factors.T
    c = as_array(C, device=V.device)
    if op == Op.Trans and c.is_complex():
        # LAPACK unmqr likewise rejects plain transpose for complex factors
        raise SlateError("unmqr: Op.Trans unsupported for complex; use ConjTrans")
    Tm = T if op == Op.NoTrans else T.mH
    with trace_block("unmqr"):
        if side == Side.Left:
            # op(Q) C = C - V op(T) (V^H C)
            out = c - torch.matmul(V, torch.matmul(Tm, torch.matmul(V.mH, c)))
        else:
            # C op(Q) = C - (C V) op(T) V^H
            out = c - torch.matmul(torch.matmul(torch.matmul(c, V), Tm), V.mH)
    return write_back(C, out)


def unmlq(side, op, factors: TriangularFactors, C, opts=None):
    """Multiply by Q from gelqf (src/unmlq.cc). With A = L Q, Q = Q1^H where Q1 is
    the QR factor of A^H, so op(Q) flips the op on Q1."""
    op = Op.from_string(op)
    if op == Op.Trans and factors.packed.is_complex():
        raise SlateError("unmlq: Op.Trans unsupported for complex; use ConjTrans")
    flip = {Op.NoTrans: Op.ConjTrans, Op.ConjTrans: Op.NoTrans,
            Op.Trans: Op.NoTrans}[op]
    return unmqr(side, flip, factors, C, opts)


# ---------------------------------------------------------------------------
# TSQR / CAQR tree
# ---------------------------------------------------------------------------


def _qr(a):
    return torch.linalg.qr(a, mode="reduced")


def tsqr(a, row_blocks: int = 0, nb: int = 1024):
    """Tall-skinny QR by binary tree reduction (the CAQR pattern of
    internal_ttqrt.cc: leaf QRs + pairwise triangle-triangle QRs up the tree).

    Returns (Q, R) with Q explicit reduced (m x n).
    """
    a = as_array(a)
    m, n = a.shape[-2:]
    if row_blocks <= 0:
        row_blocks = max(1, min(m // max(n, 1), -(-m // nb)))
    if row_blocks <= 1 or m < 2 * n:
        return _qr(a)

    # split into row blocks (pad to equal size)
    bs = -(-m // row_blocks)
    pad = bs * row_blocks - m
    ap = torch.cat([a, a.new_zeros((pad, n))], dim=0) if pad else a
    blocks = ap.reshape(row_blocks, bs, n)
    Qs, Rs = _qr(blocks)            # leaf QRs, batched
    levels = [Qs]                   # per-level Q stacks
    while Rs.shape[0] > 1:
        nblk = Rs.shape[0]
        if nblk % 2 == 1:
            Rs = torch.cat([Rs, Rs.new_zeros((1, n, n))], dim=0)
            nblk += 1
        Qp, Rs = _qr(Rs.reshape(nblk // 2, 2 * n, n))
        levels.append(Qp)
    R = Rs[0]
    # reconstruct Q down the tree: start from the root's identity coupling
    Qacc = torch.eye(n, dtype=a.dtype, device=a.device)[None]     # (1, n, n)
    for Qp in reversed(levels[1:]):
        npair = Qp.shape[0]
        # each pair contributes two n-row slices of Q
        Qacc = torch.matmul(Qp, Qacc[:npair]).reshape(npair * 2, n, n)
    Qacc = Qacc[: levels[0].shape[0]]
    Q = torch.matmul(levels[0], Qacc).reshape(row_blocks * bs, n)[:m]
    return Q, R


@instrument
def cholqr(A, opts=None):
    """Cholesky QR (src/cholqr.cc): R = chol(A^H A)^H upper, Q = A R^{-1}, with a
    CholeskyQR2 second pass for orthogonality and a shifted retry if the Gram matrix
    is numerically indefinite. Returns (Q, R).

    The cholqr→shifted→Householder escalation (robust.LADDERS["cholqr"]) is
    two host checks of the passes' ``info``; only the taken branch runs."""
    opts = Options.make(opts)
    a = inject("cholqr", as_array(A))
    m, n = a.shape[-2:]

    def q_from_chol(L, x):
        # Q = x · L^{-H} by inverting the small n×n triangle and one gemm (the
        # trtri+gemm trsm shape: a right-side triangular solve over the tall x
        # is the memory hot spot at 131072×4096); CholeskyQR2's second pass
        # absorbs the extra rounding of the explicit inverse
        eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return torch.matmul(x, Linv.mH)

    def one_pass(x):
        # herk-halved Gram + recursive blocked factor of the n x n result
        L = _chol_blocked(gram(x))
        return q_from_chol(L, x), L.mH, _chol_info(L)

    def shifted_pass(x):
        # shifted retry (stabilized CholeskyQR): shift Gram by ~11(mn+n^2) eps ||A||^2
        eps = torch.finfo(x.real.dtype).eps
        shift = 11.0 * (m * n + n * (n + 1)) * eps * torch.linalg.vector_norm(x) ** 2
        G = gram(x) + shift * torch.eye(n, dtype=x.dtype, device=x.device)
        L = _chol_blocked(G)
        return q_from_chol(L, x), L.mH

    with trace_block("cholqr", m=m, n=n):
        Q1, R1, info = one_pass(a)
        if int(info) != 0:
            Q1, R1 = shifted_pass(a)
        # CholeskyQR2: re-orthogonalize
        Q2, R2, info2 = one_pass(Q1)
        if int(info2) != 0:
            # rank-deficient input: the Gram route cannot recover — Householder
            # QR (the reference's MethodCholQR -> MethodGels::QR fallback)
            return _qr(a)
    return Q2, torch.matmul(R2, R1)


def _normal_solve(L, rhs):
    """x with L L^H x = rhs (L lower): the two triangular sweeps."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mH, y, upper=True)


def _csne(a, b):
    """Raw CSNE: R^H R x = A^H b with R from Cholesky of the Gram matrix, plus
    one corrected step.  Returns (x, Gram Cholesky info); no host sync."""
    ah = a.mH
    # herk-halved Gram (the dominant 2mn^2 of the whole job) + recursive
    # blocked factor of the n x n result
    L = _chol_blocked(gram(a))
    x = _normal_solve(L, torch.matmul(ah, b))
    # one corrected step (the "C" in CSNE)
    r = b - torch.matmul(a, x)
    return x + _normal_solve(L, torch.matmul(ah, r)), _chol_info(L)


def _gels_csne(a, b):
    """Overdetermined least squares by corrected semi-normal equations
    (Björck's CSNE, the JAX package's form of the reference's CholQR least
    squares, src/gels_cholqr.cc): one Gram product plus thin products, O(n²)
    extra memory, no tall Q.

    Rank-deficient or borderline-conditioned inputs (Cholesky of the Gram
    fails, or the solve goes non-finite) fall back to Householder QR with the
    vanishing R diagonals clamped at sqrt(eps)·max|d|.  One host sync (the
    health verdict); the QR branch runs only when taken."""
    x, info = _csne(a, b)
    if not bool((info != 0) | ~torch.isfinite(x).all()):
        return x
    Q, R = _qr(a)
    # this branch only runs when the Gram route failed, i.e. A may be
    # numerically rank-deficient: clamp vanishing R diagonals at
    # sqrt(eps)·max|d| so the null directions get negligible (not
    # catastrophic) weight
    d = torch.diagonal(R, dim1=-2, dim2=-1)
    tol = torch.finfo(R.real.dtype).eps ** 0.5 * torch.amax(d.abs())
    sign = torch.where(d.real < 0, -torch.ones_like(tol), torch.ones_like(tol))
    R.diagonal(dim1=-2, dim2=-1).copy_(torch.where(d.abs() < tol, (sign * tol).to(R.dtype), d))
    y = torch.matmul(Q.mH, b)
    return torch.linalg.solve_triangular(R, y, upper=True)


def _lq_min_norm(a, b):
    """Minimum-norm solution of a wide system via QR of a^H:
    a = R^H Q^H, x = Q R^{-H} b."""
    q, r = _qr(a.mH)
    y = torch.linalg.solve_triangular(r.mH, b, upper=False)
    return torch.matmul(q, y)


def gels_core(a, b):
    """Least-squares kernel — no wrappers, injection, tracing, or host syncs.
    The tall/square path is *raw* CSNE, without :func:`_gels_csne`'s
    Householder escape (the batched serving layer escalates a failed element
    through the full :func:`gels` driver instead); the wide path is the LQ
    minimum-norm solve through QR of ``a^H``.  The branch is static on shape.

    Returns ``(x, info)`` with x ``(n, nrhs)`` and info 0 on success, nonzero
    when the Gram Cholesky broke (its 1-based pivot index) or the solution is
    non-finite."""
    m, n = a.shape[-2:]
    if m >= n:
        x, ginfo = _csne(a, b)
    else:
        x = _lq_min_norm(a, b)
        ginfo = torch.zeros((), dtype=torch.int32, device=a.device)
    finite = torch.isfinite(x).flatten(-2).all(dim=-1)
    return x, torch.where(finite, ginfo, torch.clamp_min(ginfo, 1))


def _gels_grid(A, BX, grid, opts):
    """gels of wrappers bound to a >1-rank grid: the distributed least-squares
    pipelines on the operands' block layout (gels.cc consumes the
    construction-time distribution the same way); Auto takes the local
    path's CholQR-when-very-tall rule."""
    from ..parallel import (gather, gels_caqr_distributed, gels_cholqr_distributed,
                            gels_lq_distributed)

    a = A.dist_array() if isinstance(A, BaseMatrix) else as_array(A)
    b = BX.dist_array() if isinstance(BX, BaseMatrix) else as_array(BX, device=a.device)
    m, n = a.shape[-2:]
    if m < n:
        x = gather(gels_lq_distributed(a, b, grid, nb=opts.block_size))
    else:
        method = opts.method_gels
        if method == MethodGels.Auto:
            method = MethodGels.CholQR if m >= 4 * n else MethodGels.QR
        if method == MethodGels.CholQR:
            x = gels_cholqr_distributed(a, b, grid)
        else:
            x = gels_caqr_distributed(a, b, grid, nb=opts.block_size)
    return write_back(BX, x) if tuple(x.shape) == tuple(b.shape) else x


@instrument
def gels(A, BX, opts=None):
    """Least squares min ||A X - B|| / minimum-norm solve (src/gels.cc dispatch:
    MethodGels QR vs CholQR; src/gels_qr.cc, src/gels_cholqr.cc).

    Overdetermined (m >= n): X = R^{-1} Q^H B.  Underdetermined: minimum-norm via LQ.
    Returns the n x nrhs solution.

    Rank-deficiency note (differs from the reference): when the CholQR/CSNE
    route detects trouble (Gram Cholesky fails or the solve goes non-finite)
    it falls back to Householder QR *and clamps vanishing R diagonals* at
    sqrt(eps)·max|diag(R)|, i.e. numerically rank-deficient systems are
    regularized rather than erroring.  Callers who must detect rank
    deficiency should check ``abs(diagonal(R))`` from ``geqrf`` directly.
    """
    opts = Options.make(opts)
    grid = distribution_grid(A, BX)
    if grid is not None:
        return _gels_grid(A, BX, grid, opts)
    a = as_array(A)
    b = as_array(BX, device=a.device)
    m, n = a.shape[-2:]
    method = opts.method_gels
    if method == MethodGels.Auto:
        # cholqr for very tall panels (the reference's heuristic picks cholqr
        # when tall-skinny), qr otherwise
        method = MethodGels.CholQR if m >= 4 * n else MethodGels.QR

    with trace_block("gels", m=m, n=n, method=str(method)):
        if m >= n:
            if method == MethodGels.CholQR:
                x = _gels_csne(a, b)
            else:
                fac = geqrf(a, opts)
                y = unmqr("left", "c", fac, b)[..., :n, :]
                x = torch.linalg.solve_triangular(fac.R(), y, upper=True)
        else:
            # minimum-norm: A = L Q, x = Q^H L^{-1} b
            fac = gelqf(a, opts)
            L = fac.R().mH                                 # m x m lower
            vec = b.ndim == 1                              # a vector b gives a vector x
            y = torch.linalg.solve_triangular(L, b[:, None] if vec else b, upper=False)
            ypad = torch.cat([y, y.new_zeros((n - m,) + tuple(y.shape[1:]))], dim=0)
            x = unmqr("left", "n", fac, ypad)              # Q1 ypad = Q^H ypad
            if vec:
                x = x[:, 0]
    return write_back(BX, x) if (isinstance(BX, BaseMatrix)
                                 and as_array(BX).shape == x.shape) else x


def gels_qr(A, BX, opts=None):
    """Least squares via Householder QR explicitly (src/gels_qr.cc)."""
    return gels(A, BX, Options.make(opts).replace(method_gels=MethodGels.QR))


def gels_cholqr(A, BX, opts=None):
    """Least squares via CholeskyQR explicitly (src/gels_cholqr.cc).

    See :func:`gels` for the rank-deficient fallback-and-clamp behavior of
    this path (the QR fallback regularizes vanishing R diagonals)."""
    return gels(A, BX, Options.make(opts).replace(method_gels=MethodGels.CholQR))
