"""Cholesky family: potrf / potrs / posv / posv_core / trtri / trtrm / potri.

Reference analogue: ``src/potrf.cc:22-281`` (the canonical lookahead task-DAG driver,
SURVEY.md §3.1), ``src/{potrs,posv,potri,trtri,trtrm}.cc`` and the panel kernel
``src/internal/internal_potrf.cc``.

The blocked potrf pipeline, as in the JAX package:

* ``Target.Tiled`` runs the right-looking blocked recurrence: factor the diagonal
  block (a recursive blocked Cholesky over a library Cholesky at <= 256), one panel
  triangular solve, then the trailing herk as S trapezoidal gemms per step.  The
  trailing updates maintain only the lower triangle.  PyTorch runs it eagerly: the
  factor is one copy of the input, updated in place.
* ``Target.XLA`` (the name kept for API parity) and ``Auto`` hand the whole matrix
  to one library Cholesky (``torch.linalg.cholesky_ex``, cuSOLVER on the card).

``info`` follows the JAX package exactly.  XLA's Cholesky NaN-fills its output
when a pivot is not positive, where ``cholesky_ex`` returns a partial factor;
every library Cholesky call here marks a failure the way the JAX package's factor
shows it (:func:`_cholesky`, no host sync), so ``info`` computed from the factor
diagonal is the JAX package's code: the first index of the failing block, or the
pivot a NaN input first reaches.  ``Options.exact_info`` refines it on the host
to the LAPACK index of the first failing pivot.  Posv-mixed variants arrive with
the escalation ladders (ROADMAP.md queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.matrix import (BaseMatrix, HermitianMatrix, SymmetricMatrix, as_array,
                           distribution_grid, tri_to_full, write_back)
from ..core.types import Options, Target, Uplo
from ..obs import instrument
from ..robust import SolveReport, first_bad_index, first_bad_index_batched, inject
from ..utils.trace import trace_block


def _full_spd(A, uplo) -> torch.Tensor:
    """The full Hermitian matrix from a half-stored wrapper or tensor, as a new
    tensor (``uplo=None`` trusts the caller: already full, returned as is)."""
    if isinstance(A, (HermitianMatrix, SymmetricMatrix)):
        return A.full_array()
    a = as_array(A)
    if uplo is None:
        return a
    return tri_to_full(a, Uplo.from_string(uplo) == Uplo.Lower, herm=True)


def _chol_info(L) -> torch.Tensor:
    """LAPACK-style info from a lower factor: 0 if SPD, else 1-based index of the
    first non-positive/NaN pivot (one code per matrix of a batch)."""
    d = torch.diagonal(L, dim1=-2, dim2=-1).real
    bad = torch.isnan(d) | (d <= 0)
    return first_bad_index(bad) if bad.ndim == 1 else first_bad_index_batched(bad)


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Library Cholesky that reads only the lower triangle and, without a host
    sync, marks a failure the way the JAX package's factor does: a
    non-positive pivot NaN-fills the whole factor (XLA's contract), while a
    NaN in the leading minor flows on through the factorization, so the
    columns before the failing pivot stay and the rest is NaN.  Either way the
    first NaN on the diagonal is the failing block's info."""
    L, info = torch.linalg.cholesky_ex(a)
    n = a.shape[-1]
    failed = info != 0
    col = (info - 1).clamp_min(0)[..., None]                 # failing pivot
    nan_rows = torch.isnan(a).tril().any(dim=-1)             # (..., n)
    first_nan = first_bad_index_batched(nan_rows)[..., None]  # 1-based, 0: none
    nan_caused = (first_nan > 0) & (first_nan - 1 <= col)
    cols = torch.arange(n, device=a.device)
    fill = failed[..., None] & (~nan_caused | (cols >= col))
    return L.masked_fill_(fill[..., None, :], float("nan"))


def _host_chol_info(a, nb: int = 256) -> int:
    """Exact 1-based first-failing-pivot index, found by a host-side blocked
    factorization.  Runs only on the (exceptional) non-SPD path, because the
    NaN-filled factor loses the index the reference reports via its per-tile
    info codes (potrf.cc:208)."""
    a = a.detach().resolve_conj().cpu().numpy().copy() if isinstance(a, torch.Tensor) \
        else np.array(a, copy=True)
    n = a.shape[-1]
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        blk = a[k0:k1, k0:k1]
        try:
            Lkk = np.linalg.cholesky(blk)
        except np.linalg.LinAlgError:
            # scalar scan inside the failing block
            for j in range(k1 - k0):
                d = blk[j, j] - np.real(np.dot(blk[j, :j], np.conj(blk[j, :j])))
                if not (d > 0) or np.isnan(d):
                    return k0 + j + 1
                blk[j, j] = np.sqrt(d)
                if j + 1 < k1 - k0:
                    blk[j+1:, j] = (blk[j+1:, j]
                                    - blk[j+1:, :j] @ np.conj(blk[j, :j])) / blk[j, j]
            return k1  # shouldn't happen
        if k1 < n:
            # pan = A21 · Lkk^{-H}  (pan^H = Lkk^{-1} · A21^H)
            pan = np.linalg.solve(Lkk, a[k1:, k0:k1].conj().T).conj().T
            a[k1:, k1:] -= pan @ np.conj(pan.T)
            a[k1:, k0:k1] = pan
    return 0


_CHOL_BASE = 256


def _chol_blocked(a: torch.Tensor) -> torch.Tensor:
    """Recursive blocked Cholesky of one diagonal block: factor the leading
    half, one triangular solve, one Schur-complement gemm, recurse; the library
    Cholesky runs only at the <= 256 base.  Reads only the lower triangle of
    ``a`` (callers hand in blocks whose upper triangle is stale) and returns a
    new lower-triangular tensor."""
    n = a.shape[-1]
    if n <= _CHOL_BASE:
        return _cholesky(a)
    h = n // 2
    a11, a21, a22 = a[..., :h, :h], a[..., h:, :h], a[..., h:, h:]
    l11 = _chol_blocked(a11)
    # l21 · l11^H = a21
    l21 = torch.linalg.solve_triangular(l11.mH, a21, upper=True, left=False)
    l22 = _chol_blocked(a22 - torch.matmul(l21, l21.mH))
    out = torch.zeros_like(a)
    out[..., :h, :h] = l11
    out[..., h:, :h] = l21
    out[..., h:, h:] = l22
    return out


def _potrf_tiled(L: torch.Tensor, nb: int, inv_trsm: bool = False) -> torch.Tensor:
    """Blocked right-looking factorization of ``L`` in place (the JAX package's
    ``_potrf_tiled_fn``); returns ``L`` holding the lower factor, upper
    triangle zeroed.

    ``inv_trsm``: replace the panel triangular solve with an explicit
    inverse-apply — Linv = Lkk^{-1} once per step, then panel = A21 · Linv^H as
    a gemm (``Options.trsm_via_inverse``; ~cond(Lkk)² local error)."""
    n = L.shape[-1]
    nt = -(-n // nb)
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, n)
        # panel factor (≅ internal::potrf on the diagonal tile, potrf.cc:96-102)
        Lkk = _chol_blocked(L[k0:k1, k0:k1])
        L[k0:k1, k0:k1] = Lkk
        if k1 >= n:
            continue
        # panel trsm (≅ internal::trsm over the panel, potrf.cc:115-119)
        if inv_trsm:
            eye_b = torch.eye(k1 - k0, dtype=L.dtype, device=L.device)
            Linv = torch.linalg.solve_triangular(Lkk, eye_b, upper=False)
            panel = torch.matmul(L[k1:n, k0:k1], Linv.mH)
        else:
            panel = torch.linalg.solve_triangular(Lkk.mH, L[k1:n, k0:k1], upper=True,
                                                  left=False)
        L[k1:n, k0:k1] = panel
        # trailing update (≅ internal::herk, potrf.cc:136-148 — the hot loop):
        # one trapezoidal gemm per block-column group on/below the diagonal,
        # flop factor (1 + 1/S)/2 of the full square; S=1 past nt=32.  Only
        # the lower triangle of the trailing block is maintained.
        rem = nt - (k + 1)
        S = min(rem, 8) if nt <= 32 else 1
        for i in range(S):
            jb0 = k + 1 + (i * rem) // S
            jb1 = k + 1 + ((i + 1) * rem) // S
            j0, j1 = jb0 * nb, min(jb1 * nb, n)
            s = j0 - k1
            L[j0:n, j0:j1].addmm_(panel[s:, :], panel[s:j1 - k1, :].mH, alpha=-1)
    return L.tril_()


@instrument
def potrf(A, opts=None, uplo=None):
    """Cholesky factorization A = L L^H (src/potrf.cc:262-281 dispatch shape).

    Returns ``(L, info)``; writes the factor back into the stored triangle of ``A``
    if it is a Matrix wrapper.  ``uplo=Upper`` returns/stores U with A = U^H U.
    The caller's own tensor is never written: the full matrix is copied once and
    that copy is factored in place.
    """
    opts = Options.make(opts)
    the_uplo = _default_uplo(A, uplo)
    half = isinstance(A, (HermitianMatrix, SymmetricMatrix))
    Af = _full_spd(A, None if half else the_uplo)
    Af = inject("potrf", Af)
    n = Af.shape[-1]
    target = opts.target
    if target == Target.Auto:
        target = Target.XLA  # single fused factorization
    distribution_grid(A)
    with trace_block("potrf", n=n, nb=opts.block_size, target=str(target)):
        if target == Target.XLA:
            L = torch.tril(_cholesky(Af))
        else:
            # Af is already a copy of the input: factor it in place (keep it
            # intact only when exact_info may need to re-read it)
            L = _potrf_tiled(Af.clone() if opts.exact_info else Af,
                             min(opts.block_size, n), inv_trsm=opts.trsm_via_inverse)
    info = _chol_info(L)
    if opts.exact_info and int(info) != 0:
        # opt-in host refinement (a device→host sync on every call)
        info = torch.tensor(_host_chol_info(Af), dtype=torch.int32, device=L.device)

    out = L if the_uplo == Uplo.Lower else L.mH.resolve_conj()
    if isinstance(A, BaseMatrix):
        # store only into the stored triangle, leave the rest untouched
        stored = as_array(A)
        tri = torch.tril if the_uplo == Uplo.Lower else torch.triu
        mask = tri(torch.ones(stored.shape, dtype=torch.bool, device=stored.device))
        write_back(A, torch.where(mask, out, stored))
    return out, info


def _solve_chol(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L^H x = b (L lower): the two triangular sweeps."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mH, y, upper=True)


def posv_core(a, b):
    """Pure single-matrix posv kernel: Cholesky + the two triangular sweeps — no
    wrappers, injection, tracing, or host syncs.  Expects the *full* Hermitian
    matrix; a leading batch dimension gives one ``info`` per matrix.  Returns
    ``(x, info)``."""
    L = _cholesky(a)
    return _solve_chol(L, b), _chol_info(L)


def potrs(A, B, opts=None, uplo=None):
    """Solve A X = B given the Cholesky factor (src/potrs.cc: two work::trsm calls)."""
    the_uplo = _default_uplo(A, uplo)
    F = as_array(A)
    L = torch.tril(F) if the_uplo == Uplo.Lower else torch.triu(F).mH
    b = as_array(B, device=F.device)
    with trace_block("potrs"):
        x = _solve_chol(L, b)
    return write_back(B, x)


@instrument
def posv(A, B, opts=None, uplo=None):
    """Solve SPD system A X = B (src/posv.cc = potrf + potrs).

    Returns (X, info); with ``Options(solve_report=True)``,
    (X, info, SolveReport)."""
    opts = Options.make(opts)
    L, info = potrf(A, opts, uplo)
    X = potrs(L if not isinstance(A, BaseMatrix) else A, B, opts,
              uplo=_default_uplo(A, uplo))
    if opts.solve_report:
        report = SolveReport(routine="posv", info=int(info),
                             precision_used=str(as_array(L).dtype).removeprefix("torch."),
                             fallback_chain=("cholesky",)).finalize()
        report.recovered = report.info == 0
        return X, info, report
    return X, info


def trtri(A, opts=None, uplo=None, diag=None):
    """Triangular inverse (src/trtri.cc): one blocked triangular solve against
    the identity."""
    from ..blas import _diag_of  # local import to avoid cycle
    the_uplo = _default_uplo(A, uplo)
    the_diag = _diag_of(A, diag)
    a = as_array(A)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    with trace_block("trtri", n=n):
        inv = torch.linalg.solve_triangular(
            a, eye, upper=(the_uplo == Uplo.Upper),
            unitriangular=(the_diag.value == "unit"))
    tri = torch.tril if the_uplo == Uplo.Lower else torch.triu
    return _write_triangle(A, tri(inv), the_uplo)


def trtrm(A, opts=None, uplo=None):
    """Triangular-triangular multiply L^H L (or U U^H) producing a Hermitian result in
    the stored triangle — the second half of potri (src/trtrm.cc)."""
    the_uplo = _default_uplo(A, uplo)
    a = as_array(A)
    if the_uplo == Uplo.Lower:
        L = torch.tril(a)
        res = torch.tril(torch.matmul(L.mH, L))
    else:
        U = torch.triu(a)
        res = torch.triu(torch.matmul(U, U.mH))
    return _write_triangle(A, res, the_uplo)


def _default_uplo(A, uplo) -> Uplo:
    """Resolve uplo like the sibling drivers: wrapper flag, else Lower."""
    return Uplo.from_string(uplo or (A.uplo if isinstance(A, BaseMatrix)
                                     and A.uplo != Uplo.General else Uplo.Lower))


def _write_triangle(A, tri_result, uplo: Uplo):
    """Write a triangular result into only the stored triangle of a wrapper,
    preserving the unstored triangle (matches potrf's write-back discipline)."""
    if not isinstance(A, BaseMatrix):
        return tri_result
    stored = as_array(A)
    tri = torch.tril if uplo == Uplo.Lower else torch.triu
    mask = tri(torch.ones(stored.shape, dtype=torch.bool, device=stored.device))
    write_back(A, torch.where(mask, tri_result, stored))
    return tri_result


@instrument
def potri(A, opts=None, uplo=None):
    """SPD inverse from the Cholesky factor: A^{-1} = L^{-H} L^{-1}
    (src/potri.cc = trtri + trtrm)."""
    the_uplo = _default_uplo(A, uplo)
    Linv = trtri(A, opts, uplo=the_uplo, diag="nonunit")
    return trtrm(A if isinstance(A, BaseMatrix) else Linv, opts, uplo=the_uplo)
