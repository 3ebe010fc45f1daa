"""Public BLAS-3 and auxiliary drivers — the L5 API.

Reference analogue: the BLAS-3 and Aux rows of the driver inventory (SURVEY.md §2.4):
``src/{gemm,gemmA,gemmC,hemm,symm,herk,her2k,syrk,syr2k,trmm,trsm}.cc`` and
``src/{add,copy,scale,scale_row_col,set,norm,colNorms}.cc``.

Drivers accept Matrix wrappers (using their op/uplo/diag flags, like the reference's
typed-matrix dispatch) or raw tensors with explicit keywords.  Each writes its
output wrapper *and* returns the new tensor, so both the reference's in-place style
and the functional style work.

Method dispatch: on one device every stationary variant is the same library call
(stationarity is a communication concept); the distributed variants and the SUMMA
pipeline arrive with the distributed tier (ROADMAP.md queue A item 15).
"""

from __future__ import annotations

from dataclasses import replace as _replace

import torch

from .core.exceptions import SlateError
from .core.matrix import (BaseBandMatrix, BaseMatrix, BaseTrapezoidMatrix,
                          HermitianBandMatrix, HermitianMatrix, SymmetricMatrix,
                          as_array, distribution_grid, write_back)
from .core.types import Diag, MethodGemm, MethodTrsm, NormScope, Options, Uplo
from .ops import blas3, elementwise, norms as norm_ops


def _uplo_of(A, uplo) -> Uplo:
    if uplo is not None:
        return Uplo.from_string(uplo)
    if isinstance(A, (BaseTrapezoidMatrix, BaseBandMatrix)) and A.uplo != Uplo.General:
        return A.uplo
    raise SlateError("uplo required (pass a triangular/symmetric matrix or uplo=...)")


def _diag_of(A, diag) -> Diag:
    if diag is not None:
        return Diag.from_string(diag)
    return getattr(A, "diag", Diag.NonUnit)


def _operands(*ops):
    """Logical tensors of the operands; raw (non-tensor) data goes onto the
    device of the first tensor operand, else onto the default device."""
    device = None
    for A in ops:
        if isinstance(A, BaseMatrix):
            device = A.device
            break
        if isinstance(A, torch.Tensor):
            device = A.device
            break
    return [as_array(A, device=device) for A in ops]


def select_algo_gemm(A, B, C, opts: Options) -> MethodGemm:
    """Pick a gemm variant (src/gemm.cc:12-24 select_algo): stationary-C when B
    has >= 2 block columns, else stationary-A."""
    if opts.method_gemm != MethodGemm.Auto:
        return opts.method_gemm
    B_nt = B.nt if isinstance(B, BaseMatrix) else 2
    return MethodGemm.C if B_nt >= 2 else MethodGemm.A


def gemm(alpha, A, B, beta, C, opts=None):
    """C = alpha op(A) op(B) + beta C (src/gemm.cc:87)."""
    opts = Options.make(opts)
    distribution_grid(A, B, C)
    if opts.f64_emulation:
        raise SlateError("f64_emulation gemm is not ported yet (ROADMAP.md queue A "
                         "item 13)")
    if select_algo_gemm(A, B, C, opts) == MethodGemm.SUMMA:
        raise SlateError("MethodGemm.SUMMA requires the distributed tier, not "
                         "ported yet (ROADMAP.md queue A item 15)")
    a, b, c = _operands(A, B, C)
    return write_back(C, blas3.gemm(alpha, a, b, beta, c))


def gemmA(alpha, A, B, beta, C, opts=None):
    """Stationary-A gemm (src/gemmA.cc); on one device the same product as gemm."""
    return gemm(alpha, A, B, beta, C, _replace(Options.make(opts),
                                               method_gemm=MethodGemm.A))


def gemmC(alpha, A, B, beta, C, opts=None):
    """Stationary-C gemm (src/gemmC.cc)."""
    return gemm(alpha, A, B, beta, C, _replace(Options.make(opts),
                                               method_gemm=MethodGemm.C))


def symm(side, alpha, A, B, beta, C, opts=None, uplo=None):
    """C = alpha A B + beta C, A symmetric (src/symm.cc)."""
    a, b, c = _operands(A, B, C)
    return write_back(C, blas3.symm(side, alpha, a, _uplo_of(A, uplo), b, beta, c))


def hemm(side, alpha, A, B, beta, C, opts=None, uplo=None):
    """Hermitian symm (src/hemm.cc, hemmA/hemmC variants)."""
    a, b, c = _operands(A, B, C)
    return write_back(C, blas3.hemm(side, alpha, a, _uplo_of(A, uplo), b, beta, c))


def hemmA(side, alpha, A, B, beta, C, opts=None, uplo=None):
    """Stationary-A Hermitian multiply (src/hemmA.cc)."""
    return hemm(side, alpha, A, B, beta, C, opts=opts, uplo=uplo)


def hemmC(side, alpha, A, B, beta, C, opts=None, uplo=None):
    """Stationary-C Hermitian multiply (src/hemmC.cc)."""
    return hemm(side, alpha, A, B, beta, C, opts=opts, uplo=uplo)


def syrk(alpha, A, beta, C, opts=None, uplo=None):
    """C = alpha A A^T + beta C on the stored triangle (src/syrk.cc)."""
    a, c = _operands(A, C)
    return write_back(C, blas3.syrk(alpha, a, beta, c, _uplo_of(C, uplo)))


def herk(alpha, A, beta, C, opts=None, uplo=None):
    """C = alpha A A^H + beta C, alpha/beta real (src/herk.cc)."""
    a, c = _operands(A, C)
    return write_back(C, blas3.herk(alpha, a, beta, c, _uplo_of(C, uplo)))


def syr2k(alpha, A, B, beta, C, opts=None, uplo=None):
    a, b, c = _operands(A, B, C)
    return write_back(C, blas3.syr2k(alpha, a, b, beta, c, _uplo_of(C, uplo)))


def her2k(alpha, A, B, beta, C, opts=None, uplo=None):
    a, b, c = _operands(A, B, C)
    return write_back(C, blas3.her2k(alpha, a, b, beta, c, _uplo_of(C, uplo)))


def trmm(side, alpha, A, B, opts=None, uplo=None, diag=None):
    """B = alpha op(T) B / alpha B op(T) (src/trmm.cc; work::trmm body)."""
    a, b = _operands(A, B)
    return write_back(B, blas3.trmm(side, _uplo_of(A, uplo), _diag_of(A, diag),
                                    alpha, a, b))


def select_algo_trsm(A, B, opts: Options) -> MethodTrsm:
    """Pick a trsm variant (src/trsm.cc:11-23 select_algo): stationary-A when B
    has a single block column, else stationary-B."""
    if opts.method_trsm != MethodTrsm.Auto:
        return opts.method_trsm
    B_nt = B.nt if isinstance(B, BaseMatrix) else 2
    return MethodTrsm.A if B_nt < 2 else MethodTrsm.B


def _trsm_dispatch(side, alpha, A, B, uplo, diag):
    distribution_grid(A, B)
    a, b = _operands(A, B)
    return write_back(B, blas3.trsm(side, _uplo_of(A, uplo), _diag_of(A, diag),
                                    alpha, a, b))


def trsm(side, alpha, A, B, opts=None, uplo=None, diag=None):
    """Solve op(T) X = alpha B in place of B (src/trsm.cc; one blocked library
    triangular solve on one device)."""
    select_algo_trsm(A, B, Options.make(opts))
    return _trsm_dispatch(side, alpha, A, B, uplo, diag)


def trsmA(side, alpha, A, B, opts=None, uplo=None, diag=None):
    """Stationary-A triangular solve (src/trsmA.cc)."""
    return _trsm_dispatch(side, alpha, A, B, uplo, diag)


def trsmB(side, alpha, A, B, opts=None, uplo=None, diag=None):
    """Stationary-B triangular solve (src/trsmB.cc)."""
    return _trsm_dispatch(side, alpha, A, B, uplo, diag)


# ---------------------------------------------------------------------------
# Aux drivers (add/copy/scale/set/norm)
# ---------------------------------------------------------------------------


def add(alpha, A, beta, B, opts=None):
    """B = alpha A + beta B (src/add.cc; tzadd for trapezoid operands)."""
    a, b = _operands(A, B)
    if isinstance(B, BaseTrapezoidMatrix):
        return write_back(B, elementwise.tzadd(B.uplo, alpha, a, beta, b))
    return write_back(B, elementwise.geadd(alpha, a, beta, b))


def copy(A, B, opts=None):
    """B = A with dtype conversion (src/copy.cc; device_gecopy.cu)."""
    a, b = _operands(A, B)
    if isinstance(B, BaseTrapezoidMatrix):
        return write_back(B, elementwise.tzcopy(B.uplo, a, b))
    return write_back(B, elementwise.gecopy(a, b.dtype))


def scale(numer, denom, A, opts=None):
    """A *= numer/denom (src/scale.cc)."""
    (a,) = _operands(A)
    if isinstance(A, BaseTrapezoidMatrix):
        return write_back(A, elementwise.tzscale(A.uplo, numer, denom, a))
    return write_back(A, elementwise.gescale(numer, denom, a))


def scale_row_col(R, C, A, opts=None):
    """A = diag(R) A diag(C) equilibration (src/scale_row_col.cc)."""
    (a,) = _operands(A)
    r = torch.as_tensor(R, dtype=a.dtype, device=a.device)
    c = torch.as_tensor(C, dtype=a.dtype, device=a.device)
    return write_back(A, elementwise.gescale_row_col(r, c, a))


def set(offdiag_value, diag_value, A, opts=None):  # noqa: A001 - reference name
    """Set entries to constants (src/set.cc; geset/tzset kernels)."""
    (a,) = _operands(A)
    if isinstance(A, BaseTrapezoidMatrix):
        return write_back(A, elementwise.tzset(A.uplo, offdiag_value, diag_value, a))
    return write_back(A, elementwise.geset(offdiag_value, diag_value, a))


def set_from_function(value, A, opts=None):
    """Set entries A[i, j] = value(i, j) (src/set_lambdas.cc): ``value`` receives
    broadcastable global index tensors (I of shape (m, 1), J of shape (1, n)) and
    is evaluated once, vectorized.  Trapezoid wrappers keep their unstored
    triangle."""
    (a,) = _operands(A)
    m, n = a.shape[-2:]
    I = torch.arange(m, device=a.device)[:, None]
    J = torch.arange(n, device=a.device)[None, :]
    vals = torch.broadcast_to(torch.as_tensor(value(I, J), dtype=a.dtype,
                                              device=a.device), a.shape)
    if isinstance(A, BaseTrapezoidMatrix):
        mask = (I >= J) if A.uplo == Uplo.Lower else (I <= J)
        vals = torch.where(mask, vals, a)
    return write_back(A, vals.clone())


set_lambdas = set_from_function   # reference driver name (src/set_lambdas.cc)


def norm(norm_kind, A, opts=None, scope=NormScope.Matrix, uplo=None, diag=None):
    """Matrix norm dispatched on matrix type (src/norm.cc).

    General -> genorm, symmetric/Hermitian -> synorm/henorm, triangular -> trnorm,
    band -> gbnorm/hbnorm (internal_*norm.cc family).  General and triangular
    norms of real f32/f64 data on the card run the CUDA reductions.
    """
    distribution_grid(A)
    (a,) = _operands(A)
    if isinstance(A, HermitianMatrix):
        return norm_ops.henorm(norm_kind, A.uplo, a)
    if isinstance(A, SymmetricMatrix):
        return norm_ops.synorm(norm_kind, A.uplo, a)
    if isinstance(A, BaseTrapezoidMatrix):
        return norm_ops.trnorm(norm_kind, A.uplo, A.diag, a)
    if isinstance(A, BaseBandMatrix):
        if isinstance(A, HermitianBandMatrix):
            return norm_ops.hbnorm(norm_kind, A.uplo, A.kd, a)
        # TriangularBandMatrix's (kl, ku) already encode triangle ∩ band exactly
        return norm_ops.gbnorm(norm_kind, A.kl, A.ku, a)
    return norm_ops.genorm(norm_kind, a, scope)


def col_norms(norm_kind, A, opts=None):
    """Per-column max norms (src/colNorms.cc; Norm.Max only, like the reference)."""
    (a,) = _operands(A)
    return norm_ops.genorm(norm_kind, a, NormScope.Columns)
