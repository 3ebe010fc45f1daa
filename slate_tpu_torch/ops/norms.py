"""Matrix norms over general / symmetric / triangular / band structures.

Reference analogue: ``src/internal/internal_{ge,he,sy,tr,gb,hb}norm.cc`` plus the CUDA
reductions ``src/cuda/device_{ge,he,sy,tr}norm.cu`` and the drivers ``src/norm.cc`` /
``src/colNorms.cc``.

Each norm is one masked reduction over the device-resident tensor.  General and
triangular norms of a real f32/f64 2-D matrix go through the wrappers of
:mod:`.cuda_norms` on any device: on the card they launch the hand-written CUDA
kernels, which apply the triangle mask in registers and read the matrix once; on
the CPU the same wrappers take their plain versions, so the CPU exercises the
card's dispatch.  Complex and batched input take inline reductions, as the JAX
package routes complex to XLA.  The symmetric and band norms stay plain
reductions, as they are in the JAX package.  One-norm of a symmetric matrix uses
the half-stored form directly: col_sums(full) = col_sums(stored triangle) +
row_sums(strict stored triangle) transposed.
"""

from __future__ import annotations

import torch

from ..core.exceptions import SlateError
from ..core.types import Diag, Norm, NormScope, Uplo
from .elementwise import _mask
from . import cuda_norms as _cn

_CN_WHICH = {Norm.Max: "max", Norm.One: "one", Norm.Inf: "inf", Norm.Fro: "fro"}


def _reduction_ok(A) -> bool:
    """Real f32/f64 2-D tensors go through the :mod:`.cuda_norms` wrappers."""
    return (isinstance(A, torch.Tensor) and A.ndim == 2
            and A.dtype in (torch.float32, torch.float64))


def _kernel_ok(A) -> bool:
    """The wrappers launch the CUDA kernels for real f32/f64, 2-D,
    CUDA-resident tensors (the counterpart of the JAX package's
    ``_pallas_ok``, norms.py:32-38)."""
    return _reduction_ok(A) and A.is_cuda


def _unit_col_stride(A: torch.Tensor) -> torch.Tensor:
    """The kernels take any row stride but need unit column stride; on the
    card other layouts (a transposed view, a column-strided slice) are copied
    once.  The plain versions take any layout."""
    if not _kernel_ok(A) or A.shape[-1] <= 1 or A.stride(-1) == 1:
        return A
    return A.contiguous()


def genorm(norm, A, scope=NormScope.Matrix):
    """General-matrix norm (internal_genorm.cc, device_genorm.cu).

    scope=Columns returns the vector of column norms (the colNorms driver,
    src/colNorms.cc — only Max is supported there, like the reference).
    """
    norm = Norm.from_string(norm)
    scope = NormScope.from_string(scope)
    if scope == NormScope.Columns:
        if norm != Norm.Max:
            raise SlateError("colNorms supports Norm.Max only (matches reference)")
        if _reduction_ok(A):
            return _cn.col_norms_max(_unit_col_stride(A))
        return torch.amax(A.abs(), dim=-2)
    if _reduction_ok(A) and norm in _CN_WHICH:
        return _cn.genorm(_unit_col_stride(A), _CN_WHICH[norm])
    a = A.abs()
    if norm == Norm.Max:
        return torch.amax(a)
    if norm == Norm.One:
        return torch.amax(torch.sum(a, dim=-2))
    if norm == Norm.Inf:
        return torch.amax(torch.sum(a, dim=-1))
    if norm == Norm.Fro:
        return torch.sqrt(torch.sum(a * a))
    raise SlateError(f"unsupported norm {norm}")


def _masked(A, uplo, diag=Diag.NonUnit):
    a = torch.where(_mask(A.shape, uplo, A.device), A, torch.zeros((), dtype=A.dtype,
                                                                   device=A.device))
    if Diag.from_string(diag) == Diag.Unit:
        torch.diagonal(a, dim1=-2, dim2=-1).fill_(1)
    return a


def trnorm(norm, uplo, diag, A):
    """Trapezoid/triangular norm (internal_trnorm.cc, device_trnorm.cu).

    On the card the triangle mask is applied in registers inside the CUDA
    kernel instead of materializing the masked matrix."""
    which = _CN_WHICH.get(Norm.from_string(norm))
    if _reduction_ok(A) and which is not None:
        lower = Uplo.from_string(uplo) == Uplo.Lower
        mode = _cn._MODE_LOWER if lower else _cn._MODE_UPPER
        return _cn.genorm(_unit_col_stride(A), which, mode=mode,
                          unit_diag=Diag.from_string(diag) == Diag.Unit)
    return genorm(norm, _masked(A, uplo, diag))


def synorm(norm, uplo, A):
    """Symmetric norm from the stored triangle (internal_synorm.cc).

    One == Inf by symmetry; column sums combine the stored triangle's columns with its
    strict rows (synormOffdiag device kernel, device.hh:234-240).
    """
    norm = Norm.from_string(norm)
    lower = Uplo.from_string(uplo) == Uplo.Lower
    absA = A.abs()
    tri = torch.tril(absA) if lower else torch.triu(absA)          # stored triangle
    strict = torch.tril(absA, -1) if lower else torch.triu(absA, 1)  # excl. diagonal
    if norm == Norm.Max:
        return torch.amax(tri)
    if norm in (Norm.One, Norm.Inf):
        col = torch.sum(tri, dim=-2) + torch.sum(strict, dim=-1)
        return torch.amax(col)
    if norm == Norm.Fro:
        d = torch.diagonal(A, dim1=-2, dim2=-1).abs()
        diag_sq = torch.sum(d * d)
        off_sq = torch.sum(strict * strict)
        return torch.sqrt(2.0 * off_sq + diag_sq)
    raise SlateError(f"unsupported norm {norm}")


def henorm(norm, uplo, A):
    """Hermitian norm (internal_henorm.cc) — same combine as synorm; |.| removes the
    conjugation difference."""
    return synorm(norm, uplo, A)


def gbnorm(norm, kl, ku, A):
    """Band norm (internal_gbnorm.cc): mask outside the band then reduce."""
    m, n = A.shape[-2], A.shape[-1]
    r = torch.arange(m, device=A.device)[:, None]
    c = torch.arange(n, device=A.device)[None, :]
    band = (c - r <= ku) & (r - c <= kl)
    return genorm(norm, torch.where(band, A, torch.zeros((), dtype=A.dtype,
                                                         device=A.device)))


def hbnorm(norm, uplo, kd, A):
    """Hermitian band norm (internal_hbnorm.cc)."""
    n = A.shape[-1]
    r = torch.arange(n, device=A.device)[:, None]
    c = torch.arange(n, device=A.device)[None, :]
    if Uplo.from_string(uplo) == Uplo.Lower:
        band = (r - c <= kd) & (r >= c)
    else:
        band = (c - r <= kd) & (c >= r)
    return synorm(norm, uplo, torch.where(band, A, torch.zeros((), dtype=A.dtype,
                                                               device=A.device)))
