"""Elementwise / copy / set kernels.

Reference analogue: the device kernels in ``src/cuda/device_{geadd,gecopy,gescale,
gescale_row_col,geset,tzadd,tzcopy,tzscale,tzset}.cu`` and their internal wrappers.

Each is a plain tensor expression; the trapezoid (tz*) variants become triangle
masks.  Every function returns a new tensor and leaves its inputs untouched.
"""

from __future__ import annotations

import torch

from ..core.types import Uplo


def _mask(shape, uplo: Uplo, device=None) -> torch.Tensor:
    """Trapezoid mask including the diagonal."""
    m, n = shape[-2], shape[-1]
    r = torch.arange(m, device=device)[:, None]
    c = torch.arange(n, device=device)[None, :]
    if Uplo.from_string(uplo) == Uplo.Lower:
        return r >= c
    return r <= c


def _s(value, ref: torch.Tensor) -> torch.Tensor:
    """A scalar as a 0-d tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(value, dtype=ref.dtype, device=ref.device)


def geadd(alpha, A, beta, B):
    """B = alpha A + beta B (device_geadd.cu)."""
    return _s(alpha, B) * A + _s(beta, B) * B


def tzadd(uplo, alpha, A, beta, B):
    """Trapezoid add: only the `uplo` triangle is updated (device_tzadd.cu)."""
    return torch.where(_mask(B.shape, uplo, B.device), geadd(alpha, A, beta, B), B)


def gecopy(A, out_dtype=None):
    """Copy with optional precision conversion (device_gecopy.cu)."""
    return A.to(out_dtype) if out_dtype is not None else A.clone()


def tzcopy(uplo, A, B, out_dtype=None):
    """Copy the `uplo` trapezoid of A over B (device_tzcopy.cu)."""
    src = gecopy(A, out_dtype or B.dtype)
    return torch.where(_mask(B.shape, uplo, B.device), src, B)


def gescale(numer, denom, A):
    """A *= numer/denom (device_gescale.cu; two-scalar form avoids overflow)."""
    return A * (_s(numer, A) / _s(denom, A))


def tzscale(uplo, numer, denom, A):
    return torch.where(_mask(A.shape, uplo, A.device), gescale(numer, denom, A), A)


def gescale_row_col(R, C, A):
    """A = diag(R) A diag(C) — row/col equilibration (device_gescale_row_col.cu)."""
    return A * R[..., :, None] * C[..., None, :]


def geset(offdiag_value, diag_value, A):
    """Set off-diagonal and diagonal entries to constants (device_geset.cu)."""
    out = torch.full_like(A, offdiag_value)
    torch.diagonal(out, dim1=-2, dim2=-1).fill_(diag_value)
    return out


def tzset(uplo, offdiag_value, diag_value, A):
    """Set the `uplo` trapezoid (device_tzset.cu); the other triangle is untouched."""
    return torch.where(_mask(A.shape, uplo, A.device),
                       geset(offdiag_value, diag_value, A), A)
