"""Pure-tensor BLAS-3 kernels — the L3 "internal" layer.

Reference analogue: ``src/internal/internal_{gemm,hemm,herk,her2k,symm,syrk,syr2k,trmm,
trsm}.cc`` and the per-tile BLAS in ``include/slate/Tile_blas.hh``.

The whole operand is one tensor, so the "internal" layer collapses to single library
calls: ``torch.matmul`` (cuBLAS on the card) and ``torch.linalg.solve_triangular``,
with triangle masks expressing the triangular/symmetric structure.  Float32 products
are full float32, matching the JAX package's ``lax.Precision.HIGHEST``, as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default).

All functions are out of place (tensors in, new tensor out).
"""

from __future__ import annotations

import torch

from ..core.types import Diag, Side, Uplo


def _c(alpha, ref: torch.Tensor) -> torch.Tensor:
    """Cast a scalar to the result dtype (a complex scalar against real data
    keeps its real part, as ``jnp.asarray(alpha, real_dtype)`` does)."""
    if isinstance(alpha, complex) and not ref.is_complex():
        alpha = alpha.real
    return torch.as_tensor(alpha, dtype=ref.dtype, device=ref.device)


def gemm(alpha, A: torch.Tensor, B: torch.Tensor, beta, C: torch.Tensor) -> torch.Tensor:
    """C = alpha A B + beta C (internal_gemm.cc)."""
    ab = torch.matmul(A, B)
    return _c(alpha, ab) * ab + _c(beta, C) * C


def _symmetrize(A, uplo: Uplo, conj: bool):
    uplo = Uplo.from_string(uplo)
    strict = torch.tril(A, -1) if uplo == Uplo.Lower else torch.triu(A, 1)
    other = strict.transpose(-1, -2)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    if conj and A.is_complex():
        other = other.conj()
        diag = diag.real.to(A.dtype)
    full = strict + other
    torch.diagonal(full, dim1=-2, dim2=-1).copy_(diag)
    return full


def symm(side, alpha, A, uplo, B, beta, C):
    """C = alpha A B + beta C with A symmetric stored in `uplo` (internal_symm)."""
    Af = _symmetrize(A, uplo, conj=False)
    side = Side.from_string(side)
    prod = torch.matmul(Af, B) if side == Side.Left else torch.matmul(B, Af)
    return _c(alpha, prod) * prod + _c(beta, C) * C


def hemm(side, alpha, A, uplo, B, beta, C):
    """Hermitian counterpart of symm (internal_hemm)."""
    Af = _symmetrize(A, uplo, conj=True)
    side = Side.from_string(side)
    prod = torch.matmul(Af, B) if side == Side.Left else torch.matmul(B, Af)
    return _c(alpha, prod) * prod + _c(beta, C) * C


def _real_diag(G):
    """Zero the imaginary residue on the diagonal of a complex Gram/Hermitian
    product (the diagonal is mathematically real: sum |x|^2).  In place."""
    d = torch.diagonal(G, dim1=-2, dim2=-1)
    d.copy_(d.real.to(G.dtype))
    return G


def _rank_k_update(update, beta, C, uplo: Uplo, real_diag: bool):
    """Apply a rank-k update to the stored triangle only, leaving the other
    triangle of C untouched."""
    uplo = Uplo.from_string(uplo)
    n = C.shape[-1]
    r = torch.arange(n, device=C.device)
    mask = (r[:, None] >= r[None, :]) if uplo == Uplo.Lower else (r[:, None] <= r[None, :])
    new = update + _c(beta, C) * C
    if real_diag and new.is_complex():
        _real_diag(new)
    return torch.where(mask, new, C)


def syrk(alpha, A, beta, C, uplo):
    """C(uplo) = alpha A A^T + beta C (internal_syrk)."""
    up = torch.matmul(A, A.transpose(-1, -2))
    return _rank_k_update(_c(alpha, up) * up, beta, C, uplo, real_diag=False)


def herk(alpha, A, beta, C, uplo):
    """C(uplo) = alpha A A^H + beta C, alpha/beta real (internal_herk) — the hot op of
    the Cholesky trailing update (potrf.cc:136-148)."""
    up = torch.matmul(A, A.mH)
    return _rank_k_update(_c(alpha, up) * up, beta, C, uplo, real_diag=True)


def gram(x, strips: int = 8):
    """x^H x as block-column strips on/below the diagonal, mirrored to the
    full Hermitian result — flop factor (1 + 1/S)/2 of the square product
    (the herk halving; reference internal_herk's triangle scope).  The mirror
    makes the off-diagonal exactly Hermitian by construction; a complex
    diagonal has its imaginary residue forced to zero."""
    n = x.shape[-1]
    xh = x.mH
    # strips of at least 128 columns; S=1 degenerates to the plain product
    S = max(1, min(strips, n // 128))
    if S <= 1:
        G = torch.matmul(xh, x)
        return _real_diag(G) if G.is_complex() else G
    G = torch.zeros(x.shape[:-2] + (n, n), dtype=x.dtype, device=x.device)
    for i in range(S):
        j0, j1 = (i * n) // S, ((i + 1) * n) // S
        G[..., j0:, j0:j1] = torch.matmul(xh[..., j0:, :], x[..., :, j0:j1])
    if G.is_complex():
        _real_diag(G)
    return torch.tril(G) + torch.tril(G, -1).mH


def syr2k(alpha, A, B, beta, C, uplo):
    up = torch.matmul(A, B.transpose(-1, -2))
    up = _c(alpha, up) * up + _c(alpha, up) * torch.matmul(B, A.transpose(-1, -2))
    return _rank_k_update(up, beta, C, uplo, real_diag=False)


def her2k(alpha, A, B, beta, C, uplo):
    up1 = torch.matmul(A, B.mH)
    up2 = torch.matmul(B, A.mH)
    a = _c(alpha, up1)
    up = a * up1 + a.conj() * up2
    return _rank_k_update(up, beta, C, uplo, real_diag=True)


def _triangle(A, uplo: Uplo, diag: Diag):
    uplo = Uplo.from_string(uplo)
    T = torch.tril(A) if uplo == Uplo.Lower else torch.triu(A)
    if Diag.from_string(diag) == Diag.Unit:
        torch.diagonal(T, dim1=-2, dim2=-1).fill_(1)
    return T


def trmm(side, uplo, diag, alpha, A, B):
    """B = alpha op(T) B or alpha B op(T), T triangular (internal_trmm)."""
    T = _triangle(A, uplo, diag)
    side = Side.from_string(side)
    prod = torch.matmul(T, B) if side == Side.Left else torch.matmul(B, T)
    return _c(alpha, prod) * prod


def trsm(side, uplo, diag, alpha, A, B):
    """Solve T X = alpha B (Left) or X T = alpha B (Right), T triangular.

    Reference: internal_trsm.cc -> blas::batch::trsm.  One blocked library
    triangular solve replaces the tile loop; it reads only the ``uplo``
    triangle of A (and not its diagonal when ``diag`` is Unit)."""
    side = Side.from_string(side)
    return torch.linalg.solve_triangular(
        A, _c(alpha, B) * B,
        upper=(Uplo.from_string(uplo) == Uplo.Upper),
        left=(side == Side.Left),
        unitriangular=(Diag.from_string(diag) == Diag.Unit))
