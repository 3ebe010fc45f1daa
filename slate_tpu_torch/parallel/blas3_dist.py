"""Distributed symmetric/Hermitian/triangular BLAS-3 over the process grid.

Reference analogues (SURVEY.md §2.2, §2.4): ``src/herk.cc`` / ``src/her2k.cc``
/ ``src/syrk.cc`` / ``src/syr2k.cc`` (rank-k updates of one stored triangle),
``src/hemm*.cc`` / ``src/symm.cc`` and ``src/trmm.cc``.

* **Rank-k updates**: the k-panel is all-gathered along both grid dims — the
  reference's ``listBcastMT`` of the panel to its row *and* column owners
  (potrf.cc:122-132) — and every rank updates its local C block with one
  matmul.  The triangle is an index mask on global indices, so the other
  triangle passes through untouched.
* **hemm/symm/trmm**: the implied full (or transposed) operand is built from
  the stored triangle on the grid (the mirrored half is one all-to-all of
  blocks, :func:`~.distribute.transpose_local`), then one SUMMA product.

All entry points accept ragged shapes: operands are zero-padded to
grid-divisible sizes (zero rows/cols leave every product unchanged) and the
result is cut back.
"""

from __future__ import annotations

import torch

from ..core.exceptions import slate_assert
from ..obs import instrument
from .collectives import axis_allgather
from .distribute import (bounds, global_index, lcm, local_block, transpose_local,
                         trim, wrap)
from .mesh import COL_AXIS, ProcessGrid, ROW_AXIS
from .summa import gemm_allgather


def _scalar(v, dt, device):
    return torch.as_tensor(v, dtype=dt, device=device)


def _pad_shape(m, n, rm, cm):
    return -(-m // rm) * rm, -(-n // cm) * cm


def _tri_mask(grid, m, n, lower: bool, strict: bool = False, device=None):
    rows, cols = global_index(grid, m, n, device=device)
    if lower:
        return rows > cols if strict else rows >= cols
    return rows < cols if strict else rows <= cols


def _run_rank_k(alpha, A, B, beta, C, grid, lower, herm, two):
    n, k = A.shape[-2:]
    slate_assert(tuple(B.shape) == tuple(A.shape),
                 "rank-k operands must have equal shapes")
    slate_assert(tuple(C.shape[-2:]) == (n, n), f"C must be {n}x{n}")
    unit = lcm(grid.p, grid.q)
    npad, kpad = _pad_shape(n, k, unit, grid.q)
    a = local_block(A, grid, (npad, kpad))
    b = a if B is A else local_block(B, grid, (npad, kpad))
    c = local_block(C, grid, (npad, npad))
    dt = c.dtype
    alpha = _scalar(alpha, dt, c.device)
    beta = _scalar(beta, dt, c.device)
    (c0, c1) = bounds(grid, npad, npad)[1]

    def ct(x):
        return x.mH if herm else x.mT

    def col_block(x_row):
        # my *column* block (n/q, k): gather the rows along p, keep my q slice
        return axis_allgather(x_row, grid, ROW_AXIS, dim=0)[c0:c1]

    a_row = axis_allgather(a, grid, COL_AXIS, dim=1)           # (n/p, k)
    b_row = a_row if b is a else axis_allgather(b, grid, COL_AXIS, dim=1)
    upd = torch.matmul(a_row, ct(col_block(b_row)))
    if two:
        alpha2 = alpha.conj() if herm else alpha
        upd = alpha * upd + alpha2 * torch.matmul(b_row, ct(col_block(a_row)))
    else:
        upd = alpha * upd
    if herm and c.is_complex():
        # her*k semantics: the Hermitian diagonal is real — drop any imaginary
        # part of C's diagonal before beta scales it
        rows, cols = global_index(grid, npad, npad, device=c.device)
        c = torch.where(rows == cols, c.real.to(dt), c)
    mask = _tri_mask(grid, npad, npad, lower, device=c.device)
    out = torch.where(mask, upd + beta * c, c)
    return trim(out, grid, (npad, npad), (n, n))


@instrument
def herk_distributed(alpha, A, beta, C, grid: ProcessGrid, uplo: str = "lower"):
    """C_uplo = alpha A A^H + beta C_uplo, C in the block layout (src/herk.cc).
    The opposite triangle of C passes through untouched."""
    return _run_rank_k(alpha, A, A, beta, C, grid, uplo == "lower",
                       herm=True, two=False)


@instrument
def syrk_distributed(alpha, A, beta, C, grid: ProcessGrid, uplo: str = "lower"):
    """C_uplo = alpha A A^T + beta C_uplo (src/syrk.cc)."""
    return _run_rank_k(alpha, A, A, beta, C, grid, uplo == "lower",
                       herm=False, two=False)


@instrument
def her2k_distributed(alpha, A, B, beta, C, grid: ProcessGrid,
                      uplo: str = "lower"):
    """C_uplo = alpha A B^H + conj(alpha) B A^H + beta C_uplo (src/her2k.cc)."""
    return _run_rank_k(alpha, A, B, beta, C, grid, uplo == "lower",
                       herm=True, two=True)


@instrument
def syr2k_distributed(alpha, A, B, beta, C, grid: ProcessGrid,
                      uplo: str = "lower"):
    """C_uplo = alpha (A B^T + B A^T) + beta C_uplo (src/syr2k.cc)."""
    return _run_rank_k(alpha, A, B, beta, C, grid, uplo == "lower",
                       herm=False, two=True)


# ---------------------------------------------------------------------------
# hemm / symm / trmm
# ---------------------------------------------------------------------------


def _full_local(a, grid, n, lower, herm):
    """Block-layout shard of the full symmetric/Hermitian operand from the
    stored triangle's shard (the mirror half is one block all-to-all)."""
    rows, cols = global_index(grid, n, n, device=a.device)
    strict = torch.where((rows > cols) if lower else (rows < cols), a,
                         torch.zeros((), dtype=a.dtype, device=a.device))
    diag = torch.where(rows == cols, a.real.to(a.dtype) if herm and a.is_complex()
                       else a, torch.zeros((), dtype=a.dtype, device=a.device))
    return strict + diag + transpose_local(strict, grid, n, n, conj=herm)


def _product(left, op_loc, b_loc, grid, n_op, shape_b):
    """op @ B (left) or B @ op (right), operands as padded block shards."""
    op = wrap(op_loc, grid, (n_op, n_op))
    b = wrap(b_loc, grid, shape_b)
    return (gemm_allgather(op, b, grid) if left
            else gemm_allgather(b, op, grid)).to_local()


@instrument
def hemm_distributed(side, alpha, A, B, beta, C, grid: ProcessGrid,
                     uplo: str = "lower", herm: bool = True):
    """C = alpha A B + beta C (side=left) or alpha B A + beta C (side=right),
    A Hermitian/symmetric stored in one triangle (src/hemm.cc, src/symm.cc)."""
    left = str(side).lower().startswith("l")
    slate_assert(A.shape[-1] == A.shape[-2], "hemm operand A must be square")
    slate_assert(A.shape[-1] == (C.shape[-2] if left else C.shape[-1]),
                 f"side={side!r} needs A of order "
                 f"{C.shape[-2] if left else C.shape[-1]}, got {A.shape[-1]}")
    m, n = C.shape[-2:]
    unit = lcm(grid.p, grid.q)
    na = A.shape[-1]
    ap = _pad_shape(na, na, unit, unit)
    bp = _pad_shape(*B.shape[-2:], unit, unit)
    cp = _pad_shape(m, n, unit, unit)
    a = local_block(A, grid, ap)
    b = local_block(B, grid, bp)
    c = local_block(C, grid, cp)
    full = _full_local(a, grid, ap[0], uplo == "lower", herm)
    prod = _product(left, full, b, grid, ap[0], bp)
    dt = c.dtype
    out = _scalar(alpha, dt, c.device) * prod + _scalar(beta, dt, c.device) * c
    return trim(out, grid, cp, (m, n))


@instrument
def symm_distributed(side, alpha, A, B, beta, C, grid: ProcessGrid,
                     uplo: str = "lower"):
    return hemm_distributed(side, alpha, A, B, beta, C, grid, uplo, herm=False)


@instrument
def trmm_distributed(side, alpha, A, B, grid: ProcessGrid, uplo: str = "lower",
                     conj_trans: bool = False, unit_diag: bool = False):
    """B = alpha op(A) B (side=left) or alpha B op(A) (side=right) with A
    triangular (src/trmm.cc).  Zero-padding keeps the padded triangle inert."""
    left = str(side).lower().startswith("l")
    m, n = B.shape[-2:]
    unit = lcm(grid.p, grid.q)
    na = A.shape[-1]
    ap = _pad_shape(na, na, unit, unit)
    bp = _pad_shape(m, n, unit, unit)
    a = local_block(A, grid, ap)
    b = local_block(B, grid, bp)
    rows, cols = global_index(grid, *ap, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    tri = torch.where(_tri_mask(grid, *ap, uplo == "lower", device=a.device), a, zero)
    if unit_diag:
        tri = torch.where((rows == cols) & (rows < na), torch.ones_like(tri), tri)
    if conj_trans:
        tri = transpose_local(tri, grid, ap[0], ap[1], conj=True)
    prod = _product(left, tri, b, grid, ap[0], bp)
    out = _scalar(alpha, b.dtype, b.device) * prod
    return trim(out, grid, bp, (m, n))


def _band_local(a, grid, m, n, kl, ku):
    rows, cols = global_index(grid, m, n, device=a.device)
    keep = (cols - rows <= ku) & (rows - cols <= kl)
    return torch.where(keep, a, torch.zeros((), dtype=a.dtype, device=a.device))


@instrument
def gbmm_distributed(alpha, A, B, beta, C, grid: ProcessGrid, kl: int, ku: int):
    """C = alpha A B + beta C with A a general band matrix (src/gbmm.cc over
    the grid).  The band is a mask, the product rides the SUMMA all-gather."""
    m, k = A.shape[-2:]
    n = B.shape[-1]
    slate_assert(B.shape[-2] == k, f"gbmm inner dims {k} != {B.shape[-2]}")
    slate_assert(tuple(C.shape[-2:]) == (m, n), f"gbmm C must be {m}x{n}")
    kmult = lcm(grid.p, grid.q)
    ap = _pad_shape(m, k, grid.p, kmult)
    bp = _pad_shape(k, n, kmult, grid.q)
    a = _band_local(local_block(A, grid, ap), grid, ap[0], ap[1], kl, ku)
    prod = gemm_allgather(wrap(a, grid, ap), wrap(local_block(B, grid, bp), grid, bp),
                          grid).to_local()
    cp = (ap[0], bp[1])
    c = local_block(C, grid, cp)
    dt = c.dtype
    out = _scalar(alpha, dt, c.device) * prod + _scalar(beta, dt, c.device) * c
    return trim(out, grid, cp, (m, n))


@instrument
def hbmm_distributed(alpha, A, B, beta, C, grid: ProcessGrid, kd: int,
                     uplo: str = "lower", side: str = "left"):
    """C = alpha A B + beta C (side=left) or alpha B A + beta C (side=right)
    with A Hermitian band, one triangle stored (src/hbmm.cc over the grid)."""
    n = A.shape[-1]
    lower = uplo == "lower"
    a = local_block(A, grid, (n, n))
    tri = _band_local(a, grid, n, n, kd if lower else 0, 0 if lower else kd)
    return hemm_distributed(side, alpha, wrap(tri, grid, (n, n)), B, beta, C,
                            grid, uplo=uplo)
