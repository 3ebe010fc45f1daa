"""Distributed matrix multiply over the process grid.

Reference analogue: ``src/gemmC.cc:55-160`` — the stationary-C pipeline that
broadcasts block-column k of A and block-row k of B across the grid, then
rank-nb updates local C tiles.

Two algorithms, each a shard-local body with explicit collectives:

* :func:`gemm_allgather` — all-gather A along q and B along p, one local
  matmul: SUMMA with the panel loop fully aggregated.  Memory O(mK/p + Kn/q).
* :func:`gemm_ring` — Cannon's algorithm on a square grid: K stays sharded;
  each of the q steps multiplies the resident panels and rotates them one
  place along the grid (point-to-point sends, the reference's lookahead
  panel sends).
"""

from __future__ import annotations

import torch

from ..core.exceptions import slate_assert
from ..obs import instrument
from .collectives import axis_allgather, axis_index, ring_shift
from .distribute import gather, lcm, local_block, pad2d, trim, wrap
from .mesh import COL_AXIS, ProcessGrid, ROW_AXIS


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _check_divides(m, k, n, grid):
    slate_assert(m % grid.p == 0 and n % grid.q == 0
                 and k % grid.p == 0 and k % grid.q == 0,
                 f"shapes ({m},{k})x({k},{n}) must divide the {grid.p}x{grid.q} "
                 "grid (pad to tile multiples first)")


@instrument
def gemm_allgather(A, B, grid: ProcessGrid, precision=None):
    """C = A @ B with A, B, C in the block layout.  One all-gather per operand."""
    m, k = A.shape[-2:]
    k2, n = B.shape[-2:]
    slate_assert(k == k2, f"gemm inner dims {k} != {k2}")
    _check_divides(m, k, n, grid)
    a, b = _promote(local_block(A, grid), local_block(B, grid))
    a_full = axis_allgather(a, grid, COL_AXIS, dim=1)     # (m/p, k)
    b_full = axis_allgather(b, grid, ROW_AXIS, dim=0)     # (k, n/q)
    return wrap(torch.matmul(a_full, b_full), grid, (m, n))


@instrument
def gemm_ring(A, B, grid: ProcessGrid, precision=None):
    """Cannon's algorithm on a square p×p grid: K stays resident, panels rotate
    each step (the pipelined / lookahead form)."""
    slate_assert(grid.p == grid.q, "gemm_ring requires a square grid (Cannon)")
    m, k = A.shape[-2:]
    _, n = B.shape[-2:]
    slate_assert(m % grid.p == 0 and k % grid.p == 0 and k % grid.q == 0
                 and n % grid.q == 0, "shapes must divide the grid")
    a, b = _promote(local_block(A, grid), local_block(B, grid))
    i = axis_index(grid, ROW_AXIS)
    j = axis_index(grid, COL_AXIS)
    # Cannon skew: row i shifts its A panel left by i, column j shifts B up by j
    a = ring_shift(a, grid, COL_AXIS, i)
    b = ring_shift(b, grid, ROW_AXIS, j)
    c = torch.matmul(a, b)
    for _ in range(grid.q - 1):
        a = ring_shift(a, grid, COL_AXIS, 1)
        b = ring_shift(b, grid, ROW_AXIS, 1)
        c += torch.matmul(a, b)
    return wrap(c, grid, (m, n))


@instrument
def summa_gemm(alpha, A, B, beta, C, opts=None, grid: ProcessGrid | None = None):
    """Full gemm entry point for the L5 API (blas.gemm on grid-bound wrappers,
    or MethodGemm.SUMMA): C = alpha op(A) op(B) + beta C over ``grid`` (the
    world's grid when none is given).

    Operands may be Matrix wrappers (their op flags apply), tensors or
    DTensors.  A whole grid-bound wrapper is taken in its block layout and
    the result comes back in it, so only panels move.  Shapes the grid does
    not divide are zero-padded, which gathers the operands, and the result is
    cut back to a whole tensor."""
    from ..core.matrix import dist_operand

    grid = grid or ProcessGrid.cached(device=_device_of(A, B, C))
    a, b = dist_operand(A), dist_operand(B)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if m % grid.p or n % grid.q or k % grid.p or k % grid.q:
        kmult = grid.p * grid.q
        prod = gemm_distributed(pad2d(gather(a), grid.p, kmult),
                                pad2d(gather(b), kmult, grid.q), grid)
        return alpha * gather(prod)[:m, :n] + beta * gather(dist_operand(C))
    prod = gemm_distributed(a, b, grid).to_local()
    return wrap(alpha * prod + beta * local_block(dist_operand(C), grid), grid, (m, n))


def _device_of(*ops):
    from ..core.matrix import BaseMatrix

    for x in ops:
        if isinstance(x, BaseMatrix):
            return x.device
        if isinstance(x, torch.Tensor):
            return x.device
    return None


@instrument
def gemm_distributed(A, B, grid: ProcessGrid, method: str = "auto",
                     precision=None):
    """Dispatch like src/gemm.cc select_algo: ring (pipelined) on square grids
    with K large enough to amortize the skew, else all-gather SUMMA."""
    if method == "auto":
        method = "ring" if (grid.p == grid.q and grid.p > 1
                            and A.shape[-1] >= 4 * grid.p) else "allgather"
    if method == "ring":
        return gemm_ring(A, B, grid, precision)
    return gemm_allgather(A, B, grid, precision)


@instrument
def gemm_padded(A, B, grid: ProcessGrid, precision=None):
    """``gemm_distributed`` for arbitrary shapes: zero-pads both operands to
    grid-tile multiples, runs the sharded product, cuts the result back."""
    m, k = A.shape[-2:]
    n = B.shape[-1]
    slate_assert(k == B.shape[-2],
                 f"gemm inner dims {k} != {B.shape[-2]} (padding would mask it)")
    mult = lcm(grid.p, grid.q)
    mp, kp, np_ = -(-m // grid.p) * grid.p, -(-k // mult) * mult, -(-n // grid.q) * grid.q
    if (mp, kp, np_) == (m, k, n):
        return gemm_distributed(A, B, grid, precision=precision)
    Ap = wrap(local_block(A, grid, (mp, kp)), grid, (mp, kp))
    Bp = wrap(local_block(B, grid, (kp, np_)), grid, (kp, np_))
    C = gemm_distributed(Ap, Bp, grid, precision=precision)
    return trim(C.to_local(), grid, (mp, np_), (m, n))
