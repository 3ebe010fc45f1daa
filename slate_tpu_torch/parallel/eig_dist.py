"""Distributed norms over the process grid, and the shard placement helper the
distributed solvers share.

Reference analogue: the ``internal::norm`` reductions the ``norm`` driver runs
over distributed tiles (``src/norm.cc``: ``internal::genorm`` per tile, then an
MPI allreduce).  Each rank reduces its own shard with the port's norm
reductions — on the card, the ``col_reduce``/``row_sums`` CUDA kernels
(:mod:`slate_tpu_torch.ops.cuda_norms`) — and the partials meet in one or two
all-reduces.  A triangle mask that crosses a shard is cut into pieces whose
masks start at the piece's corner, so the kernels' masks apply unchanged.

The distributed eigenvalue and SVD drivers of the JAX package's module are not
ported yet (ROADMAP.md queue A item 15b).
"""

from __future__ import annotations

import torch

from ..core.types import Norm
from ..obs import instrument
from ..ops import cuda_norms as cn
from .collectives import axis_allgather, axis_allreduce
from .distribute import BLOCK, bounds, local_block, wrap
from .mesh import COL_AXIS, FLAT, ProcessGrid, ROW_AXIS


AX = FLAT                                  # flattened grid axis


def _shard(x, grid: ProcessGrid, row: bool = True, col: bool = True):
    """``x`` (the same on every rank) placed on the grid in the block layout
    (torch.chunk shards, so any shape works); each rank keeps its shard,
    nothing moves.  A vector stays whole on every rank."""
    from .distribute import distribute

    if x.ndim != 2:
        return x
    if row and col:
        return wrap(local_block(x, grid), grid, x.shape)
    return distribute(x, grid, row, col)


def _pieces(mr: int, mc: int, d: int, uplo: str):
    """(r0, r1, c0, c1, mode) windows of an mr×mc shard whose triangle mask
    keeps i - j >= d (lower) or i - j <= d (upper), d = col0 - row0."""
    if uplo == "lower":
        if d >= 0:
            return [(min(d, mr), mr, 0, mc, cn._MODE_LOWER)]
        e = min(-d, mc)
        return [(0, mr, 0, e, cn._MODE_GE), (0, mr, e, mc, cn._MODE_LOWER)]
    if uplo == "upper":
        if d <= 0:
            return [(0, mr, min(-d, mc), mc, cn._MODE_UPPER)]
        e = min(d, mr)
        return [(0, e, 0, mc, cn._MODE_GE), (e, mr, 0, mc, cn._MODE_UPPER)]
    return [(0, mr, 0, mc, cn._MODE_GE)]


def _kernel_dtype(a: torch.Tensor) -> bool:
    return a.dtype in (torch.float32, torch.float64)


def _col(piece, mode, op):
    if _kernel_dtype(piece):
        return cn.col_reduce(piece, mode, op=op)
    return cn.col_reduce_plain(piece, mode, op=op)


def _row(piece, mode):
    if _kernel_dtype(piece):
        return cn.row_sums(piece, mode)
    return cn.row_sums_plain(piece, mode)


def _shard_partials(a: torch.Tensor, d: int, uplo: str, kind: str) -> torch.Tensor:
    """Per-column (max/sum/sumsq) or per-row (inf) partials of the masked |a|
    of one shard, through the norm kernels (or their plain versions)."""
    mr, mc = a.shape
    rdt = a.real.dtype if a.is_complex() else a.dtype
    if kind == "inf":
        out = torch.zeros(mr, dtype=rdt, device=a.device)
        for r0, r1, c0, c1, mode in _pieces(mr, mc, d, uplo):
            if r1 > r0 and c1 > c0:
                out[r0:r1] += _row(a[r0:r1, c0:c1], mode)
        return out
    op = {"max": "max", "one": "sum", "fro": "sumsq"}[kind]
    out = torch.zeros(mc, dtype=rdt, device=a.device)
    for r0, r1, c0, c1, mode in _pieces(mr, mc, d, uplo):
        if r1 > r0 and c1 > c0:
            part = _col(a[r0:r1, c0:c1], mode, op)
            out[c0:c1] = torch.maximum(out[c0:c1], part) if op == "max" \
                else out[c0:c1] + part
    return out


@instrument
def norm_distributed(kind, A, grid: ProcessGrid, uplo: str = "general"):
    """Distributed matrix norm (src/norm.cc: per-shard partials, then an
    all-reduce).  kind: max | one | inf | fro; ``uplo`` lower/upper masks the
    triangle.  A 0-d tensor, the same on every rank."""
    k = Norm.from_string(kind) if not isinstance(kind, Norm) else kind
    name = {Norm.Max: "max", Norm.One: "one", Norm.Inf: "inf", Norm.Fro: "fro"}[k]
    m, n = A.shape[-2:]
    a = local_block(A, grid)
    (r0, _), (c0, _) = bounds(grid, m, n, BLOCK)
    part = _shard_partials(a, c0 - r0, uplo, name)
    if name == "max":
        return axis_allreduce(part.amax() if part.numel() else part.new_zeros(()),
                              grid, FLAT, "max")
    if name == "fro":
        return torch.sqrt(axis_allreduce(part.sum(), grid, FLAT))
    if name == "one":       # column sums over p, then the largest over q
        cols = axis_allreduce(part, grid, ROW_AXIS)
        top = cols.amax() if cols.numel() else cols.new_zeros(())
        return axis_allreduce(top, grid, COL_AXIS, "max")
    rows = axis_allreduce(part, grid, COL_AXIS)          # inf: row sums over q
    top = rows.amax() if rows.numel() else rows.new_zeros(())
    return axis_allreduce(top, grid, ROW_AXIS, "max")


@instrument
def col_norms_distributed(A, grid: ProcessGrid) -> torch.Tensor:
    """Distributed column max-norms (internal::colNorms analogue): the whole
    length-n vector on every rank."""
    m, n = A.shape[-2:]
    a = local_block(A, grid)
    part = _shard_partials(a, 0, "general", "max")
    cols = axis_allreduce(part, grid, ROW_AXIS, "max")
    c = -(-n // grid.q)
    if cols.numel() < c:
        cols = torch.cat([cols, cols.new_zeros(c - cols.numel())])
    return axis_allgather(cols, grid, COL_AXIS)[:n]
