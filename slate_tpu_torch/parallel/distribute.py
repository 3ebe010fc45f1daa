"""Distributing matrices over a ProcessGrid, and moving them between layouts.

Reference analogue: the tile→rank block-cyclic maps (func.hh:100-217) applied at
matrix construction (MatrixStorage.hh:494-499), plus ``slate::redistribute``
(src/redistribute.cc:1-154).

A distributed operand is a ``DTensor`` on the grid's mesh in one of four
layouts: the 2-D block layout (rows over p, cols over q: ``[Shard(0),
Shard(1)]``), the 1-D row layout over the flattened grid (``[Shard(0),
Shard(0)]``, p-major), the 1-D column layout over the flattened grid
(``[Shard(1), Shard(1)]``, p-major: compact band storage) or replicated.  Shards follow ``torch.chunk``: the first
shards hold ``ceil(m/parts)`` rows and the last may hold fewer or none.
Every driver also accepts a plain tensor that is the same on every rank; each
rank then slices its own shard, which moves no data.

2D **block-cyclic** ownership (tile (i, j) → rank (i%p, j%q)) is a block
layout composed with a tile permutation (:func:`cyclic_to_blocked`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.exceptions import slate_assert
from .collectives import axis_allgather
from .mesh import COL_AXIS, FLAT, ProcessGrid, ROW_AXIS, Sharding

BLOCK, ROWS, COLS, REPL = "block", "rows", "cols", "replicated"


def ceil_mult(x: int, mult: int) -> int:
    """Round up to a multiple — the shared edge policy (pad-and-mask)."""
    return -(-x // mult) * mult


def lcm(a: int, b: int) -> int:
    """Least common multiple (shard-alignment unit for (p, q) grids)."""
    return a * b // math.gcd(a, b)


def pad2d(a: torch.Tensor, row_mult: int = 1, col_mult: int = 1) -> torch.Tensor:
    """Zero-pad the trailing 2-D dims up to multiples (no-op when aligned)."""
    m, n = a.shape[-2:]
    pm, pn = ceil_mult(m, row_mult), ceil_mult(n, col_mult)
    if (pm, pn) == (m, n):
        return a
    return torch.nn.functional.pad(a, (0, pn - n, 0, pm - m))


def chunk(n: int, parts: int, idx: int) -> Tuple[int, int]:
    """[start, stop) of shard ``idx`` of ``n`` items over ``parts`` shards,
    with ``torch.chunk`` sizes (the DTensor ``Shard`` split)."""
    c = -(-n // parts) if n else 0
    s = min(idx * c, n)
    return s, min(s + c, n)


def bounds(grid: ProcessGrid, m: int, n: int, layout: str = BLOCK):
    """((r0, r1), (c0, c1)): this rank's window of an m×n operand."""
    if layout == REPL:
        return (0, m), (0, n)
    return _window(grid, m, n, layout, grid.my_coords)


def _placements(grid: ProcessGrid, layout: str):
    from torch.distributed.tensor import Shard

    if layout == COLS:
        return (Shard(1), Shard(1))
    return {BLOCK: grid.spec(), ROWS: grid.row_spec(),
            REPL: grid.replicated()}[layout].placements


def layout_of(x) -> Optional[str]:
    """The layout name of a DTensor (None for a plain tensor or another one)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return None
    pl = tuple(x.placements)
    if pl == (Shard(0), Shard(1)) and x.ndim == 2:
        return BLOCK
    if pl == (Shard(0), Shard(0)):
        return ROWS
    if pl == (Shard(1), Shard(1)) and x.ndim == 2:
        return COLS
    if pl == (Replicate(), Replicate()):
        return REPL
    return None


def is_dist(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def wrap(local: torch.Tensor, grid: ProcessGrid, shape, layout: str = BLOCK):
    """A DTensor of global ``shape`` from this rank's shard (no data moves)."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = tuple(int(np.prod(shape[k + 1:])) for k in range(len(shape)))
    return DTensor.from_local(local, grid.mesh, _placements(grid, layout),
                              run_check=False, shape=shape, stride=stride)


def _gather_dim(local: torch.Tensor, grid, axis, dim: int, total: int) -> torch.Tensor:
    """All-gather chunk-sized shards along ``dim`` (padding the short ones)."""
    from .collectives import axis_size

    parts = axis_size(grid, axis)
    c = -(-total // parts) if total else 0
    if local.shape[dim] < c:
        pad = list(local.shape)
        pad[dim] = c - local.shape[dim]
        local = torch.cat([local, local.new_zeros(pad)], dim=dim)
    full = axis_allgather(local, grid, axis, dim=dim)
    return full.narrow(dim, 0, total)


def gather(x, grid: Optional[ProcessGrid] = None) -> torch.Tensor:
    """The whole operand on every rank, as a plain tensor: the explicit
    counterpart of reading a sharded ``jax.Array`` as one array.  Plain
    tensors pass through."""
    if not is_dist(x):
        return x
    layout = layout_of(x)
    mesh = x.device_mesh
    loc = x.to_local()
    if layout == REPL:
        return loc
    if layout == BLOCK:
        rows = _gather_dim(loc, mesh, COL_AXIS, 1, x.shape[1])
        return _gather_dim(rows, mesh, ROW_AXIS, 0, x.shape[0])
    if layout == ROWS:
        return _gather_dim(loc, mesh, FLAT, 0, x.shape[0])
    if layout == COLS:
        return _gather_dim(loc, mesh, FLAT, 1, x.shape[1])
    pl = set(x.placements)
    if len(pl) == 1 and getattr(next(iter(pl)), "dim", None) is not None:
        # one dim spread over the flattened grid (a reflector stack's rows)
        d = next(iter(pl)).dim
        return _gather_dim(loc, mesh, FLAT, d, x.shape[d])
    return x.full_tensor()


def local_block(x, grid: ProcessGrid, shape=None, layout: str = BLOCK,
                eye_from: Optional[int] = None) -> torch.Tensor:
    """This rank's shard of ``x`` zero-padded to ``shape``, with ones on the
    diagonal from index ``eye_from`` on (the identity tail that keeps a padded
    matrix SPD or invertible).

    A DTensor already in ``layout`` at ``shape`` gives a copy of its local
    shard; a block-, row- or column-layout DTensor on the grid's mesh in another
    layout or shape sends each rank just the pieces of its window
    (:func:`_fetch`); any other DTensor is gathered first; a plain tensor is
    sliced.  The result is always a new tensor, which the drivers factor in
    place."""
    m0, n0 = x.shape[-2:]
    shape = tuple(shape) if shape is not None else (m0, n0)
    if is_dist(x):
        src = layout_of(x)
        if tuple(x.shape) == shape and src == layout:
            return x.to_local().clone(memory_format=torch.contiguous_format)
        if src in _FETCHABLE and layout in _FETCHABLE \
                and x.device_mesh is grid.mesh:
            out = _fetch(x, grid, shape, layout)
            _eye_tail(out, grid, shape, layout, eye_from)
            return out
        x = gather(x)
    (r0, r1), (c0, c1) = bounds(grid, shape[0], shape[1], layout)
    if (m0, n0) == shape and eye_from is None:
        return x[r0:r1, c0:c1].clone(memory_format=torch.contiguous_format)
    out = x.new_zeros((r1 - r0, c1 - c0))
    rr, cc = min(r1, m0), min(c1, n0)
    if rr > r0 and cc > c0:
        out[:rr - r0, :cc - c0] = x[r0:rr, c0:cc]
    _eye_tail(out, grid, shape, layout, eye_from)
    return out


def _eye_tail(out, grid, shape, layout, eye_from) -> None:
    """Ones on the diagonal of this rank's window from index ``eye_from`` on."""
    if eye_from is None:
        return
    (r0, r1), (c0, c1) = bounds(grid, shape[0], shape[1], layout)
    lo = max(eye_from, r0, c0)
    hi = min(r1, c1, shape[0], shape[1])
    if hi > lo:
        idx = torch.arange(lo, hi, device=out.device)
        out[idx - r0, idx - c0] = 1


_FETCHABLE = (BLOCK, ROWS, COLS)


def _window(grid: ProcessGrid, m: int, n: int, layout: str, coords):
    """((r0, r1), (c0, c1)): the window of grid coordinate ``coords``."""
    i, j = coords
    if layout == ROWS:
        return chunk(m, grid.size, i * grid.q + j), (0, n)
    if layout == COLS:
        return (0, m), chunk(n, grid.size, i * grid.q + j)
    return chunk(m, grid.p, i), chunk(n, grid.q, j)


def _fetch(x, grid: ProcessGrid, shape, layout: str) -> torch.Tensor:
    """This rank's ``layout`` window of ``x`` zero-padded to ``shape``, for a
    DTensor ``x`` in the block, row or column layout: every rank sends each other
    rank the overlap of its shard with that rank's window, point to point,
    so a rank receives only its own window (the redistribute of
    src/redistribute.cc, tile by tile)."""
    from .collectives import _exchange, _p2p_record, _wire, is_recording

    m0, n0 = x.shape[-2:]
    src = layout_of(x)
    loc = x.to_local()
    me = grid.my_coords
    (r0, r1), (c0, c1) = _window(grid, shape[0], shape[1], layout, me)
    (s0, s1), (t0, t1) = _window(grid, m0, n0, src, me)
    out = loc.new_zeros((r1 - r0, c1 - c0))
    sends, recvs, unpack = [], [], []
    for i2 in range(grid.p):
        for j2 in range(grid.q):
            # mine to (i2, j2): my shard ∩ its window
            (a0, a1), (b0, b1) = _window(grid, shape[0], shape[1], layout, (i2, j2))
            rs, re_ = max(s0, a0), min(s1, a1)
            cs, ce = max(t0, b0), min(t1, b1)
            # from (i2, j2): its shard ∩ my window
            (x0, x1), (y0, y1) = _window(grid, m0, n0, src, (i2, j2))
            fs, fe = max(x0, r0), min(x1, r1)
            gs, ge = max(y0, c0), min(y1, c1)
            if (i2, j2) == me:
                if fe > fs and ge > gs:
                    out[fs - r0:fe - r0, gs - c0:ge - c0] = \
                        loc[fs - s0:fe - s0, gs - t0:ge - t0]
                continue
            peer = global_rank(grid, i2, j2)
            if re_ > rs and ce > cs:
                sends.append((_wire(loc[rs - s0:re_ - s0, cs - t0:ce - t0]), peer))
            if fe > fs and ge > gs:
                buf = _wire(loc.new_empty((fe - fs, ge - gs)))
                recvs.append((buf, peer))
                unpack.append((buf, fs, fe, gs, ge))
    _exchange(sends, recvs)
    if is_recording():
        _p2p_record("all-to-all", grid.mesh.mesh.flatten().tolist(), None, sends, recvs)
    for buf, fs, fe, gs, ge in unpack:
        blk = torch.view_as_complex(buf) if loc.is_complex() else buf
        out[fs - r0:fe - r0, gs - c0:ge - c0] = blk
    return out


def trim(local: torch.Tensor, grid: ProcessGrid, shape, true_shape,
         layout: str = BLOCK):
    """The DTensor of the leading ``true_shape`` window of a padded operand
    whose shard is ``local``.  Padded and true windows shard differently, so
    each rank fetches its true window from the padded shards."""
    shape, true_shape = tuple(shape), tuple(true_shape)
    padded = wrap(local, grid, shape, layout)
    if shape == true_shape:
        return padded
    return wrap(local_block(padded, grid, true_shape, layout), grid, true_shape,
                layout)


def block_spec(grid: ProcessGrid, row_shard: bool = True,
               col_shard: bool = True) -> Sharding:
    """Plain 2-D block placement: rows over p, cols over q."""
    return grid.spec(row_shard, col_shard)


def distribute(a, grid: ProcessGrid, row_shard: bool = True,
               col_shard: bool = True):
    """Place ``a`` (the same on every rank) on the grid in the block layout;
    each rank keeps its shard, nothing moves."""
    from torch.distributed.tensor import distribute_tensor

    a = gather(a)
    if row_shard and col_shard:
        return wrap(local_block(a, grid), grid, a.shape)
    return distribute_tensor(a, grid.mesh, grid.spec(row_shard, col_shard).placements,
                             src_data_rank=None)


def replicate(a, grid: ProcessGrid):
    return wrap(gather(a), grid, a.shape, REPL)


def redistribute(a, dst: Sharding):
    """Move an operand (however it lies) to ``dst`` (src/redistribute.cc)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(a, DTensor):
        return a.redistribute(dst.mesh, dst.placements)
    return distribute_tensor(a, dst.mesh, dst.placements, src_data_rank=None)


def redistribute_matrix(src, dst) -> None:
    """``slate::redistribute(A, B)`` on wrappers (src/redistribute.cc:1-154):
    copy ``src``'s logical content into ``dst``, which keeps its own grid
    placement."""
    from ..core.matrix import BaseMatrix

    slate_assert(isinstance(src, BaseMatrix) and isinstance(dst, BaseMatrix),
                 "redistribute_matrix expects matrix wrappers")
    slate_assert(src.shape == dst.shape,
                 f"shape mismatch: {src.shape} vs {dst.shape}")
    dst.set_array(src.array)


def cyclic_permutation(n: int, nb: int, nparts: int) -> np.ndarray:
    """Element permutation turning block-cyclic tile ownership into contiguous
    blocks: ``a[perm]`` groups the rows of part 0's tiles first, then part 1's."""
    slate_assert(n % nb == 0, "cyclic_permutation requires tile-aligned n (pad first)")
    nt = n // nb
    order = []
    for part in range(nparts):
        for t in range(part, nt, nparts):
            order.extend(range(t * nb, (t + 1) * nb))
    return np.array(order, dtype=np.int64)


def cyclic_to_blocked(a, grid: ProcessGrid, nb: int) -> torch.Tensor:
    """Permute a matrix so 2D block-cyclic (nb-tile) ownership becomes the
    block layout of ``grid.spec()`` (the ``fromScaLAPACK`` path, Matrix.hh:347)."""
    a = gather(a)
    m, n = a.shape[-2:]
    rp = torch.from_numpy(cyclic_permutation(m, nb, grid.p)).to(a.device)
    cp = torch.from_numpy(cyclic_permutation(n, nb, grid.q)).to(a.device)
    return a[..., rp, :][..., :, cp]


def blocked_to_cyclic(a, grid: ProcessGrid, nb: int) -> torch.Tensor:
    """Inverse of :func:`cyclic_to_blocked`."""
    a = gather(a)
    m, n = a.shape[-2:]
    rinv = torch.from_numpy(np.argsort(cyclic_permutation(m, nb, grid.p))).to(a.device)
    cinv = torch.from_numpy(np.argsort(cyclic_permutation(n, nb, grid.q))).to(a.device)
    return a[..., rinv, :][..., :, cinv]


def global_rank(grid: ProcessGrid, i: int, j: int) -> int:
    """World rank of grid coordinate (i, j)."""
    return int(grid.mesh.mesh[i, j])


def transpose_local(local: torch.Tensor, grid: ProcessGrid, m: int, n: int,
                    conj: bool = False) -> torch.Tensor:
    """This rank's block-layout shard of op(A) = A^T (A^H with ``conj``), for an
    m×n A whose block-layout shard is ``local``: every rank sends each other
    rank the piece of its block that lands in that rank's block of the
    transpose (one all-to-all of unequal blocks, point to point)."""
    from .collectives import _exchange, _p2p_record, _wire, is_recording

    i, j = grid.my_coords
    (r0, r1), (c0, c1) = bounds(grid, m, n)
    (t0, t1), (u0, u1) = bounds(grid, n, m)          # my window of A^T
    out = local.new_zeros((t1 - t0, u1 - u0))
    sends, recvs, unpack = [], [], []
    for i2 in range(grid.p):
        for j2 in range(grid.q):
            # to (i2, j2): A[rows ∩ its cols of A^T, cols ∩ its rows of A^T]
            (a0, a1), (b0, b1) = bounds_at(grid, n, m, i2, j2)
            rs, re_ = max(r0, b0), min(r1, b1)
            cs, ce = max(c0, a0), min(c1, a1)
            # from (i2, j2): its A window ∩ my A^T window
            (x0, x1), (y0, y1) = bounds_at(grid, m, n, i2, j2)
            fs, fe = max(x0, u0), min(x1, u1)
            gs, ge = max(y0, t0), min(y1, t1)
            if (i2, j2) == (i, j):
                if re_ > rs and ce > cs:
                    blk = local[rs - r0:re_ - r0, cs - c0:ce - c0].transpose(0, 1)
                    out[cs - t0:ce - t0, rs - u0:re_ - u0] = blk.conj() if conj else blk
                continue
            peer = global_rank(grid, i2, j2)
            if re_ > rs and ce > cs:
                sends.append((_wire(local[rs - r0:re_ - r0, cs - c0:ce - c0]), peer))
            if fe > fs and ge > gs:
                buf = _wire(local.new_empty((fe - fs, ge - gs)))
                recvs.append((buf, peer))
                unpack.append((buf, fs, fe, gs, ge))
    _exchange(sends, recvs)
    if is_recording():
        _p2p_record("all-to-all", grid.mesh.mesh.flatten().tolist(), None, sends, recvs)
    for buf, fs, fe, gs, ge in unpack:
        blk = torch.view_as_complex(buf) if local.is_complex() else buf
        blk = blk.transpose(0, 1)
        out[gs - t0:ge - t0, fs - u0:fe - u0] = blk.conj() if conj else blk
    return out


def bounds_at(grid: ProcessGrid, m: int, n: int, i: int, j: int):
    """Block-layout window of grid coordinate (i, j) for an m×n operand."""
    return chunk(m, grid.p, i), chunk(n, grid.q, j)


def global_index(grid: ProcessGrid, m: int, n: int, layout: str = BLOCK,
                 device=None):
    """(rows, cols) global index vectors of this rank's window."""
    (r0, r1), (c0, c1) = bounds(grid, m, n, layout)
    return (torch.arange(r0, r1, device=device)[:, None],
            torch.arange(c0, c1, device=device)[None, :])


def full_hermitian(A, grid: ProcessGrid, lower: bool, herm: bool = True):
    """The full Hermitian (``herm``) or symmetric matrix from the stored
    triangle of a square operand, in the block layout (``tri_to_full`` on a
    grid): each rank keeps its block of the triangle and receives its block
    of the mirrored strict triangle in one block exchange, never the whole
    matrix.  A Hermitian diagonal is taken real."""
    n = A.shape[-1]
    loc = local_block(A, grid)
    rows, cols = global_index(grid, n, n, device=loc.device)
    zero = torch.zeros((), dtype=loc.dtype, device=loc.device)
    strict = torch.where(rows > cols if lower else rows < cols, loc, zero)
    d = loc.real.to(loc.dtype) if herm and loc.is_complex() else loc
    diag = torch.where(rows == cols, d, zero)
    mirror = transpose_local(strict, grid, n, n, conj=herm and loc.is_complex())
    return wrap(strict + mirror + diag, grid, (n, n))


def diagonal(A, grid: ProcessGrid) -> torch.Tensor:
    """The diagonal of a block-layout operand, whole on every rank: each rank
    contributes the entries its block holds, and one all-reduce of
    min(m, n) elements sums them."""
    from .collectives import axis_allreduce

    m, n = A.shape[-2:]
    loc = local_block(A, grid)
    rows, cols = global_index(grid, m, n, device=loc.device)
    on = rows == cols
    d = loc.new_zeros((min(m, n),))
    r = rows.expand_as(loc)[on]
    d[r] = loc[on]
    return axis_allreduce(d, grid, FLAT)
