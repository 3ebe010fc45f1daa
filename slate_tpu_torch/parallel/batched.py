"""Batch-parallel solves: the leading batch axis sharded over the grid.

Reference analogue: SLATE's batch-BLAS tier distributes *independent*
problems, not tiles of one problem, so the batch axis is the natural grid
axis.  Each rank solves its slice of the stack with the same pure cores the
serving layer runs (:func:`slate_tpu_torch.linalg.lu.gesv_core`,
:func:`~slate_tpu_torch.linalg.chol.posv_core`), and there are **no
collectives**: the batch tier is embarrassingly parallel.

The serving queue stays single-device; this entry is for bulk offline
batches — many same-bucket solves in one sharded call.
"""

from __future__ import annotations

import torch

from ..core.exceptions import slate_assert
from ..linalg.chol import posv_core
from ..linalg.lu import gesv_core
from ..obs import instrument
from .collectives import axis_index
from .distribute import chunk, gather
from .mesh import FLAT, ProcessGrid


def _batch_sharded(core, grid: ProcessGrid, a, b):
    """Run ``core`` on this rank's slice of the batch (both grid dims
    flattened, P = p*q slices, no collectives); results shard dim 0."""
    from torch.distributed.tensor import DTensor, Shard

    P = grid.p * grid.q
    slate_assert(a.ndim == 3 and b.ndim == 3,
                 f"batched distributed solve needs (batch, m, n) operands, "
                 f"got {tuple(a.shape)} / {tuple(b.shape)}")
    slate_assert(a.shape[0] % P == 0,
                 f"batch {a.shape[0]} must divide the grid size {P} evenly "
                 f"(pad the batch to a multiple — serve.BucketPolicy's batch "
                 f"rounding does)")
    nbatch = a.shape[0]
    s, e = chunk(nbatch, P, axis_index(grid, FLAT))
    a, b = gather(a), gather(b)
    outs = core(a[s:e], b[s:e])
    res = []
    for o in outs:
        shape = (nbatch,) + tuple(o.shape[1:])
        stride = tuple(int(torch.tensor(shape[k + 1:]).prod()) for k in range(len(shape)))
        res.append(DTensor.from_local(o.contiguous(), grid.mesh, (Shard(0), Shard(0)),
                                      run_check=False, shape=torch.Size(shape),
                                      stride=stride))
    return tuple(res)


@instrument
def gesv_batched_distributed(a, b, grid: ProcessGrid):
    """Batched gesv with the batch axis sharded over the grid's ranks.

    ``a`` (batch, n, n), ``b`` (batch, n, nrhs); batch must be a multiple of
    ``grid.p * grid.q``.  Returns ``(x, perm, info)`` with per-request perm and
    info (the raw sharded kernel; :func:`slate_tpu_torch.serve.gesv_batched`
    handles the escalation ladder)."""
    return _batch_sharded(gesv_core, grid, a, b)


@instrument
def posv_batched_distributed(a, b, grid: ProcessGrid):
    """Batched SPD solve with the batch axis sharded over the grid (full
    Hermitian operands).  Returns ``(x, info)`` per request."""
    return _batch_sharded(posv_core, grid, a, b)
