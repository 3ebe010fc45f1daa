"""Save / load of (distributed) matrices.

Reference analogue: none — SLATE has no checkpointing (SURVEY.md §5.4 records the
gap); the nearest mechanisms are ``redistribute`` (migrate between distributions)
and ``print``'s gather.  npz-based save/load that round-trips the matrix data
*and* its layout metadata (type, uplo/diag/band, tile size, grid), so a solver
pipeline can be resumed on a different grid.

The file layout is the JAX package's (``data`` + ``meta_*`` entries), so a file
written by either package loads in the other.  Loading puts the data on
``device`` (``cuda`` unless the caller names the CPU; raises without CUDA).  A
grid-bound wrapper is saved from its gathered shards, written once by grid rank
0; loading with ``p, q`` binds the matrix to a ``ProcessGrid`` of p·q ranks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.matrix import (BandMatrix, BaseMatrix, HermitianBandMatrix,
                           HermitianMatrix, Matrix, SymmetricMatrix,
                           TrapezoidMatrix, TriangularBandMatrix,
                           TriangularMatrix, resolve_device)
from ..core.types import GridOrder, Uplo
from .printing import _host

__all__ = ["save_matrix", "load_matrix"]

_TYPES = {c.__name__: c for c in
          (Matrix, TrapezoidMatrix, TriangularMatrix, SymmetricMatrix,
           HermitianMatrix, BandMatrix, TriangularBandMatrix,
           HermitianBandMatrix)}


def save_matrix(path: str, A, **extra) -> None:
    """Write matrix + layout metadata to ``path`` (.npz).  A grid-bound
    wrapper's shards are gathered (a collective: every rank of the grid calls
    this) and grid rank 0 writes the file; the call returns on every rank once
    the file is complete."""
    meta: dict = dict(extra)
    grid = None
    outside = False                 # a rank outside the wrapper's grid writes nothing
    if isinstance(A, BaseMatrix):
        st = A.storage
        order, p, q = A.gridinfo()
        meta.update(type=type(A).__name__, mb=st.mb, nb=st.nb,
                    p=p, q=q, order=str(order))
        # non-uniform per-index tile grids survive the round trip
        if st.mb_sizes is not None:
            meta["tile_mb"] = np.asarray(st.mb_sizes, dtype=np.int64)
        if st.nb_sizes is not None:
            meta["tile_nb"] = np.asarray(st.nb_sizes, dtype=np.int64)
        for attr in ("uplo", "diag"):
            if hasattr(A, attr):
                meta[attr] = str(getattr(A, attr))
        for attr in ("kl", "ku", "kd"):
            if hasattr(A, attr):
                meta[attr] = int(getattr(A, attr))
        data = _host(st.array)            # a grid-bound storage's shards gathered
        grid = st.grid if st.on_grid() else None
        outside = getattr(st.grid, "rank", 0) < 0
    else:
        meta["type"] = "array"
        data = _host(A)
    if (grid is None and not outside) or (grid is not None and grid.rank == 0):
        np.savez(path, data=data, **{f"meta_{k}": np.asarray(v)
                                     for k, v in meta.items()})
    if grid is not None:            # no rank returns before the file is there
        from ..parallel.collectives import axis_allreduce
        from ..parallel.mesh import FLAT

        axis_allreduce(torch.zeros(1, device=grid.device), grid, FLAT)


def load_matrix(path: str, p: Optional[int] = None, q: Optional[int] = None,
                device=None):
    """Reconstruct the matrix on ``device`` (default ``cuda``).  With ``p`` or
    ``q`` it is re-gridded: bound to a ``ProcessGrid`` of p·q ranks (the
    redistribute-on-restore path; needs a process group that large); else it
    keeps the saved grid shape as metadata only.  A plain array comes back as
    a tensor."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        data = z["data"]
        meta = {k[len("meta_"):]: z[k][()] for k in z.files if k.startswith("meta_")}
    tname = str(meta.get("type", "array"))
    t = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    if tname == "array":
        return t
    cls = _TYPES[tname]
    nb = int(meta["nb"])
    # only a Matrix restores its grid order (as in the JAX package)
    order = (GridOrder.from_string(str(meta["order"])) if tname == "Matrix"
             else GridOrder.Col)
    grid = None
    if p is not None or q is not None:
        from ..parallel.mesh import ProcessGrid

        p = int(meta["p"]) if p is None else int(p)
        q = int(meta["q"]) if q is None else int(q)
        grid = ProcessGrid.cached(p, q, device=dev, order=order)
    p = int(meta["p"]) if p is None else p
    q = int(meta["q"]) if q is None else q
    kw = {"nb": nb, "p": p, "q": q, "grid": grid}

    if tname == "Matrix":
        # Matrix supports rectangular tiles + grid order; restore them exactly
        if "tile_mb" in meta:
            kw["tile_mb"] = [int(b) for b in np.atleast_1d(meta["tile_mb"])]
        if "tile_nb" in meta:
            kw["tile_nb"] = [int(b) for b in np.atleast_1d(meta["tile_nb"])]
        return Matrix.from_array(t, mb=int(meta.get("mb", nb)), order=order, **kw)
    if tname == "BandMatrix":
        M = BandMatrix(t.shape[0], t.shape[1], int(meta["kl"]), int(meta["ku"]),
                       dtype=t.dtype, device=dev, **kw)
        M.set_array(t)
        return M
    if tname in ("TriangularBandMatrix", "HermitianBandMatrix"):
        M = cls(Uplo.from_string(str(meta["uplo"])), t.shape[0], int(meta["kd"]),
                dtype=t.dtype, device=dev, **kw)
        M.set_array(t)
        return M
    uplo = Uplo.from_string(str(meta["uplo"]))
    if "diag" in meta and tname in ("TriangularMatrix", "TrapezoidMatrix"):
        kw["diag"] = str(meta["diag"])
    return cls.from_array(uplo, t, **kw)
