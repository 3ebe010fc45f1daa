"""Debug-mode invariant checks (≅ src/auxiliary/Debug.{cc,hh}, 494 LoC).

The reference's Debug class dumps tile states and verifies invariants of the tile
cache: ``checkTilesLives`` (every directory entry has a live tile),
``checkTilesLayout``, and memory-leak counters (Debug.hh:46-66).  One tensor per
matrix removes the tile-coherence bug class (SURVEY.md §5.2), so the invariants
that remain meaningful are directory consistency, value sanity, and structural
properties of the typed matrices — plus pool leak accounting from the native
runtime.  The value checks run where the data lives and bring back one scalar or
index each.  All checks raise ``SlateError`` with a precise message, or return
True.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.exceptions import SlateError, slate_assert
from ..core.matrix import (BaseBandMatrix, BaseMatrix, HermitianMatrix, as_array,
                           enable_pool_tracking, live_workspace_report)

__all__ = ["check_finite", "check_owner_map", "check_structure", "check_no_leaks",
           "tile_summary", "enable_pool_tracking", "live_workspace_report"]


def _data(A) -> torch.Tensor:
    return as_array(A) if isinstance(A, (BaseMatrix, torch.Tensor)) else \
        torch.as_tensor(np.asarray(A))


def check_finite(A, name: str = "A") -> bool:
    """No NaN/Inf anywhere in the backing data (the value-sanity scan the
    reference's printTiles eyeballs)."""
    a = _data(A)
    bad = ~torch.isfinite(a).reshape(-1)
    if bad.numel() == 0:
        return True
    count, first = torch.stack([bad.sum(), bad.to(torch.uint8).argmax()]).tolist()
    if count:
        idx = tuple(int(v) for v in np.unravel_index(first, tuple(a.shape)))
        raise SlateError(f"{name} has {count} non-finite entries, first at {idx}")
    return True


def check_owner_map(A, name: str = "A") -> bool:
    """Directory consistency (≅ checkTilesLives): every tile has exactly one
    owner in [0, p*q), and the per-rank local_tiles lists partition the grid."""
    slate_assert(isinstance(A, BaseMatrix), "check_owner_map needs a Matrix")
    order, p, q = A.gridinfo()
    om = A.owner_map()
    if om.shape != (A.mt, A.nt):
        raise SlateError(f"{name}: owner map shape {om.shape} != tile grid "
                         f"({A.mt}, {A.nt})")
    if om.size and (om.min() < 0 or om.max() >= p * q):
        raise SlateError(f"{name}: owner out of range [0, {p*q}): "
                         f"[{om.min()}, {om.max()}]")
    count = 0
    for rank in range(p * q):
        tiles = A.local_tiles(rank)
        if len(tiles):
            owners = om[tiles[:, 0], tiles[:, 1]]
            wrong = np.flatnonzero(owners != rank)
            if wrong.size:
                i, j = (int(v) for v in tiles[wrong[0]])
                raise SlateError(f"{name}: tile ({i},{j}) listed for rank {rank} "
                                 f"but owned by {om[i, j]}")
        count += len(tiles)
    if count != om.size:
        raise SlateError(f"{name}: local tile lists cover {count} of {om.size}")
    return True


def check_structure(A, name: str = "A", tol: float = 0.0) -> bool:
    """Typed-matrix structural invariants: Hermitian matrices have (numerically)
    real diagonals, band matrices have no data outside (kl, ku)."""
    a = _data(A)
    if isinstance(A, HermitianMatrix) and a.is_complex():
        mx = float(torch.diagonal(a, dim1=-2, dim2=-1).imag.abs().amax()) \
            if min(a.shape[-2:]) else 0.0
        if mx > tol:
            raise SlateError(f"{name}: Hermitian diagonal has imaginary parts "
                             f"up to {mx:.2e}")
    if isinstance(A, BaseBandMatrix):
        m, n = a.shape[-2:]
        r = torch.arange(m, device=a.device)[:, None]
        c = torch.arange(n, device=a.device)[None, :]
        outside = (c - r > A.ku) | (r - c > A.kl)
        mx = float(torch.where(outside, a, torch.zeros((), dtype=a.dtype,
                                                       device=a.device)).abs().amax()) \
            if a.numel() else 0.0
        if mx > tol:
            raise SlateError(f"{name}: band matrix has |{mx:.2e}| outside "
                             f"(kl={A.kl}, ku={A.ku})")
    return True


def check_no_leaks(pool, name: str = "pool") -> bool:
    """Workspace pool leak check (Debug::printNumFreeMemBlocks + leak counters):
    everything allocated was freed."""
    if pool.in_use != 0:
        raise SlateError(f"{name}: {pool.in_use} of {pool.capacity} blocks "
                         f"still allocated (peak {pool.peak})")
    return True


def tile_summary(A) -> str:
    """Per-rank tile census (Debug::printTilesMaps-style dump)."""
    order, p, q = A.gridinfo()
    om = A.owner_map()
    counts = np.bincount(om.reshape(-1), minlength=p * q) if om.size else \
        np.zeros(p * q, dtype=np.int64)
    lines = [f"{type(A).__name__} {A.m}x{A.n} tiles {A.mt}x{A.nt} "
             f"grid {p}x{q} ({order})"]
    for rank in range(p * q):
        lines.append(f"  rank {rank}: {int(counts[rank])} tiles")
    return "\n".join(lines)
