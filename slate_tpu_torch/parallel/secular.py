"""Distributed secular-equation solve for the D&C merges.

Reference analogue: ``src/stedc_secular.cc`` — the reference splits the
secular roots of one merge across MPI ranks (each rank runs laed4 on its
share and the eigenvalues are allgathered).

The merge's bisection (:func:`..linalg.stedc._secular_bisect`) has no
cross-bracket dependencies: each root needs the whole pole set (d, z2: O(m),
the same on every rank) but only its own bracket state.  So each rank of the
flattened grid bisects its own ``m_pad / P`` brackets, and one all-gather
assembles the root vectors on every rank: per-rank work drops from
O(m²·iters) to O(m²·iters / P).
"""

from __future__ import annotations

import torch

from ..obs import instrument
from .collectives import axis_allgather, axis_index
from .mesh import FLAT, ProcessGrid


@instrument
def secular_roots_sharded(d, z2, rho, grid: ProcessGrid):
    """All m secular roots with the bisection sharded over the grid.

    Same contract as ``linalg.stedc._secular_roots``: returns (t, s, lam),
    the same on every rank.  The prep (bracket widths and closer-pole
    selection, one f sweep) stays replicated: it is 1/_BISECT_ITERS of the
    work; the 90-step loop is what shards.  Padded brackets bisect against a
    pole far above the spectrum, so every denominator stays away from zero,
    and are cut off after the gather."""
    from ..linalg.stedc import _secular_bisect, _secular_prep

    d, z2 = torch.as_tensor(d), torch.as_tensor(z2)
    rho = torch.as_tensor(rho, dtype=d.dtype, device=d.device)
    m = d.shape[0]
    nproc = grid.size
    pole, sigma, gaps, use_lower = _secular_prep(d, z2, rho)
    c = -(-m // nproc)
    pad = c * nproc - m
    if pad:
        far = d[-1] + gaps[-1] + 1.0
        pole = torch.cat([pole, far.expand(pad)])
        sigma = torch.cat([sigma, sigma.new_ones(pad)])
        gaps = torch.cat([gaps, gaps.new_ones(pad)])
        use_lower = torch.cat([use_lower, use_lower.new_ones(pad)])
    me = axis_index(grid, FLAT)
    sl = slice(me * c, (me + 1) * c)
    t, s, lam = _secular_bisect(d, z2, rho, pole[sl], sigma[sl], gaps[sl],
                                use_lower[sl])
    out = axis_allgather(torch.stack([t, s, lam]), grid, FLAT, dim=1)[:, :m]
    return out[0], out[1], out[2]
