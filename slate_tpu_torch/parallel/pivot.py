"""Shared tournament-pivoting machinery for the distributed factorizations.

One implementation of the CALU candidate rounds (internal_getrf_tntpiv.cc
semantics: block-local partially-pivoted LUs, then one stacked LU over the
gathered winners) and of the LAPACK-ipiv-compatible sequential-swap step
permutation, used by the square tournament LU and the tall TSLU.

Pivot rows and permutations are small, so they live on the host as numpy
int64; a panel's pivots cost one device→host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .collectives import axis_allgather, axis_allreduce


def _lu_perm(x: torch.Tensor, k: int) -> np.ndarray:
    """Leading ``k`` entries of the row permutation of a partially pivoted LU
    of ``x`` (row i of P·x is row perm[i] of x), on the host."""
    _, piv, _ = torch.linalg.lu_factor_ex(x)
    rows = np.arange(x.shape[0])
    for i, one_based in enumerate(piv.cpu().numpy().tolist()):
        j = one_based - 1
        rows[i], rows[j] = rows[j], rows[i]
    return rows[:k]


def _fallback(piv: np.ndarray, k0: int, nb: int) -> np.ndarray:
    return np.where(piv >= k0, piv, k0 + np.arange(nb))


def tournament_piv(W, grow, k0: int, nb: int, nprocs: int, grid, ax) -> np.ndarray:
    """Two-round tournament over grid axis ``ax``.

    ``W``: my rows of the panel (mr, nb); ``grow``: global row index per local
    row (int64 tensor); ``k0``: first eligible global row.  Returns the nb
    winning global rows in pivot order (numpy), with degenerate slots
    (singular trailing block) falling back to the identity ``k0 + i``.
    """
    cand_ok = grow >= k0
    Wm = torch.where(cand_ok[:, None], W, torch.zeros_like(W))
    sel = torch.from_numpy(_lu_perm(Wm, nb)).to(W.device)
    cand_idx = torch.where(cand_ok[sel], grow[sel], torch.full_like(grow[sel], -1))
    cand_rows = torch.where((cand_idx >= 0)[:, None], W[sel], torch.zeros_like(W[sel]))
    C = axis_allgather(cand_rows, grid, ax, dim=0)            # (nprocs*nb, nb)
    I = axis_allgather(cand_idx, grid, ax, dim=0).cpu().numpy()
    piv = I[_lu_perm(C, nb)]
    return _fallback(piv, k0, nb)


def partialpiv_piv(W, grow, k0: int, nb: int, nprocs: int, grid, ax) -> np.ndarray:
    """Classic partial-pivot panel selection (``lu_panel="pp"``): one
    all-gather of the full panel, one partial-pivot LU.  Exact LAPACK partial
    pivoting at O(m·nb) gather elements per step."""
    cand_ok = grow >= k0
    Wm = torch.where(cand_ok[:, None], W, torch.zeros_like(W))
    C = axis_allgather(Wm, grid, ax, dim=0)
    I = axis_allgather(torch.where(cand_ok, grow, torch.full_like(grow, -1)),
                       grid, ax, dim=0).cpu().numpy()
    piv = I[_lu_perm(C, nb)]
    return _fallback(piv, k0, nb)


_PANEL_SCHEMES = {"tournament": tournament_piv, "pp": partialpiv_piv}


def select_pivots(scheme: str, W, grow, k0: int, nb: int, nprocs: int, grid, ax):
    """Panel pivot-selection dispatch (``Options.lu_panel``: "tournament" |
    "pp").  Unknown schemes raise — never a silent tournament fallback."""
    fn = _PANEL_SCHEMES.get(scheme)
    if fn is None:
        raise ValueError(f"lu_panel must be one of {sorted(_PANEL_SCHEMES)}, "
                         f"got {scheme!r}")
    return fn(W, grow, k0, nb, nprocs, grid, ax)


def step_permutation(piv, k0: int, npad: int, nb: int) -> np.ndarray:
    """Replay the nb sequential interchanges ``position k0+i <-> row piv[i]``
    into a length-npad permutation (new position -> old position), the
    LAPACK-ipiv-compatible form every distributed factorization composes into
    its global ``perm``.  Out-of-range positions drop."""
    piv = np.asarray(piv)
    sp = np.arange(npad)
    spos = np.arange(npad)
    for i in range(nb):
        a = k0 + i
        b = spos[min(max(int(piv[i]), 0), npad - 1)]
        ra, rb = sp[min(a, npad - 1)], sp[b]
        if a < npad:
            sp[a] = rb
        sp[b] = ra
        spos[rb] = a
        spos[ra] = b
    return sp


def extract_rows(X_loc, S, ri: int, mr: int, grid, ax) -> torch.Tensor:
    """Replicated copy of global rows ``S`` (numpy) from a row-block-sharded
    shard: owners contribute, one masked sum replicates (the tileBcast /
    permuteRows gather half)."""
    loc = np.asarray(S) - ri * mr
    own = (loc >= 0) & (loc < mr)
    idx = torch.from_numpy(np.clip(loc, 0, mr - 1)).to(X_loc.device)
    rows = X_loc[idx]
    mask = torch.from_numpy(own).to(X_loc.device)
    rows = torch.where(mask[:, None], rows, torch.zeros_like(rows))
    return axis_allreduce(rows, grid, ax)


def scatter_rows(X_loc, S, rows, ri: int, mr: int) -> torch.Tensor:
    """Write replicated ``rows`` into positions ``S`` in place: each owner
    keeps its slice, everyone else drops."""
    dst = np.asarray(S) - ri * mr
    own = (dst >= 0) & (dst < mr)
    if own.any():
        sel = torch.from_numpy(np.nonzero(own)[0]).to(X_loc.device)
        X_loc[torch.from_numpy(dst[own]).to(X_loc.device)] = rows[sel]
    return X_loc


def exchange_rows(X_loc, S, src, ri: int, mr: int, grid, ax) -> torch.Tensor:
    """Move rows ``src`` into positions ``S`` (the ≤2nb dirty-row exchange:
    one gather sum + one owner scatter)."""
    return scatter_rows(X_loc, S, extract_rows(X_loc, src, ri, mr, grid, ax),
                        ri, mr)
