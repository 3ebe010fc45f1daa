"""Software-pipelined (lookahead) distributed Cholesky — the reference's
lookahead task pipeline in SPMD form.

``potrf_distributed(..., lookahead >= 2)`` — and through it the ``potrf``
driver's ``Option::Lookahead`` — routes here.

Reference analogue: ``src/potrf.cc:84-195`` — the task DAG gives the next panel
column a high-priority update so its factorization and broadcast overlap the
bulk trailing update (``potrf.cc:136-177``).

Each step, in program order:

1. **prioritized column update**: the owner of panel k+1 applies panel k to
   that one block column only;
2. **next-panel broadcast + factor**: the updated column is broadcast (a
   masked sum over the flattened grid) and factored on every rank;
3. **bulk trailing update**: every remaining local column gets the rank-nb
   update from panel k.

Step 3 does not depend on step 2's collective, which is what lets a backend
that runs collectives asynchronously hide it.  The layout is 1-D
block-cyclic over the flattened grid (block column j lives on rank j mod d),
the distribution ScaLAPACK uses so that every step keeps all ranks busy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg.chol import _chol_blocked
from ..obs import instrument
from .collectives import axis_allgather, axis_allreduce, axis_index
from .distribute import cyclic_permutation, gather
from .mesh import FLAT, ProcessGrid


def _factor_panel(col: torch.Tensor, k: int, nb: int) -> torch.Tensor:
    """Factor global block column k from its updated full-height column:
    diagonal Cholesky + panel solve, rows above the diagonal block zeroed
    (internal::potrf + internal::trsm, potrf.cc:96-119)."""
    start = k * nb
    Lkk = _chol_blocked(col[start:start + nb])
    out = torch.zeros_like(col)
    out[start:start + nb] = Lkk
    if start + nb < col.shape[0]:
        out[start + nb:] = torch.linalg.solve_triangular(
            Lkk.mH, col[start + nb:], upper=True, left=False)
    return out


@instrument
def potrf_pipelined(Af, grid: ProcessGrid, nb: int = 256) -> torch.Tensor:
    """Distributed lower Cholesky with explicit lookahead pipelining over the
    flattened grid (1-D block-cyclic columns).  Returns the dense lower factor
    whole on every rank (the gathered layout)."""
    a = gather(Af)
    n0 = a.shape[-1]
    d = grid.size
    # the loop only needs nt % d == 0; clamping nb to ceil(n0/d) bounds the
    # identity-tail padding at one block column per rank
    nb = max(1, min(nb, -(-n0 // d)))
    unit = nb * d
    n = -(-n0 // unit) * unit
    nt = n // nb
    nt_loc = nt // d
    me = axis_index(grid, FLAT)
    js = np.arange(nt_loc) * d + me                     # my global block columns
    cols = (js[:, None] * nb + np.arange(nb)[None, :]).reshape(-1)
    keep = cols[cols < n0]
    L = a.new_zeros((n, nt_loc * nb))
    L[:n0, :keep.size] = a[:, torch.from_numpy(keep).to(a.device)]
    tail = np.nonzero(cols >= n0)[0]
    if tail.size:
        L[torch.from_numpy(cols[tail]).to(a.device),
          torch.from_numpy(tail).to(a.device)] = 1
    # prologue: factor + broadcast panel 0 (owned by rank 0)
    col0 = L[:, :nb] if me == 0 else torch.zeros_like(L[:, :nb])
    P = _factor_panel(axis_allreduce(col0, grid, FLAT), 0, nb)
    if me == 0:
        L[:, :nb] = P
    for k in range(nt):
        owner1, slot1 = (k + 1) % d, (k + 1) // d
        if k + 1 < nt:
            # 1. prioritized update of global column k+1 on its owner
            if me == owner1:
                blk = P[(k + 1) * nb:(k + 2) * nb]
                contrib = L[:, slot1 * nb:(slot1 + 1) * nb] - torch.matmul(P, blk.mH)
            else:
                contrib = torch.zeros_like(P)
            # 2. broadcast + factor panel k+1
            P_next = _factor_panel(axis_allreduce(contrib, grid, FLAT), k + 1, nb)
            if me == owner1:
                L[:, slot1 * nb:(slot1 + 1) * nb] = P_next
        else:
            P_next = None
        # 3. bulk trailing update: local columns of global block index >= k+2
        s_min = int(np.searchsorted(js, k + 2))
        if s_min < nt_loc:
            r0 = k * nb                                  # P is zero above
            G = P.reshape(nt, nb, nb)[torch.from_numpy(js[s_min:]).to(a.device)]
            upd = torch.einsum("nk,smk->nsm", P[r0:], G.conj())
            L[r0:, s_min * nb:] -= upd.reshape(n - r0, -1)
        P = P_next
    # back to natural column order: gather the cyclic columns, undo the order
    full = axis_allgather(L, grid, FLAT, dim=1)
    inv = torch.from_numpy(np.argsort(cyclic_permutation(n, nb, d))).to(a.device)
    return torch.tril(full[:, inv])[:n0, :n0]
