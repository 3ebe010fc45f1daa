"""Distributed eigenvalue / SVD / norm drivers over the process grid.

Reference analogues: ``src/heev.cc:68-225`` (scale -> he2hb on the grid ->
he2hbGather to rank 0 -> hb2st on rank 0 -> sterf/steqr/stedc ->
redistribute -> back-transforms), ``src/svd.cc:99-141`` (the same shape via
ge2tb/tb2bd/bdsqr), ``src/hegv.cc``, and the ``internal::norm`` reductions
the ``norm`` driver runs over distributed tiles (``src/norm.cc``).

Design, after the JAX package's, with one process per rank:

* **Stage 1 is where the flops are** (O(n²·nb) gemms per panel).  The
  operand moves from the block layout to 1-D block rows over the flattened
  grid in one all-to-all (``distribute.local_block`` to the row layout, the
  reference's redistribute to 1-D), padded to a multiple of nb·P with an
  identity tail.  Per panel: one all-gather of the panel, the O(n·nb²) panel
  QR on every rank, and one all-reduce of W = Vᴴ A; the two-sided block
  updates are local gemms.  ge2tb adds one masked sum for the LQ row panel,
  whose right update is local (columns are resident in this layout).
* **The band goes to every rank** in compact form (2·nb + 1 diagonals, one
  all-gather of O(n·nb)), the analogue of he2hbGather.  The chase runs on
  every rank, or segment-parallel (:mod:`.chase_dist`, ``chase_distributed``,
  when ``ceil(n/P) >= 2·nb + 2``).  Every rank must then run the tridiagonal
  solvers' host loops on the same bits (stedc's merges make collectives), so
  the replicated chase's (d, e) and reflector tape are broadcast from rank 0
  before any of them runs; the segment-parallel chase gathers its result, the
  same on every rank.
* **Back-transforms are local**: each rank builds its own rows of the chase
  factor Q2 from the tape (``householder.sweep_accumulate(..., Q0=rows)``, no
  collectives), multiplies them by the tridiagonal eigenvectors (the same on
  every rank), and applies the stage-1 reflectors, whose rows it holds, with
  one all-reduce per block (unmtr_he2hb).  QR iteration runs its rotations on
  each rank's rows of Q2 directly (steqr.cc's 1-D layout).
* Norms: each rank reduces its own shard with the port's norm reductions —
  on the card, the ``col_reduce``/``row_sums`` CUDA kernels
  (:mod:`slate_tpu_torch.ops.cuda_norms`) — and the partials meet in one or
  two all-reduces.  A triangle mask that crosses a shard is cut into pieces
  whose masks start at the piece's corner, so the kernels' masks apply
  unchanged.

Eigenvectors come back as DTensors in the row layout, U likewise, and Vᴴ in
the column layout; eigenvalues and singular values are plain tensors, the
same on every rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.exceptions import slate_assert
from ..core.types import Norm
from ..obs import instrument
from ..ops import cuda_norms as cn
from .collectives import axis_allgather, axis_allreduce, axis_bcast, axis_index
from .distribute import (BLOCK, COLS, ROWS, bounds, ceil_mult, gather, is_dist,
                         local_block, transpose_local, trim, wrap)
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


# ---------------------------------------------------------------------------
# the two-stage pipelines (he2hb / ge2tb over 1-D block rows)
# ---------------------------------------------------------------------------


def _my_rows(grid: ProcessGrid, total: int):
    """[r0, r0 + rows) of this rank in a row count divisible by P."""
    rows = total // grid.size
    return axis_index(grid, AX) * rows, rows


def _scale_factor(A, grid: ProcessGrid):
    """heev.cc:105-122's pre-scale for a distributed operand: sigma from the
    max norm over the grid (one all-reduce), the same on every rank."""
    anorm = norm_distributed("max", A, grid)
    fi = torch.finfo(anorm.dtype)
    rmin = fi.tiny ** 0.5 / fi.eps ** 0.5
    rmax = (1.0 / fi.tiny) ** 0.5 * fi.eps ** 0.5
    one = torch.ones((), dtype=anorm.dtype, device=anorm.device)
    sigma = torch.where(anorm > rmax, rmax / anorm,
                        torch.where((anorm < rmin) & (anorm > 0), rmin / anorm, one))
    return sigma, 1.0 / sigma


def _rows_operand(A, grid: ProcessGrid, shape, n_real: int, sigma=None,
                  eye: bool = False) -> torch.Tensor:
    """This rank's rows of ``A`` zero-padded to ``shape`` in the row layout
    (one all-to-all from a block-layout DTensor, a slice of a plain tensor),
    scaled by ``sigma``, with ones on the padded diagonal when ``eye``."""
    a = local_block(A, grid, shape, layout=ROWS)
    if sigma is not None:
        a.mul_(sigma.to(a.dtype))
    if eye:
        r0, rows = _my_rows(grid, shape[0])
        lo, hi = max(r0, n_real), min(r0 + rows, shape[1])
        if hi > lo:
            idx = torch.arange(lo, hi, device=a.device)
            a[idx - r0, idx] = 1
    return a


def _he2hb_local(a_loc: torch.Tensor, grid: ProcessGrid, npad: int, nb: int):
    """he2hb on this rank's block rows (mr, npad) of the padded matrix.
    Returns (band rows, my rows of the reflector stack (nj, mr, nb), Ts)."""
    from ..linalg import householder as hh

    r0, mr = _my_rows(grid, npad)
    nj = max(npad // nb - 1, 0)
    dt, dev = a_loc.dtype, a_loc.device
    Vs = torch.zeros((nj, mr, nb), dtype=dt, device=dev)
    Ts = torch.zeros((nj, nb, nb), dtype=dt, device=dev)
    for j in range(nj):
        k0 = j * nb
        P_full = axis_allgather(a_loc[:, k0:k0 + nb], grid, AX)       # (npad, nb)
        _, V, taus = hh.panel_qr_masked(P_full, k0 + nb, nb)
        T = hh.build_T(V, taus)
        V_loc = V[r0:r0 + mr]
        # left apply Q^H A: W = V^H A is the one all-reduce of the panel
        W = axis_allreduce(torch.matmul(V_loc.mH, a_loc), grid, AX)   # (nb, npad)
        a_loc = a_loc - torch.matmul(V_loc, torch.matmul(T.mH, W))
        # right apply (Q^H A) Q: V is whole here, so the gemms are local
        Y = torch.matmul(a_loc, V)
        a_loc = a_loc - torch.matmul(torch.matmul(Y, T), V.mH)
        Vs[j], Ts[j] = V_loc, T
    grow = torch.arange(r0, r0 + mr, device=dev)[:, None]
    gcol = torch.arange(npad, device=dev)[None, :]
    band = torch.where((grow - gcol).abs() <= nb, a_loc, torch.zeros((), dtype=dt, device=dev))
    return band, Vs, Ts


def _unmtr_local(Vs_loc, Ts, C_loc, grid: ProcessGrid, conj_q: bool = False):
    """Q C (Q^H C with ``conj_q``) for Q = H_0 ... H_{nj-1} from this rank's
    rows of the reflector stack and of C: one all-reduce of W = Vᴴ C per block
    (src/unmtr_he2hb.cc), the rest local."""
    nj = Vs_loc.shape[0]
    order = range(nj) if conj_q else range(nj - 1, -1, -1)
    for j in order:
        T = Ts[j].mH if conj_q else Ts[j]
        W = axis_allreduce(torch.matmul(Vs_loc[j].mH, C_loc), grid, AX)
        C_loc = C_loc - torch.matmul(Vs_loc[j], torch.matmul(T, W))
    return C_loc


def _stack(local: torch.Tensor, grid: ProcessGrid, total: int):
    """A reflector stack (nj, total, nb) whose rows are spread over the
    flattened grid, as a DTensor; ``distribute.gather`` assembles it."""
    from torch.distributed.tensor import DTensor, Shard

    shape = (local.shape[0], total, local.shape[2])
    return DTensor.from_local(local, grid.mesh, (Shard(1), Shard(1)), run_check=False,
                              shape=torch.Size(shape),
                              stride=(total * shape[2], shape[2], 1))


def _stack_rows(Vs, grid: ProcessGrid) -> torch.Tensor:
    """This rank's rows of a reflector stack: a flat-sharded DTensor's local
    rows, or the slice of a stack that is whole on every rank (rows padded to
    a multiple of P; zero rows act as identity)."""
    if is_dist(Vs):
        return Vs.to_local()
    nv = Vs.shape[1]
    nvp = -(-nv // grid.size) * grid.size
    if nvp > nv:
        Vs = torch.cat([Vs, Vs.new_zeros((Vs.shape[0], nvp - nv, Vs.shape[2]))], dim=1)
    r0, rows = _my_rows(grid, nvp)
    return Vs[:, r0:r0 + rows]


@instrument
def he2hb_distributed(A, grid: ProcessGrid, nb: int = 64):
    """Distributed stage-1 band reduction A = Q band Qᴴ over the flattened
    grid (src/he2hb.cc).  ``A``: the full Hermitian matrix (a block-layout
    DTensor or a tensor the same on every rank).  Returns ``(band, Vs, Ts)``:
    band (n, n) of bandwidth nb in the row layout, Vs (nj, npad, nb) with its
    rows spread over the grid, Ts (nj, nb, nb) the same on every rank."""
    n = A.shape[-1]
    npad = ceil_mult(n, nb * grid.size)
    a = _rows_operand(A, grid, (npad, npad), n, eye=True)
    band, Vs, Ts = _he2hb_local(a, grid, npad, nb)
    return (trim(band, grid, (npad, npad), (n, n), ROWS), _stack(Vs, grid, npad), Ts)


@instrument
def unmtr_he2hb_distributed(Vs, Ts, C, grid: ProcessGrid, conj_q: bool = False):
    """Apply the stage-1 Q (left, NoTrans) from the sharded reflector stack to
    C: Q C = H_0 ... H_{nj-1} C, blocks descending (``conj_q``: Qᴴ C,
    ascending).  C comes back in the row layout."""
    Vl = _stack_rows(Vs, grid)
    npad = Vl.shape[1] * grid.size
    n, ncols = C.shape[-2:]
    c = local_block(C, grid, (npad, ncols), layout=ROWS).to(Vl.dtype)
    out = _unmtr_local(Vl, torch.as_tensor(Ts).to(Vl.dtype), c, grid, conj_q)
    return trim(out, grid, (npad, ncols), (n, ncols), ROWS)


def _gather_band(band_loc, grid: ProcessGrid, r0: int, n: int, lo: int, hi: int):
    """The he2hbGather analogue: the band's diagonals lo..hi (entry (i, i+k))
    from every rank's rows, in compact form in one all-gather of O(n·nb), then
    the dense (n, n) band on every rank."""
    mr, ncol = band_loc.shape
    dev = band_loc.device
    rows = torch.arange(mr, device=dev)[:, None]
    ks = torch.arange(lo, hi + 1, device=dev)[None, :]
    cols = r0 + rows + ks
    ok = (cols >= 0) & (cols < ncol)
    comp = torch.where(ok, band_loc[rows, cols.clamp(0, ncol - 1)],
                       torch.zeros((), dtype=band_loc.dtype, device=dev))
    comp = axis_allgather(comp, grid, AX)[:n]                         # (n, hi-lo+1)
    gi = torch.arange(n, device=dev)[:, None].expand(n, hi - lo + 1)
    gj = gi + ks
    inside = (gj >= 0) & (gj < n)
    dense = band_loc.new_zeros((n, n))
    dense[gi[inside], gj[inside]] = comp[inside]
    return dense


def _bcast(grid: ProcessGrid, *xs):
    """Rank 0's copy of each tensor on every rank (masked-sum broadcast)."""
    return tuple(axis_bcast(x, grid, AX, 0) for x in xs)


def _twostage_stage12(A, grid: ProcessGrid, nb: int, chase_pipeline,
                      chase_distributed: bool, want_tape: bool):
    """Shared two-stage prologue of the distributed eig drivers: nb clamps,
    safe scaling, stage 1 on block rows, the band on every rank, and the
    chase (the segment-parallel eligibility floor in one place, so the full
    and subset drivers cannot diverge).

    Returns ``(d, e_c, Vcs, tcs, (Vs1, Ts1, npad), factor, nb)``: Vs1 this
    rank's rows of the stage-1 stack; without ``want_tape`` ``Vcs``/``tcs``
    are None and ``e_c`` is already the real |e|.  (d, e) and the tape are
    the same on every rank, bit for bit."""
    from ..linalg.eig import _pipelined, hb2st, hb2st_reflectors

    n = A.shape[-1]
    nb = max(2, min(nb, max(2, n // 2)))
    # clamp against the nb·P padding granularity: the pad stays <= ~n/4, so
    # the stage-1 gemms never run on a matrix twice the real size
    P = grid.size
    if n >= 8 * P:
        nb = max(2, min(nb, -(-n // (4 * P))))
    sigma, factor = _scale_factor(A, grid)
    npad = ceil_mult(n, nb * P)
    a = _rows_operand(A, grid, (npad, npad), n, sigma, eye=True)
    band_loc, Vs1, Ts1 = _he2hb_local(a, grid, npad, nb)
    band = _gather_band(band_loc, grid, _my_rows(grid, npad)[0], n, -nb, nb)
    if chase_distributed and n > 2 and -(-n // P) >= 2 * nb + 2:
        from .chase_dist import hb2st_chase_distributed

        d, e_c, Vcs, tcs = hb2st_chase_distributed(band, nb, grid,
                                                   want_vectors=want_tape)
    elif want_tape:
        d, e_c, Vcs, tcs = _bcast(grid, *hb2st_reflectors(
            band, kd=nb, pipeline=_pipelined(chase_pipeline, band)))
    else:
        d, e_c = _bcast(grid, *hb2st(band, kd=nb, want_vectors=False,
                                     pipeline=_pipelined(chase_pipeline, band)))
        Vcs = tcs = None
    if not want_tape:
        return d, e_c.abs(), None, None, (Vs1, Ts1, npad), factor, nb
    return d, e_c, Vcs, tcs, (Vs1, Ts1, npad), factor, nb


def _sweep_rows(Vs, taus, phase, n: int, row0: int, rows: int) -> torch.Tensor:
    """Rows [row0, row0 + rows) of the chase factor Q2 = (prod H) diag(phase),
    built from the identity rows (zero past n) with no collectives."""
    from ..linalg import householder as hh

    dev = Vs.device
    r = torch.arange(row0, row0 + rows, device=dev)[:, None]
    q0 = (r == torch.arange(n, device=dev)[None, :]).to(Vs.dtype)
    return hh.sweep_accumulate(Vs, taus, n, Vs.shape[-1], Q0=q0) * phase[None, :]


def _flat_rows(n: int, grid: ProcessGrid):
    """This rank's [r0, r1) of n rows in the row layout (torch.chunk sizes)."""
    return bounds(grid, n, 1, ROWS)[0]


@instrument
def hb2st_q_distributed(Vs, taus, e_c, n: int, grid: ProcessGrid):
    """Q2 of the hb2st chase (phases included), rows spread over the
    flattened grid: each rank accumulates its own rows from the tape, which
    is whole on every rank (no collectives).  A row-layout DTensor."""
    from ..linalg.eig import _phase_vector

    r0, r1 = _flat_rows(n, grid)
    q = _sweep_rows(Vs, taus, _phase_vector(e_c.to(Vs.dtype)), n, r0, r1 - r0)
    return wrap(q, grid, (n, n), ROWS)


@instrument
def steqr_distributed(d, e, grid: ProcessGrid, Z=None):
    """Distributed steqr (src/steqr.cc:52-82): every rank runs the same QR
    iteration on (d, e), which must be the same on every rank, and applies
    the rotations to its own rows of Z (the identity by default): no
    collectives.  Returns (eigenvalues, Z·Q in the row layout)."""
    from ..linalg.steqr_qr import steqr_qr

    d = torch.as_tensor(d)
    n = d.shape[0]
    if Z is None:
        r0, r1 = _flat_rows(n, grid)
        z = (torch.arange(r0, r1, device=d.device)[:, None]
             == torch.arange(n, device=d.device)[None, :]).to(d.dtype)
        m = n
    else:
        m = Z.shape[-2]
        z = local_block(Z, grid, (m, Z.shape[-1]), layout=ROWS)
    lam, z = steqr_qr(d, e, z)
    return lam, wrap(z, grid, (m, n), ROWS)


def _tridiag_vectors(method_eig: str, d, e, q2_loc, grid: ProcessGrid):
    """(lam, my rows of Q2·Zt) for the tridiagonal T(d, e): bisection + stein
    or stedc (Zt the same on every rank, one local gemm), or QR iteration
    (its rotations applied to my rows of Q2 directly)."""
    if method_eig == "qr":
        from ..linalg.steqr_qr import steqr_qr

        return steqr_qr(d, e, q2_loc)
    if method_eig == "bisection":
        from ..linalg.sturm import stein, sterf_bisect

        lam = sterf_bisect(d, e)
        Zt = stein(d, e, lam)
    else:
        from ..linalg.stedc import stedc

        lam, Zt = stedc(d, e, grid=grid)
    return lam, torch.matmul(q2_loc, Zt.to(q2_loc.dtype))


def _tiny_eig(A, want_vectors: bool):
    from ..linalg.stedc import _library_eigh

    return _library_eigh(gather(A), want_vectors)


@instrument
def heev_distributed(A, grid: ProcessGrid, nb: int = 64, want_vectors: bool = True,
                     method_eig: str = "dc", chase_pipeline: Optional[bool] = None,
                     chase_distributed: bool = False):
    """Distributed Hermitian eigensolve over the grid (src/heev.cc).

    ``A``: the full Hermitian matrix, a block-layout DTensor or a tensor the
    same on every rank.  Returns (ascending eigenvalues, the same on every
    rank; Z in the row layout, or None).  ``method_eig``: "dc" (stedc, its
    big merges over the grid), "qr" (steqr on each rank's rows), "bisection"
    (sterf_bisect + stein).  Values alone always take sterf.  The replicated
    chase follows ``chase_pipeline`` (None: pipelined on a CUDA tensor,
    sequential elsewhere); ``chase_distributed=True`` runs it
    segment-parallel (:mod:`.chase_dist`) when n/P >= 2·nb + 2."""
    from ..linalg.eig import _phase_vector, sterf

    n = A.shape[-1]
    if n < 8:
        return _tiny_eig(A, want_vectors)
    if not want_vectors:
        d, e, *_, factor, _ = _twostage_stage12(A, grid, nb, chase_pipeline,
                                                chase_distributed, want_tape=False)
        return sterf(d, e) * factor, None
    d, e_c, Vcs, tcs, (Vs1, Ts1, npad), factor, nb = _twostage_stage12(
        A, grid, nb, chase_pipeline, chase_distributed, want_tape=True)
    r0, mr = _my_rows(grid, npad)
    q2 = _sweep_rows(Vcs, tcs, _phase_vector(e_c.to(Vcs.dtype)), n, r0, mr)
    lam, z = _tridiag_vectors(method_eig, d, e_c.abs(), q2, grid)
    z = _unmtr_local(Vs1, Ts1, z.to(Vs1.dtype), grid)
    return lam * factor, trim(z, grid, (npad, n), (n, n), ROWS)


@instrument
def heev_range_distributed(A, grid: ProcessGrid, il: int, iu: int, nb: int = 64,
                           want_vectors: bool = True,
                           chase_pipeline: Optional[bool] = None,
                           chase_distributed: bool = False):
    """Distributed subset eigensolve: the k = iu - il eigenpairs with
    ascending indices [il, iu).  Stage 1 on block rows, the chase as
    :func:`heev_distributed`'s, index-targeted bisection + stein, the chase
    back-transform on the thin (n, k) block (the reverse sweep accumulation,
    the same on every rank), and the stage-1 back-transform on each rank's
    rows.  Returns (lam (k,), Z (n, k) in the row layout, or None)."""
    from ..linalg import householder as hh
    from ..linalg.eig import _phase_vector
    from ..linalg.sturm import stein, sterf_bisect

    n = A.shape[-1]
    slate_assert(0 <= il < iu <= n, f"index range [{il}, {iu}) invalid for n={n}")
    if n < 8:
        lam, z = _tiny_eig(A, True)
        return lam[il:iu], (z[:, il:iu] if want_vectors else None)
    if not want_vectors:
        d, e, *_, factor, _ = _twostage_stage12(A, grid, nb, chase_pipeline,
                                                chase_distributed, want_tape=False)
        return sterf_bisect(d, e, il=il, iu=iu) * factor, None
    d, e_c, Vcs, tcs, (Vs1, Ts1, npad), factor, nb = _twostage_stage12(
        A, grid, nb, chase_pipeline, chase_distributed, want_tape=True)
    e = e_c.abs()
    lam = sterf_bisect(d, e, il=il, iu=iu)
    dt = Vcs.dtype
    X = _phase_vector(e_c.to(dt))[:, None] * stein(d, e, lam).to(dt)
    z = hh.sweep_accumulate(Vcs, tcs, n, nb, Q0=X.mH, reverse=True).mH
    z = _rows_operand(z, grid, (npad, iu - il), n)
    z = _unmtr_local(Vs1, Ts1, z, grid)
    return lam * factor, trim(z, grid, (npad, iu - il), (n, iu - il), ROWS)


def _ge2tb_local(a_loc: torch.Tensor, grid: ProcessGrid, mpad: int, npc: int,
                 nreal: int, nb: int):
    """ge2tb on this rank's block rows (mr, npc): alternating QR column
    panels (one all-gather + one all-reduce, like he2hb) and LQ row panels
    (one masked sum extracts the nb rows; the right update is local).
    Returns (band rows, (Vu rows, Tu), (Vv rows, Tv))."""
    from ..linalg import householder as hh
    from .pivot import extract_rows

    r0, mr = _my_rows(grid, mpad)
    v0, ncv = _my_rows(grid, npc)
    nt = max(-(-nreal // nb), 1)
    me = axis_index(grid, AX)
    dt, dev = a_loc.dtype, a_loc.device
    Vu = torch.zeros((nt, mr, nb), dtype=dt, device=dev)
    Tu = torch.zeros((nt, nb, nb), dtype=dt, device=dev)
    Vv = torch.zeros((nt, ncv, nb), dtype=dt, device=dev)
    Tv = torch.zeros((nt, nb, nb), dtype=dt, device=dev)
    for j in range(nt):
        k0 = j * nb
        # QR column panel (pivots on the diagonal)
        P_full = axis_allgather(a_loc[:, k0:k0 + nb], grid, AX)
        _, V, taus = hh.panel_qr_masked(P_full, k0, nb)
        T = hh.build_T(V, taus)
        V_loc = V[r0:r0 + mr]
        W = axis_allreduce(torch.matmul(V_loc.mH, a_loc), grid, AX)
        a_loc = a_loc - torch.matmul(V_loc, torch.matmul(T.mH, W))
        Vu[j], Tu[j] = V_loc, T
        # LQ row panel (pivots one block right): the nb rows by a masked sum
        Prow = extract_rows(a_loc, np.arange(k0, k0 + nb), me, mr, grid, AX)
        _, Vr, tausr = hh.panel_lq_masked(Prow, k0 + nb, nb)
        Tr = hh.build_T(Vr, tausr)
        Y = torch.matmul(a_loc, Vr)
        a_loc = a_loc - torch.matmul(torch.matmul(Y, Tr), Vr.mH)
        Vv[j], Tv[j] = Vr[v0:v0 + ncv], Tr
    grow = torch.arange(r0, r0 + mr, device=dev)[:, None]
    gcol = torch.arange(npc, device=dev)[None, :]
    band = torch.where((gcol >= grow) & (gcol - grow <= nb), a_loc,
                       torch.zeros((), dtype=dt, device=dev))
    return band, (Vu, Tu), (Vv, Tv)


def _ge2tb_shape(m: int, n: int, nb: int, P: int):
    """Padded rows and columns of ge2tb: the last panel never clamps, and the
    right reflectors' rows spread evenly."""
    return ceil_mult(m + nb, nb * P), ceil_mult(n + nb, P)


@instrument
def ge2tb_distributed(A, grid: ProcessGrid, nb: int = 64):
    """Distributed stage-1 general -> band reduction A = U band Vᴴ over the
    flattened grid (src/ge2tb.cc).  Returns ``(band, (Vu, Tu), (Vv, Tv))``:
    band (m, n) of upper bandwidth nb in the row layout, Vu and Vv with their
    rows spread over the grid, Tu and Tv the same on every rank."""
    m, n = A.shape[-2:]
    slate_assert(m >= n, "ge2tb_distributed requires m >= n")
    mpad, npc = _ge2tb_shape(m, n, nb, grid.size)
    a = _rows_operand(A, grid, (mpad, npc), n)
    band, (Vu, Tu), (Vv, Tv) = _ge2tb_local(a, grid, mpad, npc, n, nb)
    return (trim(band[:, :n], grid, (mpad, n), (m, n), ROWS),
            (_stack(Vu, grid, mpad), Tu), (_stack(Vv, grid, npc), Tv))


def _svd_stage12(A, grid: ProcessGrid, nb: int, chase_pipeline,
                 chase_distributed: bool, want_tape: bool):
    """ge2tb on block rows, the band on every rank, the tb2bd chase (the same
    floor as :func:`_twostage_stage12`); returns (chase output, the stage-1
    factors' local rows, the padded shape, factor, nb).  The replicated
    chase's output is broadcast from rank 0."""
    from ..linalg.eig import _pipelined
    from ..linalg.svd import _tb2bd_run_chase

    m, k = A.shape[-2:]
    nb = max(2, min(nb, max(2, k - 1)))
    P = grid.size
    if k >= 8 * P:
        nb = max(2, min(nb, -(-k // (4 * P))))
    sigma, factor = _scale_factor(A, grid)
    mpad, npc = _ge2tb_shape(m, k, nb, P)
    a = _rows_operand(A, grid, (mpad, npc), k, sigma)
    band_loc, Uf, Vf = _ge2tb_local(a, grid, mpad, npc, k, nb)
    sq = _gather_band(band_loc, grid, _my_rows(grid, mpad)[0], k, 0, nb)
    if chase_distributed and k > 2 and -(-k // P) >= 2 * nb + 2:
        from .chase_dist import tb2bd_chase_distributed

        out = tb2bd_chase_distributed(sq, nb, grid, want_vectors=want_tape)
    else:
        out = _tb2bd_run_chase(sq, nb, _pipelined(chase_pipeline, sq))
        out = _bcast(grid, *(out if want_tape else out[:2]))
    return out, Uf, Vf, (mpad, npc), factor, nb


def _wide(A, grid: ProcessGrid):
    """Aᴴ of a wide operand (one block exchange for a block-layout DTensor)."""
    if is_dist(A):
        m, n = A.shape[-2:]
        return wrap(transpose_local(local_block(A, grid), grid, m, n, conj=True),
                    grid, (n, m))
    return A.mH.resolve_conj()


def _vt_cols(Vfull, grid: ProcessGrid):
    """Vᴴ (k, n) in the column layout from V (n, k) in the row layout: the
    local conjugate transpose, no data moves."""
    n, k = Vfull.shape
    return wrap(Vfull.to_local().mH.resolve_conj(), grid, (k, n), COLS)


def _swap_vectors(S, V, UT, grid):
    """(S, U, Vᴴ) of A from the SVD of Aᴴ = V S Uᴴ (U row layout, Vᴴ column
    layout, as every distributed SVD returns them)."""
    if V is None:
        return S, None, None
    U = wrap(UT.to_local().mH.resolve_conj(), grid, (UT.shape[1], UT.shape[0]), ROWS)
    return S, U, _vt_cols(V, grid)


@instrument
def svd_distributed(A, grid: ProcessGrid, nb: int = 64, want_vectors: bool = True,
                    chase_pipeline: Optional[bool] = None, method_svd: str = "auto",
                    chase_distributed: bool = False):
    """Distributed SVD over the grid (src/svd.cc pipeline).

    Returns (S descending, the same on every rank; U (m, k) in the row
    layout, Vᴴ (k, n) in the column layout, or None).  Wide inputs run on Aᴴ
    (U and V swap), like the reference's LQ pre-step; very tall ones (m >=
    2n) take a QR first.  ``method_svd``: "bisection" solves the bidiagonal
    by Golub–Kahan bisection (+ stein), "dc" by the dense library SVD, else
    "auto".  ``chase_distributed`` as in :func:`heev_distributed`."""
    from ..linalg.svd import _bidiag_phases, _library_svd, bdsqr

    m, n = A.shape[-2:]
    kw = dict(nb=nb, chase_pipeline=chase_pipeline, method_svd=method_svd,
              chase_distributed=chase_distributed)
    if min(m, n) < 8:
        a = gather(A)
        if want_vectors:
            U, S, VT = _library_svd(a, True)
            return S, U, VT
        return _library_svd(a, False), None, None
    if m < n:
        S, V, UT = svd_distributed(_wide(A, grid), grid, want_vectors=want_vectors, **kw)
        return _swap_vectors(S, V, UT, grid)
    if m >= 2 * n:
        # the tall pre-step (svd.cc:224+): the bidiagonalization runs on R
        if not want_vectors:
            from .qr_dist import tsqr_distributed

            _, R = tsqr_distributed(A, grid)
            return svd_distributed(R[:n, :n], grid, want_vectors=False, **kw)
        from .qr_dist import geqrf_distributed
        from .summa import gemm_padded

        Q, R = geqrf_distributed(A, grid, nb=max(nb, 32))
        S, UR, VT = svd_distributed(gather(R)[:n, :n], grid, want_vectors=True, **kw)
        U = gemm_padded(Q, UR, grid)
        return S, wrap(local_block(U, grid, (m, n), ROWS), grid, (m, n), ROWS), VT
    k = n
    out, (Vu, Tu), (Vv, Tv), (mpad, npc), factor, nb = _svd_stage12(
        A, grid, nb, chase_pipeline, chase_distributed, want_vectors)
    bd = {"bisection": "bisect", "dc": "dense"}.get(str(method_svd).lower(), "auto")
    if not want_vectors:
        d, e = out[0].abs(), out[1].abs()
        return bdsqr(d, e, want_vectors=False, method=bd)[0] * factor, None, None
    d_c, e_c, Us, tauus, Vcs, tauvs = out
    pu, pw = _bidiag_phases(d_c, e_c, Us.dtype)
    S, Ub, VTb = bdsqr(d_c.abs(), e_c.abs(), want_vectors=True, method=bd)
    r0, mr = _my_rows(grid, mpad)
    v0, ncv = _my_rows(grid, npc)
    # U = Q_u [U2 Ub; 0] and V = Q_v [V2 VTbᴴ; 0], each on my rows
    Uin = torch.matmul(_sweep_rows(Us, tauus, pu, k, r0, mr), Ub.to(Us.dtype))
    Vin = torch.matmul(_sweep_rows(Vcs, tauvs, pw, k, v0, ncv), VTb.to(Us.dtype).mH)
    U = trim(_unmtr_local(Vu, Tu, Uin, grid), grid, (mpad, k), (m, k), ROWS)
    V = trim(_unmtr_local(Vv, Tv, Vin, grid), grid, (npc, k), (n, k), ROWS)
    return S * factor, U, _vt_cols(V, grid)


@instrument
def svd_range_distributed(A, grid: ProcessGrid, il: int, iu: int, nb: int = 64,
                          want_vectors: bool = True,
                          chase_pipeline: Optional[bool] = None,
                          chase_distributed: bool = False):
    """Distributed subset SVD: the singular triplets with DESCENDING indices
    [il, iu).  ge2tb on block rows, the tb2bd chase, index-targeted
    Golub–Kahan bisection, stein vectors, the thin reverse-accumulated chase
    back-transforms (the same on every rank) and the stage-1 back-transforms
    on each rank's rows.  Returns (S (j,), U (m, j) row layout or None,
    Vᴴ (j, n) column layout or None)."""
    from ..linalg import householder as hh
    from ..linalg.sturm import stein, sterf_bisect
    from ..linalg.svd import _bidiag_phases, _gk_form, _gk_split, _library_svd

    m, n = A.shape[-2:]
    if m < n:
        S, V, UT = svd_range_distributed(_wide(A, grid), grid, il, iu, nb=nb,
                                         want_vectors=want_vectors,
                                         chase_pipeline=chase_pipeline,
                                         chase_distributed=chase_distributed)
        return _swap_vectors(S, V, UT, grid)
    k = n
    slate_assert(0 <= il < iu <= k, f"index range [{il}, {iu}) invalid for min(m,n)={k}")
    j = iu - il
    if k < 8:
        a = gather(A)
        if want_vectors:
            U, S, VT = _library_svd(a, True)
            return S[il:iu], U[:, il:iu], VT[il:iu, :]
        return _library_svd(a, False)[il:iu], None, None
    out, (Vu, Tu), (Vv, Tv), (mpad, npc), factor, nb = _svd_stage12(
        A, grid, nb, chase_pipeline, chase_distributed, want_vectors)
    d_c, e_c = out[0], out[1]
    zero_d, tgk_off = _gk_form(d_c.abs(), e_c.abs())
    lam_desc = sterf_bisect(zero_d, tgk_off, il=2 * k - iu, iu=2 * k - il).flip(0)
    sig = torch.clamp(lam_desc, min=0.0)
    if not want_vectors:
        return sig * factor, None, None
    _, _, Us, tauus, Vcs, tauvs = out
    dt = Us.dtype
    U2t, V2t = _gk_split(stein(zero_d, tgk_off, lam_desc), dt)
    pu, pw = _bidiag_phases(d_c, e_c, dt)
    Uu = hh.sweep_accumulate(Us, tauus, k, nb, Q0=(pu[:, None] * U2t).mH, reverse=True).mH
    Vw = hh.sweep_accumulate(Vcs, tauvs, k, nb, Q0=(pw[:, None] * V2t).mH, reverse=True).mH
    U = _unmtr_local(Vu, Tu, _rows_operand(Uu, grid, (mpad, j), k), grid)
    V = _unmtr_local(Vv, Tv, _rows_operand(Vw, grid, (npc, j), k), grid)
    return (sig * factor, trim(U, grid, (mpad, j), (m, j), ROWS),
            _vt_cols(trim(V, grid, (npc, j), (n, j), ROWS), grid))


@instrument
def hegv_distributed(itype: int, A, B, grid: ProcessGrid, nb: int = 64,
                     want_vectors: bool = True):
    """Distributed generalized Hermitian eigensolve (src/hegv.cc over the
    grid): potrf(B) -> hegst (triangular solves or gemms over the grid) ->
    :func:`heev_distributed` -> the back-transform over the grid.  ``A`` and
    ``B`` are full Hermitian matrices.  Returns (ascending eigenvalues, X in
    the block layout or None); raises when B is not positive definite."""
    from ..core.exceptions import SlateError
    from .distribute import diagonal
    from .solvers import potrf_distributed, trsm_distributed
    from .summa import gemm_padded

    n = A.shape[-1]
    L = potrf_distributed(B, grid, nb=max(nb, 32))
    if not is_dist(L):              # the lookahead pipeline's replicated factor
        L = wrap(local_block(L, grid), grid, (n, n))
    dL = diagonal(L, grid)
    if not bool(torch.all(torch.isfinite(dL) & (dL.real > 0))):   # one host sync
        raise SlateError("hegv_distributed: B not positive definite")

    def herm_t(X):
        r, c = X.shape[-2:]
        return wrap(transpose_local(local_block(X, grid), grid, r, c, conj=True),
                    grid, (c, r))

    if itype == 1:          # C = L^{-1} A L^{-H}
        W = trsm_distributed(L, A, grid, lower=True, conj_trans=False)
        C = herm_t(trsm_distributed(L, herm_t(W), grid, lower=True, conj_trans=False))
    elif itype in (2, 3):   # C = L^H A L
        C = gemm_padded(herm_t(L), gemm_padded(A, L, grid), grid)
    else:
        raise SlateError(f"hegst itype must be 1, 2, or 3, got {itype}")
    lam, Z = heev_distributed(C, grid, nb=nb, want_vectors=want_vectors)
    X = None
    if want_vectors:
        X = (trsm_distributed(L, Z, grid, lower=True, conj_trans=True)
             if itype in (1, 2) else gemm_padded(L, Z, grid))
    return lam, X
