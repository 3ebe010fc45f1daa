"""LU family: getrf (partial-pivot / nopiv / tournament) + getrs / gesv / getri and the
mixed-precision + random-butterfly solver variants.

Reference analogue: ``src/getrf.cc``, ``src/getrf_nopiv.cc``, ``src/getrf_tntpiv.cc``
(CALU tournament pivoting), ``src/{getrs,gesv,getri,getriOOP}.cc``,
``src/gesv_mixed.cc`` (f32 factor + f64 iterative refinement),
``src/gesv_mixed_gmres.cc`` (GMRES-IR), ``src/gesv_rbt.cc`` + ``src/gerbt.cc``
(random butterfly transform).

As in the JAX package:

* **Pivots** are a global permutation vector ``perm`` (``A[perm] = L U``,
  ``perm[i]`` = source row); row exchanges are one gather.  ``perm_to_pivots`` /
  ``pivots_to_perm`` convert to and from LAPACK's 1-based ipiv.
* **Panels** are library partially-pivoted LUs (``torch.linalg.lu_factor_ex``,
  or cuSOLVER's getrf called directly in the partial-pivot blocked driver on
  the card, ``ops/cuda_pivots.getrf_panel``), composed by the blocked
  drivers like getrf.cc's task loop: panel -> row exchange -> row trsm ->
  trailing gemm, with the next panel factored ahead on a second CUDA stream.
* **CALU** selects each panel's pivot rows by a tournament of batched LUs over
  row blocks (or, with ``lu_panel="pp"``, one partial-pivot LU of the panel).
* **RBT**: depth-d butterfly transforms as reshapes and elementwise products,
  then nopiv LU.

What differs from the JAX package:

* The library LU returns LAPACK's ipiv, not a permutation.  The library
  route and CALU convert it on the host (one device→host copy of the pivots,
  sequential swaps, one copy back) — never through ``lu_unpack``'s dense P;
  CALU keeps ``perm`` on the host while it runs.  The partial-pivot blocked
  driver (:func:`_getrf_tiled`, which ``Target.Auto`` takes for a large
  single matrix on the card) turns each panel's ipiv into row moves on the
  device instead (``ops/cuda_pivots``, no sync) and keeps ``perm`` there.
  The host time of the conversion is published as the ``pivots`` phase
  (``utils.trace.last_phases``), 0 on the driver's route.  The batched core :func:`gesv_core`
  converts on the device too (``lu_unpack`` + ``argmax``, no sync), because
  the serving tier launches a batch and resolves it on another thread.
* The factorizations update one private copy of the operand in place, and a row
  exchange moves only the rows whose position changes.
* ``lax.while_loop``/``lax.cond`` become host control flow; each function's
  docstring counts its host syncs.
* ``perm`` is an int64 tensor (torch's index type; the JAX package's is int32).
* ``info`` is read from the U diagonal, as in the JAX package, but the card's
  library LU can lose a NaN input altogether; :func:`_mark_lost_nan` puts it
  back where the CPU libraries leave it.  The lookahead route learns
  whether A held a NaN from its private copy (``cuda_pivots.copy_scan_nan``)
  and guards the factor only then (``cuda_pivots.guard_lost_nan``), with the
  same result.
* RBT randomness comes from a ``torch.Generator`` (seeded with 42 by default):
  the butterflies differ from the JAX package's ``PRNGKey(42)`` draws, so only
  the solution and the reports are comparable.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.exceptions import SlateError, slate_assert
from ..core.matrix import (BaseMatrix, as_array, dist_operand, distribution_grid,
                           to_tensor, torch_dtype, write_back)
from ..core.types import MethodLU, Options, Target
from ..obs import counter, instrument
from ..ops import cuda_pivots
from ..robust import (RetryPolicy, Rung, SolveReport, active, first_bad_index,
                      first_bad_index_batched, inject, run_ladder)
from ..utils.trace import Timers, annotate, record_phases, trace_block, trace_event
from .chol import _dtype_name, _factor_precision, _ir_solve, _iters


# ---------------------------------------------------------------------------
# pivots utilities
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def perm_to_pivots(perm):
    """Convert a permutation vector to LAPACK-style sequential ipiv (1-based),
    the reference's Pivots representation (types.hh:84-117).  O(n) with a
    position map; returns a numpy int64 array."""
    p = _host(perm)
    n = p.shape[0]
    rows = np.arange(n)            # rows[i] = original row at position i
    pos = np.arange(n)             # pos[r]  = current position of original row r
    ipiv = np.zeros(n, dtype=np.int64)
    for k in range(n):
        j = pos[p[k]]
        ipiv[k] = j + 1
        rk, rj = rows[k], rows[j]
        rows[k], rows[j] = rj, rk
        pos[rj], pos[rk] = k, j
    return ipiv


def pivots_to_perm(ipiv):
    """Inverse of perm_to_pivots: replay the 1-based sequential row interchanges
    into the permutation vector getrs/getri consume (numpy int64)."""
    ip = _host(ipiv).tolist()
    rows = list(range(len(ip)))
    for k, one_based in enumerate(ip):
        j = int(one_based) - 1
        rows[k], rows[j] = rows[j], rows[k]
    return np.asarray(rows, dtype=np.int64)


def _ipiv_perm(ipiv: torch.Tensor, m: int, timers: Timers) -> np.ndarray:
    """Permutations of ``m`` rows from the library LU's 1-based ipiv, for a
    whole batch at once: ``ipiv`` (..., k) -> (..., m) int64 on the host.

    One device→host copy of the pivots (it waits for the factorization), then
    the sequential swaps of each batch element in Python; only the swaps count
    towards the ``pivots`` phase."""
    ip = ipiv.cpu().numpy()
    with timers.time("pivots"):
        flat = ip.reshape(-1, ip.shape[-1]).tolist()
        out = np.empty((len(flat), m), dtype=np.int64)
        for b, piv in enumerate(flat):
            rows = list(range(m))
            for k, one_based in enumerate(piv):
                j = one_based - 1
                rows[k], rows[j] = rows[j], rows[k]
            out[b] = rows
    return out.reshape(ip.shape[:-1] + (m,))


def _index(idx: np.ndarray, device, timers: Timers) -> torch.Tensor:
    """A host index vector as an int64 tensor on ``device`` (timed with the
    pivot conversion it serves)."""
    with timers.time("pivots"):
        return torch.from_numpy(np.ascontiguousarray(idx)).to(device)


def _as_perm(perm, device) -> torch.Tensor:
    """A caller's permutation (tensor, numpy, list) as int64 on ``device``."""
    if isinstance(perm, torch.Tensor):
        return perm.to(device=device, dtype=torch.int64)
    return torch.tensor(_host(perm), dtype=torch.int64, device=device)


def _compose_perm(outer, inner):
    """perm = outer ∘ inner: result[i] = inner[outer[i]]."""
    return inner[outer]


def _lu_info(U_diag) -> torch.Tensor:
    """First zero/NaN U pivot, LAPACK-style — the shared info kernel
    (robust.first_bad_index).  Read from the factor, never from the library's
    own info, which disagrees with the JAX package on a NaN."""
    return first_bad_index(torch.isnan(U_diag) | (U_diag == 0))


def _mark_lost_nan(a: torch.Tensor, plu: torch.Tensor) -> torch.Tensor:
    """Keep a NaN input visible in a library LU factor, in place, without a
    host sync.

    The JAX package's factor of a NaN input carries the NaN to the U diagonal,
    so its info names a pivot.  On the card the library's pivot search can
    pass over NaN rows and return a finite factor (info 0, no NaN left).
    Where the input holds a NaN and the factor none, every column from the
    first one holding a NaN in the input is NaN-filled, so ``info`` names that
    column — the pivot the CPU libraries report for a NaN on the diagonal.  A
    factor that kept its NaN is left as it is."""
    n = a.shape[-1]
    first = first_bad_index_batched(torch.isnan(a).any(dim=-2))   # 1-based, 0: none
    lost = (first > 0) & ~torch.isnan(plu).flatten(-2).any(dim=-1)
    cols = torch.arange(n, device=a.device)
    fill = lost[..., None] & (cols >= first[..., None] - 1)
    return plu.masked_fill_(fill[..., None, :], float("nan"))


def _lu_factor(a: torch.Tensor):
    """The library partially-pivoted LU (cuSOLVER/MAGMA on the card) of every
    factor the drivers keep: returns (packed LU, 1-based ipiv) with a NaN
    input kept visible (:func:`_mark_lost_nan`).  Pivot selection alone (the
    CALU panels) calls the library directly: its factor is discarded."""
    plu, piv, _ = torch.linalg.lu_factor_ex(a)
    return _mark_lost_nan(a, plu), piv


def _private_copy(a: torch.Tensor) -> torch.Tensor:
    """The one copy a factorization updates in place (row-major, never an
    alias of the caller's tensor)."""
    return a.clone(memory_format=torch.contiguous_format)


def _exchange_rows_(A: torch.Tensor, r0: int, window: np.ndarray,
                    timers: Timers) -> None:
    """Apply a window permutation to rows ``r0:`` of ``A`` in place (row
    ``r0 + i`` takes row ``r0 + window[i]``), moving only the rows whose
    position changes — at most twice the panel width for an LU panel's
    swaps (the permuteRows analogue; one gather, one scatter)."""
    moved = np.nonzero(window != np.arange(window.shape[0]))[0]
    if moved.size:
        dst = _index(r0 + moved, A.device, timers)
        src = _index(r0 + window[moved], A.device, timers)
        A[dst] = A[src]


# ---------------------------------------------------------------------------
# nopiv panel kernel (used by getrf_nopiv, CALU and the RBT solver)
# ---------------------------------------------------------------------------


def _lu_nopiv_unblocked(a):
    """Unblocked LU without pivoting on a square block via rank-1 updates
    (≅ tile-level getrf_nopiv), on a copy: two launches per column."""
    m = a.clone()
    n = m.shape[-1]
    for k in range(n - 1):
        m[k + 1:, k] /= m[k, k]
        m[k + 1:, k + 1:].addr_(m[k + 1:, k], m[k, k + 1:], alpha=-1)
    return m


_LU_NOPIV_BASE = 128


def _lu_nopiv_blocked(a):
    """Recursive blocked LU without pivoting: factor the leading half, two
    triangular solves, one Schur-complement gemm, recurse on the trailing
    half; the unblocked rank-1 loop runs only at the <= 128 base.  Returns a
    new tensor."""
    n = a.shape[-1]
    if n <= _LU_NOPIV_BASE:
        return _lu_nopiv_unblocked(a)
    h = n // 2
    f11 = _lu_nopiv_blocked(a[..., :h, :h])
    u12 = torch.linalg.solve_triangular(f11, a[..., :h, h:], upper=False,
                                        unitriangular=True)
    l21 = torch.linalg.solve_triangular(f11, a[..., h:, :h], upper=True, left=False)
    f22 = _lu_nopiv_blocked(a[..., h:, h:] - torch.matmul(l21, u12))
    return torch.cat([torch.cat([f11, u12], dim=-1),
                      torch.cat([l21, f22], dim=-1)], dim=-2)


def _getrf_nopiv_tiled(A: torch.Tensor, nb: int) -> torch.Tensor:
    """Blocked right-looking LU without pivoting of ``A`` in place."""
    m, n = A.shape[-2:]
    kmax = min(m, n)
    for k0 in range(0, kmax, nb):
        k1 = min(k0 + nb, kmax)
        blk = _lu_nopiv_blocked(A[k0:k1, k0:k1])
        A[k0:k1, k0:k1] = blk
        if k1 < m:
            # X U = B
            A[k1:m, k0:k1] = torch.linalg.solve_triangular(
                blk, A[k1:m, k0:k1], upper=True, left=False)
        if k1 < n:
            A[k0:k1, k1:n] = torch.linalg.solve_triangular(
                blk, A[k0:k1, k1:n], upper=False, unitriangular=True)
        if k1 < m and k1 < n:
            A[k1:m, k1:n].addmm_(A[k1:m, k0:k1], A[k0:k1, k1:n], alpha=-1)
    return A


def getrf_nopiv(A, opts=None):
    """LU without pivoting (src/getrf_nopiv.cc). Returns (LU, info); no host
    sync."""
    opts = Options.make(opts)
    a = inject("getrf_nopiv", as_array(A))
    m, n = a.shape[-2:]
    with trace_block("getrf_nopiv", m=m, n=n):
        out = _getrf_nopiv_tiled(_private_copy(a), max(1, min(opts.block_size, m, n)))
    info = _lu_info(torch.diagonal(out, dim1=-2, dim2=-1))
    return write_back(A, out), info


# ---------------------------------------------------------------------------
# partial-pivot getrf
# ---------------------------------------------------------------------------


#: The smallest min(m, n) at which ``Target.Auto`` factors a single 2-D CUDA
#: matrix with the port's lookahead driver (:func:`_getrf_tiled`) instead of the
#: library's whole-matrix LU.  On an H100 the driver takes 0.91x the library's
#: time at 8192 in f64 and f32, every run of it faster than every run of the
#: library, 0.83x at 16384 and 0.84x at 49152; at 3072-6144 it is within a few
#: per cent and 1.07-1.28x at 2048 (PERF.md §6).
LU_LOOKAHEAD_MIN = 8192

#: The widest panel the blocked driver takes: the pivot kernels take 2 x 4096
#: pairs of 16-byte elements in one block's shared memory (csrc/pivots.cu).
_NB_MAX = 4096


def _lu_route(device_type: str, shape, target) -> str:
    """Which LU a partial-pivot ``getrf`` runs: ``"lookahead"`` (the port's
    blocked driver, :func:`_getrf_tiled`) or ``"library"`` (one
    ``torch.linalg.lu_factor_ex`` of the whole matrix).  ``Target.Tiled``
    always takes the driver and ``Target.XLA`` the library; ``Target.Auto``
    takes the driver for a single 2-D CUDA matrix whose smaller side is at
    least :data:`LU_LOOKAHEAD_MIN`, and the library for CPU tensors, batches
    and smaller matrices."""
    if target == Target.Tiled:
        return "lookahead"
    if target == Target.Auto and device_type == "cuda" and len(shape) == 2 \
            and min(shape) >= LU_LOOKAHEAD_MIN:
        return "lookahead"
    return "library"


def _panel_width(target, block_size: int, m: int, n: int) -> int:
    """The blocked driver's panel width.  Under ``Target.Tiled`` it is
    ``Options.block_size``; under ``Target.Auto``, which picks the route from
    the shape, it is picked from the shape too: min(m, n) / 32 rounded down to
    a multiple of 256, within [256, 1024] — wider panels make each trailing
    gemm deeper (45 TFLOP/s at depth 256, 53 at 1024 on an H100) until the
    panels no longer hide behind the updates (PERF.md §6).  Either is
    kept within the matrix and :data:`_NB_MAX`."""
    if target == Target.Auto:
        block_size = min(1024, max(256, min(m, n) // 32 // 256 * 256))
    return max(1, min(block_size, m, n, _NB_MAX))


#: one high-priority side stream per CUDA device index, made on first use:
#: the caching allocator keeps freed blocks per stream, so a fresh stream a
#: call (PyTorch's pool hands out a new one each time) would cudaMalloc the
#: panels' buffers again on every call and stall the host for tens of ms
#: (PERF.md §6)
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    idx = device.index if device.index is not None else torch.cuda.current_device()
    stream = _SIDE_STREAMS.get(idx)
    if stream is None:
        stream = _SIDE_STREAMS.setdefault(
            idx, torch.cuda.Stream(device=torch.device("cuda", idx), priority=-1))
    return stream


class _Streams:
    """The blocked driver's two CUDA streams: the caller's current stream
    ("main", the trailing updates) and the device's high-priority side stream
    (the lookahead panels).  Without a side stream (a CPU tensor, or
    lookahead 0) every method is a no-op and everything runs in program
    order."""

    def __init__(self, device: torch.device, lookahead: int):
        self.main = self.side = None
        if device.type == "cuda" and lookahead > 0:
            self.main = torch.cuda.current_stream(device)
            self.side = _side_stream(device)

    def on_side(self):
        return (torch.cuda.stream(self.side) if self.side is not None
                else contextlib.nullcontext())

    def record(self, on_side: bool):
        """An event at this point of one stream (None without a side stream)."""
        if self.side is None:
            return None
        return (self.side if on_side else self.main).record_event()

    def wait(self, event, on_side: bool) -> None:
        """Make one stream wait for ``event`` of the other."""
        if event is not None:
            (self.side if on_side else self.main).wait_event(event)

    def share(self, panel: "_Panel") -> "_Panel":
        """Keep a panel's tensors from reuse until both streams are done with
        them (the caching allocator otherwise sees only the allocating
        stream)."""
        if self.side is not None:
            for t in panel:
                t.record_stream(self.main)
                t.record_stream(self.side)
        return panel


class _Panel(NamedTuple):
    """A factored panel: its row moves (absolute rows) and the inverse of its
    unit-lower diagonal block."""
    moves: torch.Tensor
    l_inv: torch.Tensor


def _factor_panel(A: torch.Tensor, k0: int, k1: int) -> _Panel:
    """The library's partially-pivoted LU of the tall panel A[k0:, k0:k1] in
    place (≅ internal::getrf_panel, getrf.cc:92-120; on the card cuSOLVER's,
    :func:`cuda_pivots.getrf_panel`), its row-move list
    (:func:`cuda_pivots.pivot_moves`, on the card) and the inverse of its
    unit-lower diagonal block, which turns every row trsm of the step into a
    gemm (cuBLAS's dtrsm of a 512 x 48640 block takes 2.5 ms on an H100, the
    inverse and the gemm 0.67 ms; PERF.md §6)."""
    m = A.shape[0]
    plu, piv = cuda_pivots.getrf_panel(A[k0:m, k0:k1])
    A[k0:m, k0:k1] = plu
    w = k1 - k0
    eye = torch.eye(w, dtype=A.dtype, device=A.device)
    l_inv = torch.linalg.solve_triangular(plu[:w], eye, upper=False, unitriangular=True)
    return _Panel(cuda_pivots.pivot_moves(piv, k0, m - k0), l_inv)


def _update(A: torch.Tensor, panel: _Panel, k0: int, k1: int, c0: int, c1: int) -> None:
    """Step (k0, k1)'s work on columns [c0, c1) right of its panel: the panel's
    row moves, the row trsm as a gemm by the inverse diagonal block
    (≅ getrf.cc:121-155) and the trailing gemm (the hot loop,
    getrf.cc:173-230)."""
    if c0 >= c1:
        return
    m = A.shape[0]
    cuda_pivots.move_rows(A[:, c0:c1], panel.moves)
    U12 = torch.matmul(panel.l_inv, A[k0:k1, c0:c1])
    A[k0:k1, c0:c1] = U12
    if k1 < m:
        A[k1:m, c0:c1].addmm_(A[k1:m, k0:k1], U12, alpha=-1)


def _getrf_tiled(A: torch.Tensor, nb: int, lookahead: int):
    """Blocked right-looking partially-pivoted LU of the row-major 2-D ``A`` in
    place, with a one-panel lookahead (getrf.cc:92-230).  Returns (A, perm),
    ``perm`` an int64 tensor on A's device.  No host sync.

    Each panel is the library's LU of the tall panel; its ipiv becomes a list of
    row moves on the card (``ops/cuda_pivots``), applied to the columns right
    of the panel before their update, to the columns left of it (the L part)
    after, and to ``perm``.  With ``lookahead`` > 0 on a CUDA tensor, step k
    runs on two streams: the side stream (high priority) moves, solves and
    updates the next panel's columns, factors that panel, then moves the L
    part and ``perm``, while the main stream updates the remaining trailing
    columns; the main stream waits for the side's panel only before step
    k + 1, and for all of the side's work before the last step's L part, so
    the caller's stream covers all the work.  A lookahead above 1 is taken as
    1.  Elsewhere the same steps run in program order."""
    m, n = A.shape
    kmax = min(m, n)
    panels = [(k0, min(k0 + nb, kmax)) for k0 in range(0, kmax, nb)]
    streams = _Streams(A.device, lookahead)
    perm = torch.arange(m, device=A.device)
    if not panels:
        return A, perm
    panel = streams.share(_factor_panel(A, *panels[0]))
    updated = streams.record(on_side=False)
    for i, (k0, k1) in enumerate(panels):
        nxt = panels[i + 1] if i + 1 < len(panels) else None
        side = nxt is not None and lookahead > 0
        ready = None
        c0 = nxt[1] if side else k1
        if side:
            # the next panel's columns, then the panel itself, on the side
            with streams.on_side():
                streams.wait(updated, on_side=True)
                _update(A, panel, k0, k1, k1, c0)
                nxt_panel = streams.share(_factor_panel(A, *nxt))
            ready = streams.record(on_side=True)
        _update(A, panel, k0, k1, c0, n)
        updated = streams.record(on_side=False)
        # the L part and perm, lazily: nothing reads them again but the next
        # panel's moves, so the side stream takes them after its panel; the
        # last step's go on the main stream once the side's work is done
        if not side:
            streams.wait(streams.record(on_side=True), on_side=False)
        with streams.on_side() if side else contextlib.nullcontext():
            cuda_pivots.move_rows(A[:, :k0], panel.moves)
            cuda_pivots.move_rows(perm, panel.moves)
        if nxt is not None and not side:
            nxt_panel = _factor_panel(A, *nxt)
        if nxt is not None:
            streams.wait(ready, on_side=False)
            panel = nxt_panel
    return A, perm


def _validate_lu_panel(opts: Options) -> None:
    slate_assert(opts.lu_panel in ("tournament", "pp"),
                 f"lu_panel must be 'tournament' or 'pp', got {opts.lu_panel!r}")


@instrument
def getrf(A, opts=None):
    """Partially-pivoted LU: returns (LU, perm, info) with A[perm] = L U
    (src/getrf.cc:22-260; dispatch over MethodLU like gesv's select_algo).

    MethodLU.CALU routes to tournament pivoting (getrf_tntpiv), NoPiv to
    getrf_nopiv (perm = identity), RBT is reserved for gesv_rbt.  The route
    (:func:`_lu_route`): Target XLA is one library LU of the whole matrix,
    Tiled the port's blocked driver with lookahead (:func:`_getrf_tiled`),
    Auto the driver for a single CUDA matrix of min(m, n) >=
    :data:`LU_LOOKAHEAD_MIN` and the library otherwise.  Host syncs: one on
    the library route (the pivots), none on the driver's.  Each call counts
    its route in ``slate_lu_route_total{route}`` and its NaN guard in
    ``slate_lu_guard_total{guard}``: ``library`` (:func:`_mark_lost_nan`) on
    the library route; ``fused`` on the lookahead route, whose private copy finds
    A's first NaN column in the pass that copies it
    (``cuda_pivots.copy_scan_nan``) and whose guard does nothing on the card
    when there is none (``cuda_pivots.guard_lost_nan``).
    """
    opts = Options.make(opts)
    # validated up front, on EVERY path: a typo'd lu_panel must raise, never
    # silently run the other panel scheme
    _validate_lu_panel(opts)
    method = opts.method_lu
    if method == MethodLU.Auto:
        method = MethodLU.PartialPiv
    if method == MethodLU.NoPiv:
        lu_, info = getrf_nopiv(A, opts)
        return lu_, torch.arange(lu_.shape[-2], device=lu_.device), info
    if method == MethodLU.CALU:
        return getrf_tntpiv(A, opts)
    if method != MethodLU.PartialPiv:
        raise SlateError(f"unsupported MethodLU {method}")

    grid = distribution_grid(A)
    if grid is not None:
        # wrapper bound to a >1-rank grid: tournament-pivoted distributed LU
        # (the grid form of getrf_tntpiv; getrf.cc consumes the construction-
        # time distribution the same way); Options.lu_panel reaches the panel
        from ..parallel import getrf_distributed

        lu_, perm, info = getrf_distributed(inject("getrf", A.dist_array()), grid,
                                            nb=opts.block_size,
                                            lu_panel=opts.lu_panel)
        return write_back(A, lu_), perm, info
    a = inject("getrf", as_array(A))
    m, n = a.shape[-2:]
    route = _lu_route(a.device.type, a.shape, opts.target)
    guard = "library" if route == "library" else "fused"
    timers = Timers()
    annotate(m=m, n=n, target=str(opts.target), route=route, guard=guard)
    if route == "library":
        # _lu_factor's two steps, each a span timed on the card
        with trace_block("getrf.factor", device=a.device):
            plu, piv, _ = torch.linalg.lu_factor_ex(a)
        with trace_block("getrf.guard", device=a.device):
            out = _mark_lost_nan(a, plu)
        piv = piv.cpu()             # the one host sync: waits for the factor
        with trace_block("getrf.pivots"):
            perm = _index(_ipiv_perm(piv, m, timers), out.device, timers)
    else:
        nb = _panel_width(opts.target, opts.block_size, m, n)
        annotate(nb=nb, panels=-(-min(m, n) // nb))
        timers["pivots"] = 0.0      # the pivots never reach the host here
        with trace_block("getrf.factor", device=a.device):
            copy, first = cuda_pivots.copy_scan_nan(a)
            out, perm = _getrf_tiled(copy, nb, opts.lookahead)
        with trace_block("getrf.guard", device=a.device):
            out = cuda_pivots.guard_lost_nan(out, first)
    counter("slate_lu_route_total", "partial-pivot getrf calls, by route").inc(
        route=route)
    counter("slate_lu_guard_total", "partial-pivot getrf NaN guards, by kind").inc(
        guard=guard)
    record_phases("getrf", timers)
    info = _lu_info(torch.diagonal(out, dim1=-2, dim2=-1))
    return write_back(A, out), perm, info


# ---------------------------------------------------------------------------
# tournament pivoting (CALU)
# ---------------------------------------------------------------------------


def _tournament_panel(panel: torch.Tensor, nb: int, timers: Timers) -> np.ndarray:
    """Select nb pivot rows of a tall panel by tournament (getrf_tntpiv.cc panel:
    block-local partially-pivoted LUs, then a binary reduction tree over
    winners).  The pair merges of one tree level are one batched LU, so a
    level costs one host sync (its pivots).

    Returns the winning local row indices (length min(nb, mp)) on the host,
    in pivot order."""
    mp, w = panel.shape
    k = min(nb, mp)
    nfull = mp // nb
    if nfull >= 2:
        V = panel[: nfull * nb].reshape(nfull, nb, w)
        I = np.arange(nfull * nb).reshape(nfull, nb)
        while V.shape[0] > 1:
            nblk = V.shape[0]
            half = nblk // 2
            V2 = torch.cat([V[0:2 * half:2], V[1:2 * half:2]], dim=1)
            I2 = np.concatenate([I[0:2 * half:2], I[1:2 * half:2]], axis=1)
            _, piv, _ = torch.linalg.lu_factor_ex(V2)        # batched pair merges
            take = _ipiv_perm(piv, V2.shape[1], timers)[:, :k]
            V2 = torch.take_along_dim(V2, _index(take, V2.device, timers)[:, :, None],
                                      dim=1)
            I2 = np.take_along_axis(I2, take, axis=1)
            if nblk % 2:
                V2 = torch.cat([V2, V[2 * half:][:, :k]], dim=0)
                I2 = np.concatenate([I2, I[2 * half:][:, :k]], axis=0)
            V, I = V2, I2
        sub, idx = V[0], I[0]
        ordered = True     # the last pair merge emitted winners in pivot order
    elif nfull == 1:
        sub, idx = panel[:nb], np.arange(nb)
        ordered = False
    else:
        sub, idx = panel, np.arange(mp)
        ordered = False
    rest = nfull * nb
    if rest and rest < mp:      # ragged tail block joins the final merge
        sub = torch.cat([sub, panel[rest:]], dim=0)
        idx = np.concatenate([idx, np.arange(rest, mp)])
        ordered = False
    if not ordered:
        # root LU orders the winners (pivot order, reference's root merge);
        # skipped when the tree already ordered them
        _, piv, _ = torch.linalg.lu_factor_ex(sub)
        idx = idx[_ipiv_perm(piv, sub.shape[0], timers)[: min(k, sub.shape[0])]]
    return idx[:k]


def _calu_inner_step(A: torch.Tensor, perm: np.ndarray, c0: int, c1: int, upto: int,
                     panel_scheme: str, timers: Timers) -> np.ndarray:
    """Factor subpanel columns [c0, c1) of ``A`` in place: pivot selection,
    dirty-row exchange, nopiv block factor + L21, then the update of the outer
    panel's columns [c1, upto) only.  Returns the updated host ``perm``."""
    m = A.shape[-2]
    w = c1 - c0
    panel = A[c0:m, c0:c1]
    if panel_scheme == "pp":
        # classic partial pivoting on the subpanel: the permutation's first w
        # entries are the rows the elimination promoted to the top
        _, piv, _ = torch.linalg.lu_factor_ex(panel)
        winners = _ipiv_perm(piv, m - c0, timers)[:w]
    else:
        winners = _tournament_panel(panel, w, timers)
    # dirty-rows-only exchange: winners move to the top w window slots and the
    # displaced occupants fill the vacated winner slots — at most 2w rows move
    with timers.time("pivots"):
        mw = m - c0
        is_w = np.zeros(mw, dtype=bool)
        is_w[winners] = True
        disp = np.nonzero(~is_w[:w])[0]
        vac = w + np.nonzero(is_w[w:])[0]
        window = np.arange(mw)
        window[:w] = winners
        window[vac] = disp
    _exchange_rows_(A, c0, window, timers)
    perm[c0:] = perm[c0:][window]
    # nopiv factor of the permuted subpanel (pivots already chosen)
    blk = _lu_nopiv_blocked(A[c0:c1, c0:c1])
    A[c0:c1, c0:c1] = blk
    if c1 < m:
        A[c1:m, c0:c1] = torch.linalg.solve_triangular(blk, A[c1:m, c0:c1],
                                                       upper=True, left=False)
    if c1 < upto:
        U12 = torch.linalg.solve_triangular(blk, A[c0:c1, c1:upto], upper=False,
                                            unitriangular=True)
        A[c0:c1, c1:upto] = U12
        if c1 < m:
            A[c1:m, c1:upto].addmm_(A[c1:m, c0:c1], U12, alpha=-1)
    return perm


def _getrf_tntpiv(A: torch.Tensor, nb: int, ib: int, panel_scheme: str,
                  timers: Timers):
    """Two-level CALU of ``A`` in place (getrf_tntpiv.cc:161-230 + its ib inner
    blocking): ib-wide pivot-selection panels, updates confined to the nb-wide
    outer panel, then the outer row trsm and the trailing gemm.  Returns
    (A, perm) with ``perm`` on the host."""
    m, n = A.shape[-2:]
    kmax = min(m, n)
    perm = np.arange(m)
    for k0 in range(0, kmax, nb):
        k1 = min(k0 + nb, kmax)
        for c0 in range(k0, k1, ib):
            perm = _calu_inner_step(A, perm, c0, min(c0 + ib, k1), k1,
                                    panel_scheme, timers)
        if k1 < n:
            # outer row trsm against the panel's unit-lower factor (the solve
            # reads only the strict lower triangle) + the trailing gemm
            U12 = torch.linalg.solve_triangular(A[k0:k1, k0:k1], A[k0:k1, k1:n],
                                                upper=False, unitriangular=True)
            A[k0:k1, k1:n] = U12
            if k1 < m:
                A[k1:m, k1:n].addmm_(A[k1:m, k0:k1], U12, alpha=-1)
    return A, perm


@instrument
def getrf_tntpiv(A, opts=None):
    """Tournament-pivoted (CALU) LU (src/getrf_tntpiv.cc:161-230).
    Returns (LU, perm, info).  Host syncs: one per tournament level of each
    ib-wide panel ("tournament"), or one per panel ("pp")."""
    opts = Options.make(opts)
    a = inject("getrf_tntpiv", as_array(A))
    m, n = a.shape[-2:]
    nb = max(1, min(opts.block_size, m, n))
    ib = max(1, min(opts.inner_blocking, nb))
    _validate_lu_panel(opts)
    timers = Timers()
    with trace_block("getrf_tntpiv", m=m, n=n):
        out, perm = _getrf_tntpiv(_private_copy(a), nb, ib, opts.lu_panel, timers)
        perm = _index(perm, out.device, timers)
    record_phases("getrf_tntpiv", timers)
    info = _lu_info(torch.diagonal(out, dim1=-2, dim2=-1))
    return write_back(A, out), perm, info


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------


def lu_factored_solve(plu, perm, rhs):
    """Permute rows + unit-lower solve + upper solve from a packed LU factor —
    the shared kernel of getrs, the *_mixed preconditioners, and gecondest."""
    pb = rhs[_as_perm(perm, rhs.device)] if perm is not None else rhs
    y = torch.linalg.solve_triangular(plu, pb, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(plu, y, upper=True)


def _device_perm(plu: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """Permutations from the library LU's 1-based ipiv without leaving the
    device: ``lu_unpack`` replays the swaps into P (A = P L U), and row i of
    the factor came from row ``perm[i]`` where column i of P holds its one.
    Bit-identical to :func:`_ipiv_perm`; int64, on ``piv``'s device."""
    P = torch.lu_unpack(plu, piv, unpack_data=False)[0]
    return (P.real if P.is_complex() else P).argmax(dim=-2)


def gesv_core(a, b):
    """Single-matrix gesv kernel: partially-pivoted LU + the two triangular
    sweeps, nothing else — no wrappers, no fault injection, no trace blocks.
    A leading batch dimension gives one ``perm`` and one ``info`` per matrix.
    Returns ``(x, perm, info)``.  No host sync: the pivots become the
    permutation on the device (:func:`_device_perm`), so the batched serving
    path can launch a batch and return before the card finishes it."""
    plu, piv = _lu_factor(a)
    perm = _device_perm(plu, piv)
    pb = torch.take_along_dim(b, perm[..., None], dim=-2)
    y = torch.linalg.solve_triangular(plu, pb, upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(plu, y, upper=True)
    d = torch.diagonal(plu, dim1=-2, dim2=-1)
    return x, perm, first_bad_index_batched(torch.isnan(d) | (d == 0))


def _trans_code(trans) -> str:
    code = ({False: "n", True: "t"}.get(trans, trans) or "n")
    return str(code).lower()[0]


def getrs(LU, perm, B, opts=None, trans=False):
    """Solve op(A) X = B from the LU factor (src/getrs.cc: permuteRows(Forward) +
    work::trsm(L) + work::trsm(U); here: one gather + two triangular solves).

    ``trans``: False/'n' solves A X = B; True/'t' solves A^T X = B; 'c' solves
    A^H X = B (the LAPACK trans codes).  A vector B gives a vector X, as the
    JAX package's triangular solves do."""
    code = _trans_code(trans)
    grid = distribution_grid(LU)
    if grid is not None and code == "n" and perm is not None:
        # a factor bound to a >1-rank grid: the two sweeps on its block layout
        from ..parallel import getrs_distributed

        b = dist_operand(B)
        return write_back(B, getrs_distributed(LU.dist_array(), perm, b, grid))
    lu_ = as_array(LU)
    with trace_block("getrs", device=lu_.device):
        b = as_array(B, device=lu_.device)
        vec = b.ndim == 1
        if vec:
            b = b[:, None]
        if code in ("t", "c"):
            # op(A) x = b  =>  U^op y = b; L^op z = y; x = perm^{-1} scatter
            op = lu_.mH if code == "c" else lu_.mT
            y = torch.linalg.solve_triangular(op, b, upper=False)
            z = torch.linalg.solve_triangular(op, y, upper=True, unitriangular=True)
            if perm is not None:
                x = torch.zeros_like(z)
                x[_as_perm(perm, z.device)] = z
            else:
                x = z
        else:
            x = lu_factored_solve(lu_, perm, b)
        return write_back(B, x[:, 0] if vec else x)


def getrs_nopiv(LU, B, opts=None, trans=False):
    """Solve from a pivot-free LU factor (src/getrs_nopiv.cc): the two triangular
    sweeps with no row permutation."""
    return getrs(LU, None, B, opts, trans=trans)


@instrument
def gesv(A, B, opts=None):
    """Solve A X = B (src/gesv.cc = getrf + getrs).

    Returns (X, perm, info); with ``Options(solve_report=True)``,
    (X, perm, info, SolveReport)."""
    opts = Options.make(opts)
    lu_, perm, info = getrf(A, opts if not opts.solve_report
                            else opts.replace(solve_report=False))
    from ..parallel.distribute import is_dist

    # a distributed factor is held by the grid-bound A: getrs solves on its
    # block layout
    X = getrs(A if is_dist(lu_) else lu_, perm, B, opts)
    if opts.solve_report:
        report = SolveReport(routine="gesv", info=int(info),
                             precision_used=_dtype_name(lu_.dtype),
                             fallback_chain=(str(opts.method_lu),)).finalize()
        report.recovered = report.info == 0
        return X, perm, info, report
    return X, perm, info


def _pristine_or_wrapper(A, a0, a_in):
    """The operand a full-precision rung factors: the caller's wrapper when no
    fault fired (so it keeps its in-place factor write-back), else the
    (corrupted) tensor."""
    return A if (a_in is a0 and isinstance(A, BaseMatrix)) else a_in


def gesv_nopiv(A, B, opts=None):
    """Solve A X = B without pivoting, escalating to partial pivoting on breakdown.

    The declared ladder (src/gesv_nopiv.cc + robust.LADDERS["gesv_nopiv"]): a
    nopiv breakdown (zero pivot, info > 0, or non-finite X) re-solves with
    partial pivoting from the *pristine* operand when Option::UseFallbackSolver
    holds.  Detecting the breakdown costs one host sync (a fused
    info+isfinite verdict); ``Options(use_fallback_solver=False)`` with no
    report, retries or fault plan skips the ladder and that sync.  Returns
    (X, perm, info); with ``Options(solve_report=True)``,
    (X, perm, info, SolveReport)."""
    opts = Options.make(opts)
    base = opts.replace(method_lu="nopiv", solve_report=False)
    if (not opts.use_fallback_solver and not opts.solve_report
            and opts.max_retries <= 0 and active() is None):
        # single-rung ladder with nothing to observe it: skip the machinery
        return gesv(A, B, base)
    a0 = as_array(A)
    b0 = as_array(B, device=a0.device)   # immutable snapshots: rungs re-solve
    #                                      from intact inputs
    report = SolveReport(routine="gesv_nopiv") if opts.solve_report else None
    policy = RetryPolicy.from_options(opts, "gesv_nopiv")

    def _operand():
        # a Matrix wrapper keeps its in-place factor write-back: restore the
        # pristine operand first (a prior rung left ITS factor in the
        # wrapper), then let gesv factor the wrapper itself
        if isinstance(A, BaseMatrix):
            write_back(A, a0)
            return A
        return a0

    def nopiv_rung():
        out = gesv(_operand(), b0, base)
        ok = bool((out[2] == 0) & torch.isfinite(as_array(out[0])).all())
        return out, ok

    def pp_rung():
        out = gesv(_operand(), b0, base.replace(method_lu="partialpiv"))
        return out, bool(out[2] == 0)

    rungs = [Rung("nopiv", nopiv_rung)]
    if opts.use_fallback_solver:
        rungs.append(Rung("partialpiv", pp_rung))
    X, perm, info = run_ladder("gesv_nopiv", rungs, policy, report)
    X = write_back(B, as_array(X))
    if report is not None:
        report.info = int(info)
        report.precision_used = _dtype_name(a0.dtype)
        return X, perm, info, report.finalize()
    return X, perm, info


def getri(LU, perm, opts=None):
    """Inverse from the LU factor (src/getri.cc): solves A X = I against the
    factored (LU, perm) pair from getrf, writing the inverse back over the
    factor — the reference's in-place contract."""
    lu_ = as_array(LU)
    n = lu_.shape[-1]
    X = getrs(lu_, perm, torch.eye(n, dtype=lu_.dtype, device=lu_.device), opts)
    return write_back(LU, X)


def getri_oop(LU, perm, B, opts=None):
    """Out-of-place inverse (src/getriOOP.cc): writes A^{-1} into B from the
    factored (LU, perm) pair, leaving the factor intact for reuse."""
    lu_ = as_array(LU)
    n = lu_.shape[-1]
    X = getrs(lu_, perm, torch.eye(n, dtype=lu_.dtype, device=lu_.device), opts)
    return write_back(B, X)


# ---------------------------------------------------------------------------
# mixed precision + GMRES-IR
# ---------------------------------------------------------------------------


@instrument
def gesv_mixed(A, B, opts=None):
    """Low-precision LU factor + working-precision iterative refinement
    (src/gesv_mixed.cc:23-40,106+), run as the declared mixed→full escalation
    ladder (robust.LADDERS["gesv_mixed"]; Option::UseFallbackSolver gates the
    second rung, gesv_mixed.cc:93-96).  Returns (X, perm, info, iters); with
    ``Options(solve_report=True)``, (..., SolveReport).  Host syncs: the
    pivots, those of :func:`chol._ir_solve`, and one per full-precision rung."""
    opts = Options.make(opts)
    a0 = as_array(A)        # pristine snapshot: each rung re-enters the input
    #                         injection site, so a call_index=0 input fault is
    #                         transient under escalation
    b = as_array(B, device=a0.device)
    plain = opts.replace(solve_report=False)
    lo = _factor_precision(opts, a0.dtype)
    report = SolveReport(routine="gesv_mixed") if opts.solve_report else None

    def full_solve():
        X, perm, info = gesv(_pristine_or_wrapper(A, a0, inject("gesv_mixed", a0)),
                             b, plain)
        return as_array(X), perm, info

    if lo is None:
        X, perm, info = full_solve()
        X = write_back(B, X)
        if report is not None:
            report.record_rung("full")
            report.info, report.precision_used = int(info), _dtype_name(a0.dtype)
            report.recovered = report.info == 0
            return X, perm, info, _iters(0), report.finalize()
        return X, perm, info, _iters(0)

    state = {"iters": 0}

    def mixed_rung():
        a = inject("gesv_mixed", a0)
        timers = Timers()
        with trace_block("gesv_mixed", lo=_dtype_name(lo)):
            plu, piv = _lu_factor(a.to(lo))
            perm = _index(_ipiv_perm(piv, a.shape[-2], timers), a.device, timers)
            plu = inject("gesv_mixed", plu, point="factor")
            info = _lu_info(torch.diagonal(plu, dim1=-2, dim2=-1))
            x, iters, converged = _ir_solve(
                a, b, lambda rhs: lu_factored_solve(plu, perm, rhs.to(lo)), opts)
        record_phases("gesv_mixed", timers)
        state["iters"] = iters
        return (x, perm, info), converged

    def full_rung():
        X, perm, info = full_solve()
        return (X, perm, info), bool(info == 0)

    rungs = [Rung("mixed", mixed_rung)]
    if opts.use_fallback_solver:
        rungs.append(Rung("full", full_rung))
    x, perm, info = run_ladder("gesv_mixed", rungs,
                               RetryPolicy.from_options(opts, "gesv_mixed"),
                               report)
    X = write_back(B, x)
    if report is not None:
        report.info = int(info)
        report.iters = state["iters"]
        report.precision_used = _dtype_name(lo if report.fallback_chain == ("mixed",)
                                            else a0.dtype)
        return X, perm, info, _iters(state["iters"]), report.finalize()
    return X, perm, info, _iters(state["iters"])


def _lstsq_min_norm(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD, with ``jnp.linalg.lstsq``'s
    cut-off (singular values below eps·max(shape)·s_max count as zero), so a
    rank-deficient Hessenberg matrix (a GMRES breakdown) still gets the
    minimum-norm step.  ``torch.linalg.lstsq`` on the card has only the
    full-rank ``gels`` driver."""
    U, S, Vh = torch.linalg.svd(H, full_matrices=False)
    rcond = torch.finfo(S.dtype).eps * max(H.shape)
    keep = (S > 0) & (S >= rcond * S[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                        torch.zeros_like(S)).to(H.dtype)
    return torch.matmul(Vh.mH, s_inv * torch.matmul(U.mH, rhs))


def _fgmres(matvec, precond, b, x0, restart, tol, max_restarts):
    """Restarted FGMRES with right preconditioning (src/gesv_mixed_gmres.cc uses
    GMRES-IR the same way).  The restart loop runs on the host: one sync per
    restart for the ``resid > tol`` test, plus the one ``torch.linalg.svd``
    takes on the card for the small least squares.  A NaN residual fails the
    test and exits, preserving the NaN-safe fallback verdict.  Returns
    (x, restarts)."""

    def cycle(x):
        r = b - matvec(x)
        beta = torch.linalg.vector_norm(r)
        V = torch.zeros((restart + 1,) + b.shape, dtype=b.dtype, device=b.device)
        Z = torch.zeros((restart,) + b.shape, dtype=b.dtype, device=b.device)
        H = torch.zeros((restart + 1, restart), dtype=b.dtype, device=b.device)
        V[0] = r / torch.where(beta == 0, torch.ones_like(beta), beta)
        for j in range(restart):       # the Krylov dimension is small
            z = precond(V[j])
            w = matvec(z)
            # modified Gram-Schmidt
            for i in range(j + 1):
                hij = torch.vdot(V[i], w)
                H[i, j] = hij
                w = w - hij * V[i]
            hn = torch.linalg.vector_norm(w)
            H[j + 1, j] = hn
            V[j + 1] = w / torch.where(hn == 0, torch.ones_like(hn), hn)
            Z[j] = z
        # least squares min ||beta e1 - H y||
        e1 = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
        e1[0] = beta
        y = _lstsq_min_norm(H, e1)
        return x + torch.tensordot(y, Z, dims=1)

    x, restarts = x0, 0
    resid = torch.linalg.vector_norm(b - matvec(x0))
    while restarts < max_restarts and bool(resid > tol):
        x = cycle(x)
        restarts += 1
        resid = torch.linalg.vector_norm(b - matvec(x))
    return x, restarts


def _require_single_rhs(b, routine: str):
    """GMRES-IR drivers take one RHS like the reference — enforced up front, for
    every dtype, so the contract doesn't depend on whether a lower precision
    exists."""
    if b.ndim != 1 and b.shape[-1] != 1:
        raise SlateError(f"{routine} supports a single RHS (matches reference)")


def _gmres_ir(matvec, precond, b, opts, routine: str):
    """Shared GMRES-IR body for gesv_mixed_gmres / posv_mixed_gmres: tolerance,
    restarted FGMRES, NaN-safe convergence verdict.  Host syncs: those of
    :func:`_fgmres` plus one for the verdict.
    Returns (x shaped like b, restarts, converged)."""
    squeeze = b.ndim == 1
    _require_single_rhs(b, routine)
    bv = b.reshape(-1) if not squeeze else b
    n = bv.shape[0]
    eps = torch.finfo(bv.real.dtype).eps
    tol = (opts.tolerance if opts.tolerance is not None
           else eps * (n ** 0.5)) * torch.linalg.vector_norm(bv)
    x, restarts = _fgmres(matvec, precond, bv, precond(bv), restart=min(30, n),
                          tol=tol, max_restarts=opts.max_iterations // 10 + 1)
    resid = torch.linalg.vector_norm(bv - matvec(x))
    converged = bool(resid <= tol * 10)      # NaN residual fails this, forcing fallback
    return (x if squeeze else x[:, None]), restarts, converged


@instrument
def gesv_mixed_gmres(A, B, opts=None):
    """GMRES-IR: FGMRES in working precision, right-preconditioned by the
    low-precision LU solve (src/gesv_mixed_gmres.cc). Single-RHS path like the
    reference (it restricts to nrhs == 1). Returns (X, perm, info, iters);
    iters is the restart count, -1 when the full-precision fallback solved
    the system."""
    opts = Options.make(opts)
    a = as_array(A)
    b = as_array(B, device=a.device)
    _require_single_rhs(b, "gesv_mixed_gmres")
    lo = _factor_precision(opts, a.dtype)
    if lo is None:
        # solve_report stays off here: gesv would otherwise append a report
        # and break this 3-way unpack (gesv_mixed_gmres has no report form)
        X, perm, info = gesv(A, B, opts.replace(solve_report=False))
        return X, perm, info, _iters(0)

    timers = Timers()
    with trace_block("gesv_mixed_gmres", lo=_dtype_name(lo)):
        plu, piv = _lu_factor(a.to(lo))
        perm = _index(_ipiv_perm(piv, a.shape[-2], timers), a.device, timers)
        info = _lu_info(torch.diagonal(plu, dim1=-2, dim2=-1))

        def precond(r):
            z = lu_factored_solve(plu, perm, r.to(lo)[:, None])
            return z[:, 0].to(b.dtype)

        x_out, restarts, converged = _gmres_ir(lambda x: torch.matmul(a, x), precond,
                                               b, opts, "gesv_mixed_gmres")
    record_phases("gesv_mixed_gmres", timers)

    if opts.use_fallback_solver and not converged:
        # mixed_gmres→full ladder (robust.LADDERS) — open-coded because the
        # GMRES machinery already returned its verdict; the event keeps the
        # escalation visible in the trace
        trace_event("fallback", routine="gesv_mixed_gmres", to="full")
        X, perm, info = gesv(A, B, opts.replace(solve_report=False))
        return X, perm, info, _iters(-1)
    return write_back(B, x_out), perm, info, _iters(restarts)


# ---------------------------------------------------------------------------
# random butterfly transform (RBT)
# ---------------------------------------------------------------------------


def rbt_generate(key, n, depth, dtype):
    """Generate the diagonals of a depth-d recursive butterfly transform
    (src/internal/internal_gerbt.cc rbt_generate).

    Each level has a diagonal of exp(r/10) entries, r uniform on [-0.5, 0.5),
    drawn from the ``torch.Generator`` ``key`` on its device; returns a
    [depth, n] tensor.  The draws differ from the JAX package's
    ``jax.random`` bits from the same seed."""
    dtype = torch_dtype(dtype)
    real = torch.empty((), dtype=dtype).real.dtype
    r = torch.rand((depth, n), generator=key, device=key.device, dtype=real) - 0.5
    return torch.exp(r / 10.0).to(dtype)


def _butterfly_apply(W, x, transpose=False):
    """Apply the depth-d butterfly U (or U^T) to the leading axis of x.

    One level on a vector v of length 2h: with diagonals (r1, r2):
        B v = [r1*v1 + r2*v2, r1*v1 - r2*v2] / sqrt(2)
    Levels nest recursively on halves, expressed with reshapes.
    """
    W = to_tensor(W, device=x.device)
    depth, n = W.shape
    levels = range(depth - 1, -1, -1) if transpose else range(depth)
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=x.dtype, device=x.device))
    bcast = (1,) * (x.ndim - 1)
    y = x
    for d in levels:
        nblk = 2 ** (depth - 1 - d)
        h = n // (2 * nblk)
        rv = (W[d] / sqrt2).reshape((nblk, 2, h) + bcast)
        yv = y.reshape((nblk, 2, h) + tuple(x.shape[1:]))
        if not transpose:
            a = rv[:, 0] * yv[:, 0]
            bpart = rv[:, 1] * yv[:, 1]
            top, bot = a + bpart, a - bpart
        else:
            # B^T w: v1 = r1*(w1 + w2), v2 = r2*(w1 - w2)
            top = rv[:, 0] * (yv[:, 0] + yv[:, 1])
            bot = rv[:, 1] * (yv[:, 0] - yv[:, 1])
        y = torch.stack([top, bot], dim=1).reshape(x.shape)
    return y


def _two_sided(Wu, Wv, a):
    """U^T a V through two transposed butterfly applications."""
    a1 = _butterfly_apply(Wu, a, transpose=True)
    return _butterfly_apply(Wv, a1.mT, transpose=True).mT


def gerbt(Wu, Wv, A):
    """Two-sided butterfly transform A' = U^T A V (src/gerbt.cc)."""
    return write_back(A, _two_sided(Wu, Wv, as_array(A)))


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)


@instrument
def gesv_rbt(A, B, opts=None, key=None):
    """Solve via random butterfly transform + nopiv LU + refinement
    (src/gesv_rbt.cc:94-172), run as the declared RBT→partial-pivot
    escalation ladder (robust.LADDERS["gesv_rbt"]): when the butterfly fails
    to tame the matrix (nopiv breakdown or IR stall) the pivoted solve takes
    over from the pristine operand.

    ``key`` is a ``torch.Generator``; the default is one seeded with 42 on the
    operand's device.  Both butterflies are drawn once, before the ladder, so
    a retried rung sees the same transform.  Returns (X, info, iters); with
    ``Options(solve_report=True)``, (X, info, iters, SolveReport).  Host
    syncs: those of :func:`chol._ir_solve`, and one per pivoted rung."""
    opts = Options.make(opts)
    a0 = as_array(A)        # pristine snapshot: each rung re-enters the input
    #                         injection site (transient-fault contract)
    b = as_array(B, device=a0.device)
    grid = distribution_grid(A)
    if grid is not None:
        # construction-time grid: the distributed butterfly + nopiv-LU + IR
        # path (parallel/rbt.py), like every other driver's grid dispatch
        from ..parallel import gather
        from ..parallel.rbt import gesv_rbt_distributed

        X, info, iters, via_rbt = gesv_rbt_distributed(
            inject("gesv_rbt", a0), b, grid, depth=opts.depth,
            nb=min(opts.block_size, a0.shape[-1]), key=key,
            max_iterations=opts.max_iterations,
            use_fallback=opts.use_fallback_solver, tol=opts.tolerance)
        X = write_back(B, gather(X))
        if opts.solve_report:
            chain = ("rbt",) if via_rbt else ("rbt", "partialpiv")
            report = SolveReport(routine="gesv_rbt", info=int(info), iters=int(iters),
                                 precision_used=_dtype_name(a0.dtype),
                                 fallback_chain=chain).finalize()
            report.recovered = report.info == 0
            return X, info, _iters(int(iters)), report
        return X, info, _iters(int(iters))
    n = a0.shape[-1]
    depth = opts.depth
    # pad n to a multiple of 2^depth for the butterfly recursion
    pad = (-n) % (2 ** depth)
    np_ = n + pad
    if key is None:
        key = torch.Generator(device=a0.device).manual_seed(42)
    Wu = rbt_generate(key, np_, depth, a0.dtype).to(a0.device)
    Wv = rbt_generate(key, np_, depth, a0.dtype).to(a0.device)
    plain = opts.replace(solve_report=False)
    report = SolveReport(routine="gesv_rbt") if opts.solve_report else None
    state = {"iters": 0}

    def rbt_rung():
        a = inject("gesv_rbt", a0)
        ap = a.new_zeros((np_, np_))
        ap[:n, :n] = a
        if pad:
            ap[n:, n:].diagonal().fill_(1)
        with trace_block("gesv_rbt", n=n, depth=depth):
            lu_p, info = getrf_nopiv(_two_sided(Wu, Wv, ap), plain)
            lu_p = inject("gesv_rbt", lu_p, point="factor")

            def solve_rbt(rhs):
                y = _butterfly_apply(Wu, _pad_rows(rhs, pad), transpose=True)
                z = torch.linalg.solve_triangular(lu_p, y, upper=False,
                                                  unitriangular=True)
                w = torch.linalg.solve_triangular(lu_p, z, upper=True)
                return _butterfly_apply(Wv, w, transpose=False)[:n]

            x, iters, converged = _ir_solve(a, b, solve_rbt, opts)
        state["iters"] = iters
        return (x, info), converged

    def pp_rung():
        X, _, info = gesv(_pristine_or_wrapper(A, a0, inject("gesv_rbt", a0)), b, plain)
        return (as_array(X), info), bool(info == 0)

    rungs = [Rung("rbt", rbt_rung)]
    if opts.use_fallback_solver:
        rungs.append(Rung("partialpiv", pp_rung))
    x, info = run_ladder("gesv_rbt", rungs,
                         RetryPolicy.from_options(opts, "gesv_rbt"), report)
    X = write_back(B, x)
    if report is not None:
        report.info = int(info)
        report.iters = state["iters"]
        report.precision_used = _dtype_name(a0.dtype)
        return X, info, _iters(state["iters"]), report.finalize()
    return X, info, _iters(state["iters"])
