"""Row pivots of the blocked LU on the card, its panel LU, and its private copy and
NaN guard: the CUDA code of ``csrc/pivots.cu`` and its plain PyTorch versions.

They replace no Pallas kernel (the JAX package's LU is XLA's, which keeps its pivots
on the device); they let the port's blocked LU (``linalg/lu.py::_getrf_tiled``) turn
a library panel's LAPACK ipiv into row moves without a host sync:

* :func:`pivot_moves` — a panel's ``w`` sequential swaps (1-based, relative to its
  top row ``row0``) become a fixed-size list of ``2w`` (dst, src) absolute row pairs,
  ``(-1, -1)`` where no row moves.  Moving row ``src`` to row ``dst`` for every pair
  applies the panel's permutation to the rows below ``row0``: the same permutation
  ``linalg.lu._ipiv_perm`` replays on the host.
* :func:`move_rows` — applies such a list to a 2-D tensor with unit column stride
  (any row stride: a column range of a row-major matrix) or to a contiguous vector
  (the int64 ``perm``), for elements of 4, 8 or 16 bytes.  Rows move whole; every
  source row is read before any destination is written.
* :func:`getrf_panel` — the library's partially pivoted LU of one panel, as
  ``torch.linalg.lu_factor_ex`` gives it; on the card, cuSOLVER's getrf queued on
  the caller's stream through this library's own handle.  PyTorch's default sends a
  non-square matrix to MAGMA's batched kernels (a 16384 x 256 f64 panel in 10.8 ms
  on an H100, one idamax launch a column), and reaches cuSOLVER for it only
  through ``torch.backends.cuda.preferred_linalg_library``, a setting of the whole
  process that would switch every other thread's library LUs while a panel is
  factored.
* :func:`copy_scan_nan` — the private row-major copy the blocked LU factors in
  place, and from the same pass the 1-based index of A's first column holding a
  NaN (0 for none) as a device int32: what ``linalg.lu._private_copy`` and the
  first half of ``linalg.lu._mark_lost_nan`` give.
* :func:`guard_lost_nan` — the second half of ``_mark_lost_nan`` on the factor,
  driven by that index on the card: nothing when A held no NaN; otherwise the
  columns from the first NaN column on are NaN-filled when the factor lost every
  NaN.  No host sync either way.

Bounds on an H100 SXM: :func:`pivot_moves` is latency (w dependent swaps by one
thread, ~15 us at w = 512); :func:`move_rows` the bytes of the moved rows, read once
and written once, ``2 · rows · ncols · itemsize / 3.35 TB/s`` (0.24 ms for 1024 rows
of 49152 f64); :func:`copy_scan_nan` the bytes of A read once and the copy
written once, :func:`move_bound_ms` of all m rows (11.5 ms at 49152² f64);
:func:`guard_lost_nan` two near-empty launches where A held no NaN.  See the note
at the top of ``csrc/pivots.cu``.

Routing: a CPU tensor takes the plain version (what the CPU tests check); a CUDA
tensor launches the kernel or raises — there is no fallback.  The library is built
with ``nvcc`` for ``sm_90a``, linked with the toolkit's cuSOLVER, into
``slate_tpu_torch/_build/`` on first use (rebuilt when the source changes) and
loaded with ``ctypes``.  ``LAUNCHES`` counts launches (a getrf call counts one, and
so does each call of the two NaN-guard wrappers).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Tuple

import torch

from ..core.exceptions import SlateError
from ..robust.report import first_bad_index_batched
from .cuda_norms import HBM_BYTES_PER_S, _sm_count, compile_library

#: kernel launches per wrapper (a launch for a comparison counts too)
LAUNCHES: Dict[str, int] = {"pivot_moves": 0, "move_rows": 0, "getrf_panel": 0,
                            "copy_scan_nan": 0, "guard_lost_nan": 0}

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "pivots.cu")
_lib = None
_lib_lock = threading.Lock()
_ITEMSIZES = (4, 8, 16)
#: csrc/pivots.cu's dtype codes of its getrf entry points
_GETRF_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
                 torch.complex128: 3}


def build() -> str:
    """Compile ``csrc/pivots.cu`` for sm_90a with cuSOLVER (once per source hash)
    and load it.
    Returns the library path.  Raises :class:`SlateError` if nvcc is missing or
    fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib._name
        lib = ctypes.CDLL(compile_library(_SRC, "slate_pivots", libs=("cusolver",)))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.slate_pivot_moves.argtypes = [p, i32, i64, i32, p, p]
        lib.slate_move_rows.argtypes = [p, i64, i64, i32, p, i32, p]
        lib.slate_getrf_lwork.argtypes = [i32, i32, i32, p, i32, ctypes.POINTER(i32)]
        lib.slate_getrf.argtypes = [i32, i32, i32, p, i32, p, p, p, p]
        lib.slate_copy_scan_nan.argtypes = [i32, p, p, i64, i64, i64, i64, i32, i64,
                                            i32, p, p]
        lib.slate_guard_lost_nan.argtypes = [i32, p, i64, i64, i64, i64, i64, i64, i32,
                                             i32, p, p, p]
        for fn in (lib.slate_pivot_moves, lib.slate_move_rows, lib.slate_getrf_lwork,
                   lib.slate_getrf, lib.slate_copy_scan_nan, lib.slate_guard_lost_nan):
            fn.restype = i32
        _lib = lib
        return lib._name


#: the most shared memory a block of either kernel takes (csrc/pivots.cu kMaxSmem):
#: :func:`pivot_moves` holds 16 bytes a panel column, :func:`move_rows` one
#: element a pair at the least
MAX_SMEM = 200 * 1024
#: the widest panel :func:`pivot_moves` takes on the card
MAX_WIDTH = MAX_SMEM // 16


def move_bound_ms(rows: int, ncols: int, itemsize: int) -> float:
    """The least time an H100 SXM needs to move ``rows`` whole rows of ``ncols``
    elements: each read once and written once at the device memory rate."""
    return 2 * rows * ncols * itemsize / HBM_BYTES_PER_S * 1e3


#: the scan kernels' threads a block, one pack each (csrc/pivots.cu
#: kScanThreads), and the guard's blocks an SM: its grid is one wave that loops
_SCAN_THREADS, _GUARD_BLOCKS_PER_SM = 256, 8


def scan_plan(m: int, n: int, dtype, lds: int, aligned: bool, copy: bool) -> dict:
    """How :func:`copy_scan_nan`'s kernel (and :func:`guard_lost_nan`'s scan)
    walks an m x n matrix of ``dtype`` whose rows lie ``lds`` elements apart,
    into a row-major copy when ``copy``: ``rows`` view rows of ``len`` packs of
    ``vw`` scalars, ``lds`` / ``ldd`` packs apart in the source and the copy,
    ``units`` blocks' worth of packs (one a thread) a view row, ``blocks`` the
    copy's grid: a block a unit, as far as the grid reaches (the guard takes one
    wave of them).  Rows that lie back to back (``lds == n``, or one
    row) are walked as one view row; a pack is 16 bytes where the bases are
    16-byte ``aligned`` and every view row starts on a 16-byte boundary, else one
    scalar.  A complex element is ``comps`` = 2 scalars; scalar s of a view row
    lies in column (s // comps) % n."""
    comps = 2 if dtype.is_complex else 1
    scalar = dtype.itemsize // comps
    flat = m <= 1 or lds == n
    rows, row = (1, m * n * comps) if flat else (m, n * comps)
    pitches = (0, 0) if flat else (lds * comps, n * comps if copy else 0)
    per = 16 // scalar
    vw = per if aligned and row % per == 0 and all(
        p * scalar % 16 == 0 for p in pitches) else 1
    length = row // vw
    units = -(-length // _SCAN_THREADS)
    return {"rows": rows, "len": length, "units": units, "lds": pitches[0] // vw,
            "ldd": pitches[1] // vw, "vw": vw, "comps": comps,
            "blocks": max(1, min(rows * units, 2**31 - 1))}


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------


def pivot_moves_plain(ipiv: torch.Tensor, row0: int, mw: int) -> torch.Tensor:
    """The row-move list of a panel's swaps (plain PyTorch, the kernel's slot
    order): ``(2w, 2)`` int32 on ``ipiv``'s device.  Slot ``s < w`` is panel row
    ``s``; slot ``w + k`` is swap ``k``'s target when it lies below the panel and
    no earlier swap names it.  An entry outside the window of ``mw`` rows counts
    as no swap, as in the kernel."""
    piv = [int(v) - 1 for v in ipiv.reshape(-1).tolist()]
    w = len(piv)
    piv = [j if 0 <= j < mw else k for k, j in enumerate(piv)]
    rows: Dict[int, int] = {}
    for k, j in enumerate(piv):
        rows[k], rows[j] = rows.get(j, j), rows.get(k, k)
    out = [(-1, -1)] * (2 * w)
    seen = set()
    for s in range(2 * w):
        if s < w:
            pos = s
        else:
            pos = piv[s - w]
            if pos < w or pos in seen:
                continue
            seen.add(pos)
        src = rows.get(pos, pos)
        if src != pos:
            out[s] = (row0 + pos, row0 + src)
    return torch.tensor(out, dtype=torch.int32,
                        device=ipiv.device).reshape(2 * w, 2)


def copy_scan_nan_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-major copy of ``a`` and the 1-based index of its first column
    holding a NaN, 0 for none (plain PyTorch: the clone, an ``isnan`` pass)."""
    return (a.clone(memory_format=torch.contiguous_format),
            first_bad_index_batched(torch.isnan(a).any(dim=-2)))


def guard_lost_nan_plain(plu: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """NaN-fill, in place, every row of ``plu``'s columns from ``first`` - 1 on
    when ``first`` is set and ``plu`` holds no NaN (plain PyTorch: an ``isnan``
    pass and a ``masked_fill_``)."""
    lost = (first > 0) & ~torch.isnan(plu).any()
    cols = torch.arange(plu.shape[-1], device=plu.device)
    return plu.masked_fill_(lost & (cols >= first - 1), float("nan"))


def move_rows_plain(a: torch.Tensor, moves: torch.Tensor) -> torch.Tensor:
    """Apply a row-move list to ``a`` in place (plain PyTorch): row ``dst``
    takes what row ``src`` held before any move, for every live pair."""
    live = moves[:, 0] >= 0
    dst, src = moves[live, 0].long(), moves[live, 1].long()
    a[dst] = a[src]
    return a


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pivot_moves(ipiv: torch.Tensor, row0: int, mw: int) -> torch.Tensor:
    """The row-move list of a panel's ``w`` swaps: ``ipiv`` (w,) 1-based int32
    from the library LU of a panel of ``mw`` rows whose top row is ``row0`` ->
    ``(2w, 2)`` int32 (dst, src) absolute rows, ``(-1, -1)`` where nothing
    moves.  One launch, no host sync."""
    if not ipiv.is_cuda:
        return pivot_moves_plain(ipiv, row0, mw)
    if ipiv.ndim != 1 or ipiv.dtype != torch.int32 or not ipiv.is_contiguous():
        raise SlateError(f"pivot_moves: expects a contiguous 1-D int32 ipiv, got "
                         f"{ipiv.dtype} of shape {tuple(ipiv.shape)}")
    w = ipiv.shape[0]
    if w > MAX_WIDTH or mw < w or row0 < 0 or row0 + mw >= 2**31:
        raise SlateError(f"pivot_moves: a panel of {w} columns and {mw} rows at row "
                         f"{row0} is outside what the kernel takes (w <= {MAX_WIDTH}, "
                         "mw >= w, rows < 2**31)")
    out = torch.empty((2 * w, 2), dtype=torch.int32, device=ipiv.device)
    if w == 0:
        return out
    build()
    with torch.cuda.device(ipiv.device):
        rc = _lib.slate_pivot_moves(ipiv.data_ptr(), w, mw, row0, out.data_ptr(),
                                    _stream(ipiv))
    if rc != 0:
        raise SlateError(f"pivot_moves kernel launch failed: cudaError {rc}")
    LAUNCHES["pivot_moves"] += 1
    return out


def move_rows(a: torch.Tensor, moves: torch.Tensor) -> torch.Tensor:
    """Apply the row-move list ``moves`` ((p, 2) int32 from :func:`pivot_moves`)
    to ``a`` in place and return it: a 2-D tensor with unit column stride (any
    row stride) or a contiguous vector.  One launch, no host sync."""
    if not a.is_cuda:
        return move_rows_plain(a, moves)
    if moves.ndim != 2 or moves.shape[1] != 2 or moves.dtype != torch.int32 \
            or not moves.is_contiguous() or moves.device != a.device:
        raise SlateError("move_rows: expects a contiguous (p, 2) int32 list on the "
                         f"tensor's device, got {moves.dtype} of shape "
                         f"{tuple(moves.shape)} on {moves.device}")
    if a.ndim == 1:
        if a.stride(0) != 1:
            raise SlateError("move_rows: a vector must be contiguous")
        lda, ncols = 1, 1
    elif a.ndim == 2:
        if a.shape[1] > 1 and a.stride(1) != 1:
            raise SlateError(f"move_rows: needs unit column stride, got strides "
                             f"{tuple(a.stride())}")
        lda, ncols = max(a.stride(0), 1), a.shape[1]
    else:
        raise SlateError(f"move_rows: expects a 1-D or 2-D tensor, got {a.ndim}-D")
    itemsize = a.element_size()
    if itemsize not in _ITEMSIZES:
        raise SlateError(f"move_rows: moves elements of 4, 8 or 16 bytes, got {a.dtype}")
    npairs = moves.shape[0]
    if npairs * itemsize > MAX_SMEM:
        raise SlateError(f"move_rows: {npairs} pairs of {itemsize}-byte elements "
                         f"exceed the kernel's {MAX_SMEM} bytes of shared memory")
    if a.numel() == 0 or npairs == 0:
        return a
    build()
    with torch.cuda.device(a.device):
        rc = _lib.slate_move_rows(a.data_ptr(), lda, ncols, itemsize, moves.data_ptr(),
                                  npairs, _stream(a))
    if rc != 0:
        raise SlateError(f"move_rows kernel launch failed: cudaError {rc} "
                         f"({npairs} pairs of {itemsize}-byte elements)")
    LAUNCHES["move_rows"] += 1
    return a


def _scan_dtype(a: torch.Tensor, what: str) -> int:
    code = _GETRF_DTYPES.get(a.dtype)
    if code is None or a.ndim != 2:
        raise SlateError(f"{what}: expects a 2-D float or complex matrix, got "
                         f"{a.dtype} of shape {tuple(a.shape)}")
    if a.shape[1] >= 2**31 - 1:
        raise SlateError(f"{what}: {a.shape[1]} columns exceed the kernel's int32 index")
    return code


def _unit_columns(a: torch.Tensor) -> bool:
    """Whether the kernels read ``a`` as it lies: unit column stride (any row
    stride) and no pending conjugation or negation."""
    return (a.shape[1] <= 1 or a.stride(1) == 1) and not a.is_conj() and not a.is_neg()


def copy_scan_nan(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The private row-major copy of the 2-D ``a`` the blocked LU factors in
    place, and the 1-based index of ``a``'s first column that holds a NaN (a
    complex element whose real or imaginary part is NaN), 0 for none, as a 0-d
    int32 on ``a``'s device: :func:`copy_scan_nan_plain`'s results, bit for
    bit.  On the card one pass over ``a`` where it has unit column stride (any
    row stride); any other layout is copied by ``clone`` and the copy scanned.
    No host sync."""
    if not a.is_cuda:
        return copy_scan_nan_plain(a)
    code = _scan_dtype(a, "copy_scan_nan")
    m, n = a.shape
    first = torch.empty((), dtype=torch.int32, device=a.device)
    if _unit_columns(a):
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        src, dst, lds = a, out, (a.stride(0) if m > 1 else n)
    else:
        out = a.clone(memory_format=torch.contiguous_format)
        src, dst, lds = out, None, n
    if out.numel() == 0:
        return out, first.zero_()
    build()
    aligned = src.data_ptr() % 16 == 0 and (dst is None or dst.data_ptr() % 16 == 0)
    g = scan_plan(m, n, a.dtype, lds, aligned, dst is not None)
    with torch.cuda.device(a.device):
        rc = _lib.slate_copy_scan_nan(code, src.data_ptr(),
                                      None if dst is None else dst.data_ptr(),
                                      g["rows"], g["len"], g["lds"], g["ldd"], g["vw"],
                                      n, g["blocks"], first.data_ptr(), _stream(a))
    if rc != 0:
        raise SlateError(f"copy_scan_nan kernel launch failed: cudaError {rc}")
    LAUNCHES["copy_scan_nan"] += 1
    return out, first


def guard_lost_nan(plu: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The NaN guard on the 2-D factor ``plu`` (unit column stride), in place:
    where ``first`` (the 0-d int32 of :func:`copy_scan_nan`) is set and ``plu``
    holds no NaN, every row of its columns from ``first`` - 1 on becomes NaN;
    :func:`guard_lost_nan_plain`'s result, bit for bit.  On the card two
    launches queued on the current stream; where ``first`` is 0 every block
    returns at once.  No host sync."""
    if not plu.is_cuda:
        return guard_lost_nan_plain(plu, first)
    code = _scan_dtype(plu, "guard_lost_nan")
    if not _unit_columns(plu):
        raise SlateError(f"guard_lost_nan: needs unit column stride, got strides "
                         f"{tuple(plu.stride())}")
    if first.dtype != torch.int32 or first.numel() != 1 or first.device != plu.device:
        raise SlateError("guard_lost_nan: expects one int32 index on the factor's "
                         f"device, got {first.dtype} of shape {tuple(first.shape)} on "
                         f"{first.device}")
    m, n = plu.shape
    if plu.numel() == 0:
        return plu
    build()
    lda = plu.stride(0) if m > 1 else n
    g = scan_plan(m, n, plu.dtype, lda, plu.data_ptr() % 16 == 0, False)
    blocks = min(g["blocks"], _sm_count(plu.device) * _GUARD_BLOCKS_PER_SM)
    kept = torch.empty((), dtype=torch.int32, device=plu.device)
    with torch.cuda.device(plu.device):
        rc = _lib.slate_guard_lost_nan(code, plu.data_ptr(), lda, m, n, g["rows"],
                                       g["len"], g["lds"], g["vw"], blocks,
                                       first.data_ptr(), kept.data_ptr(), _stream(plu))
    if rc != 0:
        raise SlateError(f"guard_lost_nan kernel launch failed: cudaError {rc}")
    LAUNCHES["guard_lost_nan"] += 1
    return plu


def getrf_panel(panel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The library's partially pivoted LU of a 2-D ``panel``: ``(LU, ipiv)`` as
    ``torch.linalg.lu_factor_ex`` gives them (LU column-major, ipiv 1-based
    int32 on the panel's device); the panel is left as it was.  On the card,
    one cuSOLVER getrf of a column-major copy, queued on the current stream:
    no host sync and no process-wide setting.  A CPU tensor takes
    ``torch.linalg.lu_factor_ex``."""
    if not panel.is_cuda:
        lu, piv, _ = torch.linalg.lu_factor_ex(panel)
        return lu, piv
    code = _GETRF_DTYPES.get(panel.dtype)
    if code is None or panel.ndim != 2:
        raise SlateError(f"getrf_panel: expects a 2-D float or complex matrix, got "
                         f"{panel.dtype} of shape {tuple(panel.shape)}")
    m, n = panel.shape
    if m >= 2**31 or n >= 2**31:
        raise SlateError(f"getrf_panel: a {m} x {n} panel exceeds cuSOLVER's 32-bit "
                         "getrf")
    # a column-major copy, leading dimension m
    lu = torch.empty((n, m), dtype=panel.dtype, device=panel.device).mT.copy_(panel)
    ipiv = torch.empty(min(m, n), dtype=torch.int32, device=panel.device)
    info = torch.empty(1, dtype=torch.int32, device=panel.device)
    if lu.numel() == 0:
        return lu, ipiv
    build()
    lda = max(m, 1)
    with torch.cuda.device(panel.device):
        lwork = ctypes.c_int(0)
        rc = _lib.slate_getrf_lwork(code, m, n, lu.data_ptr(), lda, ctypes.byref(lwork))
        if rc == 0:
            work = torch.empty(max(lwork.value, 1), dtype=panel.dtype,
                               device=panel.device)
            rc = _lib.slate_getrf(code, m, n, lu.data_ptr(), lda, work.data_ptr(),
                                  ipiv.data_ptr(), info.data_ptr(), _stream(panel))
    if rc != 0:
        raise SlateError(f"getrf_panel: cuSOLVER getrf of a {m} x {n} {panel.dtype} "
                         f"panel failed: cusolverStatus {rc}")
    LAUNCHES["getrf_panel"] += 1
    return lu, ipiv
