"""Row pivots of the blocked LU on the card, and its panel LU: the CUDA code of
``csrc/pivots.cu`` and its plain PyTorch versions.

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

Bounds on an H100 SXM: :func:`pivot_moves` is latency (w dependent swaps by one
thread, ~15 us at w = 512); :func:`move_rows` the bytes of the moved rows, read once
and written once, ``2 · rows · ncols · itemsize / 3.35 TB/s`` (0.24 ms for 1024 rows
of 49152 f64).  See the note at the top of ``csrc/pivots.cu``.

Routing: a CPU tensor takes the plain version (what the CPU tests check); a CUDA
tensor launches the kernel or raises — there is no fallback.  The library is built
with ``nvcc`` for ``sm_90a``, linked with the toolkit's cuSOLVER, into
``slate_tpu_torch/_build/`` on first use (rebuilt when the source changes) and
loaded with ``ctypes``.  ``LAUNCHES`` counts launches (a getrf call counts one).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Tuple

import torch

from ..core.exceptions import SlateError
from .cuda_norms import HBM_BYTES_PER_S, compile_library

#: kernel launches per wrapper (a launch for a comparison counts too)
LAUNCHES: Dict[str, int] = {"pivot_moves": 0, "move_rows": 0, "getrf_panel": 0}

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
        for fn in (lib.slate_pivot_moves, lib.slate_move_rows, lib.slate_getrf_lwork,
                   lib.slate_getrf):
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
