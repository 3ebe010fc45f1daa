"""Streaming norm reductions: the CUDA kernels of ``csrc/norms.cu`` and their plain
PyTorch versions.

These replace the JAX package's two Pallas TPU kernels
(``slate_tpu/ops/pallas_norms.py``): ``col_reduce`` (``pl.pallas_call`` at :202) and
``row_sums`` (at :243).  Each wrapper takes a 2-D real f32/f64 tensor with unit
column stride (any row stride), applies one of five triangle masks and the
unit-diagonal fill in registers, and reads the matrix once.  Bound on an H100 SXM:
the bytes, ``m·n·itemsize / 3.35 TB/s`` (about 0.32 ms at 16384² f32); see the note
at the top of ``csrc/norms.cu`` for what the design does about it.

Routing: a CPU tensor takes the plain version (that is what the CPU tests check); a
CUDA tensor launches the kernel or raises — there is no fallback.  The kernels are
built with ``nvcc`` for ``sm_90a`` into ``slate_tpu_torch/_build/`` on first use,
rebuilt when the source changes, and loaded with ``ctypes``.  ``LAUNCHES`` counts
kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

import torch

from ..core.exceptions import SlateError

# mask modes (the values of pallas_norms._MODE_*)
_MODE_GE = 0             # no mask
_MODE_LOWER = 1          # keep r >= c
_MODE_UPPER = 2          # keep r <= c
_MODE_LOWER_STRICT = 3   # keep r > c
_MODE_UPPER_STRICT = 4   # keep r < c
_MODES = (_MODE_GE, _MODE_LOWER, _MODE_UPPER, _MODE_LOWER_STRICT, _MODE_UPPER_STRICT)

_OPS = {"sum": 0, "max": 1, "sumsq": 2}

# launch geometry (must match csrc/norms.cu)
_COL_TILE = 32          # columns per col_reduce block
_ROW_LANES = 8          # row lanes per col_reduce block
_ROWS_PER_BLOCK = 8     # rows (one warp each) per row_sums block
H100_SMS = 132          # H100 SXM streaming multiprocessors (kernel_plan's default)
_BLOCKS_PER_SM = 32     # blocks wanted per SM and launch: several waves of 6-8 blocks
                        # per SM, so a partly filled last wave costs little
_MIN_STRIP = 256        # fewest rows (col) / columns (row) one split walks
_MAX_SPLITS = 65535     # gridDim.y limit

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate

#: kernel launches per wrapper (a launch for a comparison counts too: callers
#: that need main-path counts reset these to 0 around the path)
LAUNCHES: Dict[str, int] = {"col_reduce": 0, "row_sums": 0}

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "norms.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "_build")
_lib = None
_lib_lock = threading.Lock()
_sm_counts: Dict[int, int] = {}     # CUDA device index -> multiprocessor count
BUILD_LOG = ""


def _ceil_div(x: int, d: int) -> int:
    return -(-x // d)


def _sm_count(device: torch.device) -> int:
    """Multiprocessor count of a CUDA device, read once per device."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def _launch(m: int, n: int, kind: str,
            sms: int) -> Tuple[Tuple[int, int], Tuple[int, ...], int]:
    """Launch geometry of ``kind`` ('col' | 'row') at (m, n) on a card with
    ``sms`` multiprocessors: the ONE source of truth for the wrappers and
    :func:`kernel_plan`.

    Returns (grid, block, per): ``per`` rows (col) or columns (row) each split of
    the reduced dimension covers; ``grid[1]`` is the split count."""
    if kind == "col":
        tiles, extent, quantum = _ceil_div(n, _COL_TILE), m, _ROW_LANES
        block = (_COL_TILE, _ROW_LANES)
    elif kind == "row":
        tiles, extent, quantum = _ceil_div(m, _ROWS_PER_BLOCK), n, 32
        block = (32 * _ROWS_PER_BLOCK,)
    else:
        raise ValueError(f"kind must be 'col' or 'row', got {kind!r}")
    splits = _ceil_div(_BLOCKS_PER_SM * sms, max(tiles, 1))
    splits = max(1, min(splits, _ceil_div(extent, _MIN_STRIP), _MAX_SPLITS))
    per = max(quantum, _ceil_div(_ceil_div(extent, splits), quantum) * quantum)
    splits = max(1, _ceil_div(extent, per))
    return (tiles, splits), block, per


def kernel_plan(m: int, n: int, dtype=torch.float32, kind: str = "col",
                sms: int = H100_SMS) -> dict:
    """Launch plan of the kernel at (m, n) on a card with ``sms``
    multiprocessors, from the same helper the wrappers launch with: grid, block, the per-split extent, the partial's shape, the
    bytes model (``bytes_in`` = m·n·itemsize: no padding, each element read
    once; ``bytes_out`` the partial the kernel writes), ``single_pass`` (the
    splits tile the reduced dimension exactly once and the blocks cover the
    kept dimension) and ``bound_ms``, the least time an H100 SXM needs to read
    the matrix once and write the length-n (col) or length-m (row) result."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    grid, block, per = _launch(m, n, kind, sms)
    extent, kept, tile = (m, n, _COL_TILE) if kind == "col" else (n, m, _ROWS_PER_BLOCK)
    splits = grid[1]
    bytes_in = m * n * itemsize
    covered = sum(max(0, min(per, extent - s * per)) for s in range(splits))
    return {
        "grid": grid,
        "block": block,
        "split_extent": per,
        "out_shape": (splits, kept),
        "bytes_in": bytes_in,
        "bytes_out": splits * kept * itemsize,
        "single_pass": (covered == extent and per * (splits - 1) < max(extent, 1)
                        and (grid[0] - 1) * tile < max(kept, 1) <= grid[0] * tile),
        "bound_ms": (bytes_in + kept * itemsize) / HBM_BYTES_PER_S * 1e3,
    }


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------


def _masked_abs_plain(a: torch.Tensor, mode: int, unit_diag: bool) -> torch.Tensor:
    x = a.abs()
    if mode == _MODE_LOWER:
        x = torch.tril(x)
    elif mode == _MODE_UPPER:
        x = torch.triu(x)
    elif mode == _MODE_LOWER_STRICT:
        x = torch.tril(x, -1)
    elif mode == _MODE_UPPER_STRICT:
        x = torch.triu(x, 1)
    elif mode != _MODE_GE:
        raise ValueError(f"unknown mask mode {mode}")
    if unit_diag:
        torch.diagonal(x).fill_(1)    # x is a new tensor (abs, tril, triu)
    return x


def col_reduce_plain(a: torch.Tensor, mode: int = _MODE_GE, unit_diag: bool = False,
                     op: str = "sum") -> torch.Tensor:
    """Per-column reduction of the masked |a| (plain PyTorch): op='sum' gives
    one-norm partials, 'max' column maxes, 'sumsq' sums of |a|². Length n."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    x = _masked_abs_plain(a, mode, unit_diag)
    if op == "max":
        if x.shape[0] == 0:
            return torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        return torch.amax(x, dim=0)
    if op == "sumsq":
        x = x * x
    return torch.sum(x, dim=0)


def row_sums_plain(a: torch.Tensor, mode: int = _MODE_GE,
                   unit_diag: bool = False) -> torch.Tensor:
    """Per-row sums of the masked |a| (plain PyTorch). Length m."""
    return torch.sum(_masked_abs_plain(a, mode, unit_diag), dim=1)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise SlateError("nvcc not found: the CUDA norm kernels cannot be built")


def build() -> str:
    """Compile ``csrc/norms.cu`` for sm_90a (once per source hash) and load it.
    Returns the library path.  Raises :class:`SlateError` if nvcc is missing
    or fails.  Safe to call from several threads or processes."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib._name
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        path = os.path.join(_BUILD_DIR, f"libslate_norms_{digest}.so")
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                   "-o", tmp, _SRC]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise SlateError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("slate_col_reduce_f32", "slate_col_reduce_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [p, i64, i64, i64, i32, i32, i32, i64, i32, p, p]
            fn.restype = i32
        for name in ("slate_row_sums_f32", "slate_row_sums_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [p, i64, i64, i64, i32, i32, i64, i32, p, p]
            fn.restype = i32
        _lib = lib
        return path


def _check_input(a: torch.Tensor, mode: int, what: str) -> str:
    if a.ndim != 2:
        raise SlateError(f"{what}: expects a 2-D tensor, got {a.ndim}-D")
    if a.dtype not in (torch.float32, torch.float64):
        raise SlateError(f"{what}: the CUDA kernel takes float32/float64, got {a.dtype}")
    if a.shape[1] > 1 and a.stride(1) != 1:
        raise SlateError(f"{what}: the CUDA kernel needs unit column stride, "
                         f"got strides {tuple(a.stride())}")
    if mode not in _MODES:
        raise ValueError(f"unknown mask mode {mode}")
    return "f32" if a.dtype == torch.float32 else "f64"


def _run(fn, a: torch.Tensor, *args) -> None:
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), *args, stream)
    if rc != 0:
        raise SlateError(f"CUDA norm kernel launch failed: cudaError {rc}")


def col_reduce(a: torch.Tensor, mode: int = _MODE_GE, unit_diag: bool = False,
               op: str = "sum") -> torch.Tensor:
    """Per-column reduction of the masked |a| — the port of
    ``pallas_norms.col_reduce`` (slate_tpu/ops/pallas_norms.py:159-211).
    Bound: bytes, m·n·itemsize / 3.35 TB/s.  Length-n result in a's dtype."""
    if not a.is_cuda:
        return col_reduce_plain(a, mode, unit_diag, op)
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    suffix = _check_input(a, mode, "col_reduce")
    m, n = a.shape
    if m == 0 or n == 0:
        return torch.zeros(n, dtype=a.dtype, device=a.device)
    build()
    grid, _, per = _launch(m, n, "col", _sm_count(a.device))
    part = torch.empty((grid[1], n), dtype=a.dtype, device=a.device)
    _run(getattr(_lib, f"slate_col_reduce_{suffix}"), a, m, n, a.stride(0), mode,
         int(bool(unit_diag)), _OPS[op], per, grid[1], part.data_ptr())
    LAUNCHES["col_reduce"] += 1
    if grid[1] == 1:
        return part[0]
    return torch.amax(part, dim=0) if op == "max" else torch.sum(part, dim=0)


def row_sums(a: torch.Tensor, mode: int = _MODE_GE,
             unit_diag: bool = False) -> torch.Tensor:
    """Per-row sums of the masked |a| — the port of ``pallas_norms.row_sums``
    (slate_tpu/ops/pallas_norms.py:214-251).  Bound: bytes, m·n·itemsize /
    3.35 TB/s.  Length-m result in a's dtype."""
    if not a.is_cuda:
        return row_sums_plain(a, mode, unit_diag)
    suffix = _check_input(a, mode, "row_sums")
    m, n = a.shape
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=a.dtype, device=a.device)
    build()
    grid, _, per = _launch(m, n, "row", _sm_count(a.device))
    part = torch.empty((grid[1], m), dtype=a.dtype, device=a.device)
    _run(getattr(_lib, f"slate_row_sums_{suffix}"), a, m, n, a.stride(0), mode,
         int(bool(unit_diag)), per, grid[1], part.data_ptr())
    LAUNCHES["row_sums"] += 1
    return part[0] if grid[1] == 1 else torch.sum(part, dim=0)


def genorm(a: torch.Tensor, which: str, mode: int = _MODE_GE,
           unit_diag: bool = False) -> torch.Tensor:
    """Full norm via the streaming reductions (general or triangle-masked).
    which: max | one | inf | fro.  0-d result."""
    if which == "max":
        return torch.amax(col_reduce(a, mode, unit_diag, op="max"))
    if which == "one":
        return torch.amax(col_reduce(a, mode, unit_diag, op="sum"))
    if which == "inf":
        return torch.amax(row_sums(a, mode, unit_diag))
    if which == "fro":
        return torch.sqrt(torch.sum(col_reduce(a, mode, unit_diag, op="sumsq")))
    raise ValueError(f"unknown norm '{which}'")


def col_norms_max(a: torch.Tensor) -> torch.Tensor:
    """colNorms(Max) — vector of column max-norms (src/colNorms.cc)."""
    return col_reduce(a, op="max")
