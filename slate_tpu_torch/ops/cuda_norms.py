"""Streaming norm reductions: the CUDA kernels of ``csrc/norms.cu`` and their plain
PyTorch versions.

These replace the JAX package's two Pallas TPU kernels
(``slate_tpu/ops/pallas_norms.py``): ``col_reduce`` (``pl.pallas_call`` at :202) and
``row_sums`` (at :243).  Each wrapper takes a 2-D real f32/f64 tensor with unit
column stride (any row stride), applies one of five triangle masks and the
unit-diagonal fill in registers, reads the matrix once with 16-byte loads where
the tensor's base and row pitch are 16-byte aligned (1-element loads otherwise),
and returns the result from one launch: the splits of the reduced dimension are
folded inside it.  Bound on an H100 SXM: the bytes, ``m·n·itemsize / 3.35 TB/s``
(about 0.32 ms at 16384² f32); see the note at the top of ``csrc/norms.cu`` for
what the design does about it.

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
from typing import Dict, NamedTuple, Optional, Set, Tuple

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
_THREADS = 256          # threads per block, both kernels
_WARPS = _THREADS // 32  # col_reduce: row lanes per block; row_sums: up to 8 rows
_UNROLL = 8             # loads in flight per thread
_LOAD_BYTES = 16        # the vector load
H100_SMS = 132          # H100 SXM streaming multiprocessors (kernel_plan's default)
_BLOCKS_PER_SM = 32     # blocks wanted per SM and launch: several waves of 4-8 blocks
                        # per SM, so a partly filled last wave costs little
_MIN_STRIP = 256        # fewest rows (col) / columns (row) one split walks
_MAX_SPLITS = 65535     # gridDim.y limit

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate

#: kernel launches per wrapper (a launch for a comparison counts too: callers
#: that need main-path counts reset these to 0 around the path)
LAUNCHES: Dict[str, int] = {"col_reduce": 0, "row_sums": 0}
#: the configuration of every launch, (wrapper, (m, n), dtype, row stride,
#: 16-byte aligned base, mode, unit_diag[, op code]): a check can hold each
#: kernel at the shapes and layouts a run gave it
LAUNCHED: Set[tuple] = set()

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "norms.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "_build")
_lib = None
_lib_lock = threading.Lock()
_sm_counts: Dict[int, int] = {}     # CUDA device index -> multiprocessor count
# (device index, stream) -> the int32 tile counters of the in-launch fold; the
# kernels leave them at 0, so one zero fill per stream serves every later call
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
#: the compiler's output of each library built in this process, by its stem
BUILD_LOGS: Dict[str, str] = {}


def _ceil_div(x: int, d: int) -> int:
    return -(-x // d)


def _sm_count(device: torch.device) -> int:
    """Multiprocessor count of a CUDA device, read once per device."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def _aligned(ptr: int, lda: int, itemsize: int) -> bool:
    """Whether every row of a matrix at byte address ``ptr`` with row stride
    ``lda`` (elements) starts on a 16-byte boundary: what the vector loads need."""
    return ptr % _LOAD_BYTES == 0 and (lda * itemsize) % _LOAD_BYTES == 0


def _vec_width(itemsize: int, aligned: bool) -> int:
    """Elements per load: one 16-byte load (4 f32, 2 f64) where the rows are
    16-byte aligned, else 1."""
    return _LOAD_BYTES // itemsize if aligned else 1


class _Geometry(NamedTuple):
    grid: Tuple[int, int]    # (tiles of the kept dimension, splits of the reduced one)
    block: Tuple[int]
    tile: int                # columns (col) or rows (row) one block keeps
    vec: int                 # elements per load
    wpr: int                 # row_sums: warps that share a row (col_reduce: 1)
    per: int                 # rows (col) or columns (row) one split covers
    fold: str                # "none" (one split) or "last_block"


def _launch(m: int, n: int, kind: str, sms: int, vec: int) -> _Geometry:
    """Launch geometry of ``kind`` ('col' | 'row') at (m, n) with ``vec``
    elements per load on a card with ``sms`` multiprocessors: the ONE source of
    truth for the wrappers and :func:`kernel_plan`.

    A col_reduce block is one warp of ``vec``-column groups wide and has 8 row
    lanes.  A row_sums block gives each of its rows a team of ``wpr`` warps:
    the fewest (a power of 2, at most 8) whose 8 loads in flight per thread
    span the row, so a long row is one block's (4 KB contiguous per block load
    step) and short rows share a block 8 to 1.  The reduced dimension is split
    until there are about ``_BLOCKS_PER_SM`` blocks per SM, at a multiple of the
    8 row lanes (col) or of one load step of a row's team, 32 x ``wpr`` x ``vec``
    columns (row), and the last block of each tile folds the splits inside the
    launch."""
    wpr = 1
    if kind == "col":
        tile = 32 * vec
        tiles, extent, quantum = _ceil_div(n, tile), m, _WARPS
    elif kind == "row":
        while wpr < _WARPS and wpr * 32 * vec * _UNROLL < n:
            wpr *= 2
        tile = _WARPS // wpr
        tiles, extent, quantum = _ceil_div(m, tile), n, 32 * wpr * vec
    else:
        raise ValueError(f"kind must be 'col' or 'row', got {kind!r}")
    splits = _ceil_div(_BLOCKS_PER_SM * sms, max(tiles, 1))
    splits = max(1, min(splits, _ceil_div(extent, _MIN_STRIP), _MAX_SPLITS))
    per = max(quantum, _ceil_div(_ceil_div(extent, splits), quantum) * quantum)
    splits = max(1, _ceil_div(extent, per))
    return _Geometry((tiles, splits), (_THREADS,), tile, vec, wpr, per,
                     "last_block" if splits > 1 else "none")


def kernel_plan(m: int, n: int, dtype=torch.float32, kind: str = "col",
                sms: int = H100_SMS, aligned: bool = True) -> dict:
    """Launch plan of the kernel at (m, n) on a card with ``sms``
    multiprocessors, for an input whose rows are 16-byte ``aligned`` (the
    wrappers test ``data_ptr()`` and the row pitch), from the same helper the
    wrappers launch with: grid, block, the tile a block keeps, the
    ``vector_width`` (elements per load), ``warps_per_row`` (row_sums), the
    per-split extent, the ``fold`` of the splits (``"last_block"``: inside the
    launch; ``"none"``: one split), ``launches_per_call`` (1), the result's
    shape, the bytes model
    (``bytes_in`` = m·n·itemsize: no padding, each element read once;
    ``bytes_out`` the result plus the fold's scratch, the (splits, kept)
    partial and an int32 counter per tile), ``single_pass`` (the splits tile
    the reduced dimension exactly once and the blocks cover the kept
    dimension) and ``bound_ms``, the least time an H100 SXM needs to read the
    matrix once and write the length-n (col) or length-m (row) result."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    g = _launch(m, n, kind, sms, _vec_width(itemsize, aligned))
    extent, kept = (m, n) if kind == "col" else (n, m)
    tiles, splits = g.grid
    bytes_in = m * n * itemsize
    scratch = splits * kept * itemsize + tiles * 4 if splits > 1 else 0
    covered = sum(max(0, min(g.per, extent - s * g.per)) for s in range(splits))
    return {
        "grid": g.grid,
        "block": g.block,
        "tile": g.tile,
        "vector_width": g.vec,
        "warps_per_row": g.wpr,
        "split_extent": g.per,
        "fold": g.fold,
        "launches_per_call": 1,
        "out_shape": (kept,),
        "bytes_in": bytes_in,
        "bytes_out": kept * itemsize + scratch,
        "single_pass": (covered == extent and g.per * (splits - 1) < max(extent, 1)
                        and (tiles - 1) * g.tile < max(kept, 1) <= tiles * g.tile),
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
    raise SlateError("nvcc not found: the CUDA kernels cannot be built")


def compile_library(src: str, stem: str, libs=()) -> str:
    """Compile the CUDA source ``src`` for sm_90a, linked with the toolkit's
    libraries ``libs`` (names such as ``"cusolver"``), into
    ``_build/lib<stem>_<digest>.so`` (once per source and library list) and
    return the path; the compiler's output is kept in ``BUILD_LOGS[stem]``.
    Raises :class:`SlateError` if nvcc is missing or fails.  Safe to call from
    several processes: the library is written under a temporary name and
    renamed into place."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(libs).encode()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"lib{stem}_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        link = [f"-l{lib}" for lib in libs]
        if libs:
            libdir = os.path.join(os.path.dirname(os.path.dirname(nvcc)), "lib64")
            link += [f"-L{libdir}", "-Xlinker", "-rpath", "-Xlinker", libdir]
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, src, *link]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOGS[stem] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise SlateError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOGS[stem]}")
        os.replace(tmp, path)
    return path


def build() -> str:
    """Compile ``csrc/norms.cu`` for sm_90a (once per source hash) and load it.
    Returns the library path.  Raises :class:`SlateError` if nvcc is missing
    or fails.  Safe to call from several threads or processes."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib._name
        lib = ctypes.CDLL(compile_library(_SRC, "slate_norms"))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("slate_col_reduce_f32", "slate_col_reduce_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [p, i64, i64, i64, i32, i32, i32, i64, i32, i32, p, p, p, p]
            fn.restype = i32
        for name in ("slate_row_sums_f32", "slate_row_sums_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [p, i64, i64, i64, i32, i32, i64, i32, i32, i32, p, p, p, p]
            fn.restype = i32
        _lib = lib
        return lib._name


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


def is_aligned(a: torch.Tensor) -> bool:
    """Whether the kernels read ``a`` with 16-byte loads (its base and row
    pitch are 16-byte aligned); otherwise they take 1-element loads."""
    return _aligned(a.data_ptr(), a.stride(0), a.element_size())


def _counter_buffer(device: torch.device, stream: int, size: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _run(name: str, kind: str, a: torch.Tensor, mode: int, *args) -> torch.Tensor:
    """Launch ``name``'s kernel on ``a`` with the mask ``mode`` and ``args``
    (unit_diag[, op]); return the length-n (col) or length-m (row) result."""
    suffix = _check_input(a, mode, name)
    m, n = a.shape
    kept = n if kind == "col" else m
    if m == 0 or n == 0:
        return torch.zeros(kept, dtype=a.dtype, device=a.device)
    build()
    g = _launch(m, n, kind, _sm_count(a.device),
                _vec_width(a.element_size(), is_aligned(a)))
    out = torch.empty(kept, dtype=a.dtype, device=a.device)
    partial: Optional[torch.Tensor] = None
    counters: Optional[torch.Tensor] = None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if g.grid[1] > 1:
            partial = torch.empty((g.grid[1], kept), dtype=a.dtype, device=a.device)
            counters = _counter_buffer(a.device, stream, g.grid[0])
        rc = getattr(_lib, f"slate_{name}_{suffix}")(
            a.data_ptr(), m, n, a.stride(0), mode, *args, g.per, g.grid[1], g.vec,
            *((g.wpr,) if kind == "row" else ()),
            None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise SlateError(f"CUDA norm kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    LAUNCHED.add((name, (m, n), a.dtype, a.stride(0), a.data_ptr() % _LOAD_BYTES == 0,
                  mode) + args)
    return out


def col_reduce(a: torch.Tensor, mode: int = _MODE_GE, unit_diag: bool = False,
               op: str = "sum") -> torch.Tensor:
    """Per-column reduction of the masked |a| — the port of
    ``pallas_norms.col_reduce`` (slate_tpu/ops/pallas_norms.py:159-211).
    Bound: bytes, m·n·itemsize / 3.35 TB/s.  Length-n result in a's dtype."""
    if not a.is_cuda:
        return col_reduce_plain(a, mode, unit_diag, op)
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    return _run("col_reduce", "col", a, mode, int(bool(unit_diag)), _OPS[op])


def row_sums(a: torch.Tensor, mode: int = _MODE_GE,
             unit_diag: bool = False) -> torch.Tensor:
    """Per-row sums of the masked |a| — the port of ``pallas_norms.row_sums``
    (slate_tpu/ops/pallas_norms.py:214-251).  Bound: bytes, m·n·itemsize /
    3.35 TB/s.  Length-m result in a's dtype."""
    if not a.is_cuda:
        return row_sums_plain(a, mode, unit_diag)
    return _run("row_sums", "row", a, mode, int(bool(unit_diag)))


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
