"""ctypes bindings for the native host runtime (``native/slate_rt.cpp``) and their
plain Python versions.

Reference analogue: the reference's C++ runtime layer — block-cyclic tile maps
(func.hh), the tile directory (MatrixStorage.hh), the fixed-block memory pool
(src/core/Memory.cc) and trace capture (src/auxiliary/Trace.cc).  The device
path is PyTorch and the CUDA kernels; this is the *host* side: integer-heavy
owner-map and plan computation, workspace accounting and low-overhead event
capture.

Build: the first native call compiles ``native/slate_rt.cpp`` (read in place,
never written) with ``g++ -O3 -std=c++17 -fPIC -shared`` into
``slate_tpu_torch/_build/libslate_rt_<digest of the source>.so``, under an
``fcntl`` lock so that several processes build it once, and moves the result
into place with ``os.replace``.  Nothing is built at import.

No silent fallback: a failed build or ``dlopen`` raises :class:`SlateError`
with the compiler's output.  The plain Python versions run only when asked —
``SLATE_TPU_NATIVE=0`` in the environment, or inside :func:`use_python` —
and :func:`backend` says which is in use.

Every buffer the library writes is allocated here with the exact dtype, size
and C-contiguity the C side expects, and checked before each call; the
arguments that would fault the C code (a zero grid dimension, a negative pool
size) are refused here.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from .core.exceptions import SlateError
from .core.types import GridOrder

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "slate_rt.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_I32 = (-2**31, 2**31 - 1)
_I64 = (-2**63, 2**63 - 1)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_python_depth = 0
#: the compiler's output of the last build this process ran
BUILD_LOG = ""


def _order_code(order) -> int:
    return 0 if GridOrder.from_string(order) == GridOrder.Col else 1


# ---------------------------------------------------------------------------
# build and load


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise SlateError(f"the native runtime needs a C++ compiler: {cxx!r} not found "
                         "(set SLATE_TPU_NATIVE=0 for the Python versions)")
    return path


def compile_once(command: List[str], path: str) -> Tuple[str, str]:
    """Build ``path`` with ``command + ["-o", <temporary file>]`` unless it
    exists: under a file lock in its directory (named after the library, so
    several processes build it once), moved into place with ``os.replace``.
    Returns (path, the compiler's output, empty when nothing was built);
    raises :class:`SlateError` with that output when the compile fails."""
    if os.path.exists(path):
        return path, ""
    build_dir = os.path.dirname(path)
    os.makedirs(build_dir, exist_ok=True)
    lock_name = "." + os.path.basename(path).rsplit("_", 1)[0] + ".lock"
    with open(os.path.join(build_dir, lock_name), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):        # another process built it meanwhile
                return path, ""
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([*command, "-o", tmp], capture_output=True, text=True,
                                  timeout=300)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise SlateError(f"{os.path.basename(path)} build failed "
                                 f"({proc.returncode}):\n{log}")
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path, log


def build(src: Optional[str] = None, build_dir: Optional[str] = None) -> str:
    """Compile ``src`` (default ``native/slate_rt.cpp``) into
    ``build_dir/libslate_rt_<digest>.so`` unless that file exists, and return
    its path.  Writes only under ``build_dir`` (default
    ``slate_tpu_torch/_build``).  Raises :class:`SlateError` with the
    compiler's output when the compile fails."""
    global BUILD_LOG
    src = src or _SRC
    build_dir = build_dir or _BUILD_DIR
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError as e:
        raise SlateError(f"native runtime source {src} unreadable: {e}") from e
    path = os.path.join(build_dir, f"libslate_rt_{digest}.so")
    if os.path.exists(path):
        return path
    path, log = compile_once([_cxx(), *_CXXFLAGS, src], path)
    BUILD_LOG = log or BUILD_LOG
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes and restype of every symbol ``slate_rt.cpp`` exports."""
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    i32p, i64p = ctypes.POINTER(i32), ctypes.POINTER(i64)
    sig = {
        "srt_owner_map": ([i64, i64, i32, i32, i32, i32p], None),
        "srt_local_tiles": ([i64, i64, i32, i32, i32, i32, i64p], i64),
        "srt_redist_plan": ([i64, i64, i32, i32, i32, i32, i32, i32, i32p, i32p], i64),
        "srt_pool_new": ([i64, i64], vp),
        "srt_pool_delete": ([vp], None),
        "srt_pool_alloc": ([vp], i64),
        "srt_pool_free": ([vp, i64], i32),
        "srt_pool_in_use": ([vp], i64),
        "srt_pool_capacity": ([vp], i64),
        "srt_pool_peak": ([vp], i64),
        "srt_trace_enable": ([i32], None),
        "srt_trace_begin": ([ctypes.c_char_p], None),
        "srt_trace_end": ([], None),
        "srt_trace_count": ([], i64),
        "srt_trace_clear": ([], None),
        "srt_trace_dump": ([ctypes.c_char_p], i32),
    }
    for name, (args, res) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def load(path: str) -> ctypes.CDLL:
    """``dlopen`` a built runtime with every symbol declared; raises
    :class:`SlateError` when the file does not load."""
    try:
        return _declare(ctypes.CDLL(path))
    except (OSError, AttributeError) as e:
        raise SlateError(f"native runtime {path} did not load: {e}") from e


def _native() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when the Python versions were asked for.
    Builds and loads it on the first call."""
    global _lib
    if _python_depth > 0 or os.environ.get("SLATE_TPU_NATIVE", "1") == "0":
        return None
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = load(build())
    return _lib


def backend() -> str:
    """'native' when calls go to the compiled library, 'python' when the
    Python versions were asked for (the first call builds the library)."""
    return "native" if _native() is not None else "python"


@contextlib.contextmanager
def use_python():
    """Run the Python versions inside this block (process-wide, nests)."""
    global _python_depth
    _python_depth += 1
    try:
        yield
    finally:
        _python_depth -= 1


# ---------------------------------------------------------------------------
# argument and buffer checks (a wrong one would fault the C code)


def _int(v, what: str, lo: int, hi: int = _I32[1]) -> int:
    v = int(v)
    if not lo <= v <= hi:
        raise SlateError(f"{what} = {v} outside [{lo}, {hi}]")
    return v


def _grid_args(mt, nt, p, q) -> Tuple[int, int, int, int]:
    return (_int(mt, "mt", 0, _I64[1]), _int(nt, "nt", 0, _I64[1]),
            _int(p, "p", 1), _int(q, "q", 1))


def _out(buf: np.ndarray, dtype, size: int, what: str):
    """``buf``'s address as a ctypes pointer after checking it is what the C
    side writes: ``size`` elements of ``dtype``, C-contiguous and writable."""
    if (buf.dtype != np.dtype(dtype) or buf.size != size
            or not buf.flags.c_contiguous or not buf.flags.writeable):
        raise SlateError(f"{what}: buffer {buf.dtype} {buf.shape} is not {size} "
                         f"C-contiguous {np.dtype(dtype)}")
    ctype = ctypes.c_int32 if np.dtype(dtype) == np.int32 else ctypes.c_int64
    return buf.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# block-cyclic maps


def owner_map(mt: int, nt: int, p: int, q: int,
              order=GridOrder.Col) -> np.ndarray:
    """Full (mt, nt) int32 tile->rank map for a 2D block-cyclic grid
    (func.hh:178-186 applied over the whole tile space)."""
    mt, nt, p, q = _grid_args(mt, nt, p, q)
    code = _order_code(order)
    lib = _native()
    if lib is None:
        i = np.arange(mt)[:, None] % p
        j = np.arange(nt)[None, :] % q
        return (i + j * p if code == 0 else i * q + j).astype(np.int32)
    out = np.empty((mt, nt), dtype=np.int32)
    if mt * nt:
        lib.srt_owner_map(mt, nt, p, q, code,
                          _out(out, np.int32, mt * nt, "srt_owner_map"))
    return out


def local_tiles(mt: int, nt: int, p: int, q: int, rank: int,
                order=GridOrder.Col) -> np.ndarray:
    """(k, 2) int64 array of the (i, j) tile indices owned by ``rank`` in row-major
    order (the reference's per-rank tile-directory iteration, MatrixStorage.hh)."""
    mt, nt, p, q = _grid_args(mt, nt, p, q)
    rank = _int(rank, "rank", _I32[0])
    code = _order_code(order)
    lib = _native()
    if lib is None:
        ii, jj = np.nonzero(owner_map(mt, nt, p, q, order) == rank)
        return np.stack([ii, jj], axis=1).astype(np.int64)
    count = int(lib.srt_local_tiles(mt, nt, p, q, code, rank, None))
    out = np.empty((count, 2), dtype=np.int64)
    if count:
        lib.srt_local_tiles(mt, nt, p, q, code, rank,
                            _out(out, np.int64, 2 * count, "srt_local_tiles"))
    return out


def redist_plan(mt: int, nt: int,
                src_grid: Tuple[int, int], dst_grid: Tuple[int, int],
                src_order=GridOrder.Col, dst_order=GridOrder.Col):
    """Per-tile (src_rank, dst_rank) maps between two block-cyclic layouts and the
    count of tiles that move (src/redistribute.cc's send/recv planning loop).

    Returns (src_map, dst_map, n_moved)."""
    mt, nt, p1, q1 = _grid_args(mt, nt, *src_grid)
    _, _, p2, q2 = _grid_args(mt, nt, *dst_grid)
    lib = _native()
    if lib is None:
        src = owner_map(mt, nt, p1, q1, src_order)
        dst = owner_map(mt, nt, p2, q2, dst_order)
        return src, dst, int(np.count_nonzero(src != dst))
    src = np.empty((mt, nt), dtype=np.int32)
    dst = np.empty((mt, nt), dtype=np.int32)
    if not mt * nt:
        return src, dst, 0
    moved = lib.srt_redist_plan(
        mt, nt, p1, q1, _order_code(src_order), p2, q2, _order_code(dst_order),
        _out(src, np.int32, mt * nt, "srt_redist_plan"),
        _out(dst, np.int32, mt * nt, "srt_redist_plan"))
    return src, dst, int(moved)


# ---------------------------------------------------------------------------
# memory-pool accounting


class MemoryPool:
    """Fixed-block workspace accounting (src/core/Memory.cc free list).

    The caching allocator owns the device memory; this tracks tile-granular
    workspace budget so drivers can reason about fit and spill (the
    reference's reserveDeviceWorkspace planning).  alloc() returns a block id
    or -1 when exhausted; free() returns False on a double free or an unknown
    id (the Debug.cc leak check).  The native pool's handle lives until
    :meth:`close` (or collection); a closed pool raises."""

    def __init__(self, block_bytes: int, nblocks: int):
        self.block_bytes = _int(block_bytes, "block_bytes", 0, _I64[1])
        nblocks = _int(nblocks, "nblocks", 0, 2**40)
        self._lib = _native()
        self._handle = None
        self._closed = False
        if self._lib is not None:
            self._handle = self._lib.srt_pool_new(self.block_bytes, nblocks)
            if not self._handle:
                raise SlateError("srt_pool_new returned a null pool")
        else:
            self._free: List[int] = list(range(nblocks - 1, -1, -1))
            self._used = set()
            self._peak = 0
            self._cap = nblocks

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "python"

    def _live(self):
        if self._closed:
            raise SlateError("MemoryPool is closed")
        return self._handle

    def alloc(self) -> int:
        h = self._live()
        if h is not None:
            return int(self._lib.srt_pool_alloc(h))
        if not self._free:
            return -1
        bid = self._free.pop()
        self._used.add(bid)
        self._peak = max(self._peak, len(self._used))
        return bid

    def free(self, block_id: int) -> bool:
        h = self._live()
        block_id = int(block_id)
        if h is not None:
            if not _I64[0] <= block_id <= _I64[1]:
                return False
            return int(self._lib.srt_pool_free(h, block_id)) == 0
        if block_id not in self._used:
            return False
        self._used.discard(block_id)
        self._free.append(block_id)
        return True

    @property
    def in_use(self) -> int:
        h = self._live()
        return int(self._lib.srt_pool_in_use(h)) if h is not None else len(self._used)

    @property
    def capacity(self) -> int:
        h = self._live()
        return int(self._lib.srt_pool_capacity(h)) if h is not None else self._cap

    @property
    def peak(self) -> int:
        h = self._live()
        return int(self._lib.srt_pool_peak(h)) if h is not None else self._peak

    def close(self) -> None:
        """Release the native pool (idempotent)."""
        h, self._handle = getattr(self, "_handle", None), None
        self._closed = True
        # the module's library reference is None at interpreter shutdown
        if h is not None and globals().get("_lib") is not None:
            self._lib.srt_pool_delete(h)

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# native trace capture (begin/end keep a per-thread open stack in the library)

_armed = False


def trace_enable(on: bool = True) -> None:
    """Arm or disarm the native capture buffer.  Disarming never builds the
    library: one that was never loaded has nothing armed."""
    global _armed
    lib = _native() if on else _lib
    if lib is not None:
        lib.srt_trace_enable(1 if on else 0)
    _armed = bool(on) and lib is not None


def trace_begin(name: str) -> bool:
    """Open a native region; True when one was opened (the capture is armed),
    and then exactly one :func:`trace_end` must close it."""
    lib = _native()
    if lib is None or not _armed:
        return False
    lib.srt_trace_begin(str(name).encode())
    return True


def trace_end() -> None:
    lib = _native()
    if lib is not None:
        lib.srt_trace_end()


def trace_count() -> int:
    lib = _native()
    return int(lib.srt_trace_count()) if lib is not None else 0


def trace_clear() -> None:
    lib = _native()
    if lib is not None:
        lib.srt_trace_clear()


def trace_dump(path: str) -> bool:
    """Write captured events as chrome://tracing JSON (Trace.cc:330-448's SVG
    writer, modernized).  False when the Python versions are in use or the
    file cannot be written."""
    lib = _native()
    if lib is None:
        return False
    return int(lib.srt_trace_dump(os.fsencode(path))) == 0
