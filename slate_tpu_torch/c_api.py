"""The port's C API: the build and loader of its library, and the Python bodies
its C entry points call.

``include/slate_tpu.h`` (read in place) declares 59 C entry points.
``slate_tpu_torch/csrc/slate_c_api.cpp`` defines them against that header and
forwards each one to one function of this module of the same name without its
``slate_`` prefix (``slate_dgesv`` -> :func:`dgesv`), passing its buffers as
memoryviews over the caller's memory.  The bodies view those buffers
column-major with numpy, call the port's ScaLAPACK-style skins
(:mod:`slate_tpu_torch.scalapack_api`, or :mod:`slate_tpu_torch.lapack_api`
for the subset solvers) and write the results back, so the C calls run on the
current ``slate_gridinit`` grid, or on one device without one.  Without a
grid, ``?gemm``, ``?gesv`` and ``?posv`` run on device tensors of their own:
the factors stay on the device between the factor and the solve, and results
are transposed there before they come back (the skins would bring factors
to the host and back, and return row-major results).  The library
serves a C or Fortran program (it starts an embedded interpreter) and a Python
process that loads it with :func:`load` (it takes the running interpreter's
lock).

Device: :func:`init` picks the device once, from ``SLATE_TPU_TORCH_DEVICE``
(``cuda`` unless it names another).  Without CUDA, and with no other device
named, :func:`init` raises the entry points' ``resolve_device`` error: the
embedded library prints it and returns its init code (-999); nothing runs on
the CPU unasked.

Grid: ``slate_gridinit(p, q)`` needs a process group of p·q ranks.  Under a
launcher (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the
environment) the grid joins it, so one C program started p·q times is a grid;
without one ``slate_gridinit`` returns nonzero.

A C process finds torch through ``PYTHONPATH`` (pass the ``sys.path`` of the
interpreter that has it); the library puts the checkout it was built from
first on ``sys.path`` of an interpreter it starts.

Handles (``slate_matrix_*``) own a host copy of their matrix: no array made
from a caller's buffer outlives the call that received it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import sys
import sysconfig
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import blas, lapack_api, linalg, native, scalapack_api
from .core.exceptions import SlateError
from .core.matrix import Matrix, resolve_device
from .core.types import Uplo

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
SRC = os.path.join(_PKG, "csrc", "slate_c_api.cpp")
HEADER = os.path.join(_ROOT, "include", "slate_tpu.h")
_BUILD_DIR = os.path.join(_PKG, "_build")
_CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra", "-Wno-comment"]
DEVICE_ENV = "SLATE_TPU_TORCH_DEVICE"
LIB_PREFIX = "libslate_c_api_"
#: the compiler's output of the last build this process ran
BUILD_LOG = ""

_DT = {"s": np.float32, "d": np.float64, "c": np.complex64, "z": np.complex128}
_LETTER = {np.dtype(v): k for k, v in _DT.items()}
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


# ---------------------------------------------------------------------------
# build and load


def python_flags() -> Tuple[list, list]:
    """(compile flags, link flags) for the running interpreter's headers and
    ``libpython``, from its own ``sysconfig`` (not a ``python3-config`` on
    ``PATH``, which may belong to another Python)."""
    var = sysconfig.get_config_var
    libdir = var("LIBDIR")
    return ([f"-I{var('INCLUDEPY')}"],
            [f"-L{libdir}", f"-lpython{var('LDVERSION')}", f"-Wl,-rpath,{libdir}", "-ldl"])


def build(src: Optional[str] = None, build_dir: Optional[str] = None) -> str:
    """Compile ``src`` (default ``csrc/slate_c_api.cpp``) against
    ``include/slate_tpu.h`` into ``build_dir/libslate_c_api_<digest>.so``
    unless that file exists, and return its path.  The digest covers the
    source, the header and the flags.  Writes only under ``build_dir``
    (default ``slate_tpu_torch/_build``), as :func:`native.compile_once`
    does.  Raises :class:`SlateError` with the compiler's output when the
    compile fails."""
    global BUILD_LOG
    src = src or SRC
    cflags, ldflags = python_flags()
    flags = [*_CXXFLAGS, f"-I{os.path.dirname(HEADER)}", *cflags]
    h = hashlib.sha256()
    try:
        for path in (src, HEADER):
            with open(path, "rb") as f:
                h.update(f.read())
    except OSError as e:
        raise SlateError(f"C API source unreadable: {e}") from e
    h.update(" ".join(flags + ldflags).encode())
    path = os.path.join(build_dir or _BUILD_DIR, f"{LIB_PREFIX}{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise SlateError("the C API needs a C++ compiler: "
                         f"{os.environ.get('CXX', 'g++')!r} not found")
    path, log = native.compile_once([cxx, *flags, src, *ldflags], path)
    BUILD_LOG = log or BUILD_LOG
    return path


_CTYPE = {"int": ctypes.c_int, "int64_t": ctypes.c_int64, "double": ctypes.c_double,
          "float": ctypes.c_float, "char": ctypes.c_char, "void": None,
          "const char*": ctypes.c_char_p}


def signatures(header: str = HEADER) -> Dict[str, tuple]:
    """``{name: (restype, argtypes)}`` of every declaration in ``header``:
    pointers are ``c_void_p``, ``char`` is ``c_char``."""
    with open(header) as f:
        text = re.sub(r"/\*.*?\*/", " ", f.read(), flags=re.S)
    out = {}
    for m in re.finditer(r"(const\s+char\s*\*|int64_t|int|void|double|float)\s+"
                         r"(slate_\w+)\s*\(([^;]*)\)\s*;", text):
        ret = re.sub(r"\s+", " ", m.group(1)).replace(" *", "*").strip()
        args = []
        for a in m.group(3).split(","):
            a = a.strip()
            if a and a != "void":
                args.append(ctypes.c_void_p if "*" in a else _CTYPE[a.rsplit(None, 1)[0]])
        out[m.group(2)] = (_CTYPE[ret], args)
    return out


def load(path: Optional[str] = None) -> ctypes.CDLL:
    """``dlopen`` the library (built by :func:`build` unless ``path`` is
    given) into this process with every header symbol's ``argtypes`` and
    ``restype`` declared.  The library takes the running interpreter's lock
    in each entry point, so it is loaded with ``CDLL`` (the lock is released
    around the call).  That needs an interpreter linked against a shared
    ``libpython``: with a static one the library would start a second
    interpreter, so this raises :class:`SlateError` instead."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise SlateError("the C API's in-process route needs a Python built with "
                         "--enable-shared (sysconfig Py_ENABLE_SHARED is 0); run C "
                         "programs against the library instead")
    path = path or build()
    try:
        lib = ctypes.CDLL(path)
        for name, (res, args) in signatures().items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
    except (OSError, AttributeError) as e:
        raise SlateError(f"C API library {path} did not load: {e}") from e
    return lib


def library() -> ctypes.CDLL:
    """The library loaded once into this process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load()
    return _lib


def child_env(device: Optional[str] = None) -> dict:
    """The environment for a C process linked against the library: this
    interpreter's ``sys.path`` as ``PYTHONPATH`` (so the embedded interpreter
    finds torch and numpy) and, when given, the device."""
    out = dict(os.environ)
    paths = [p for p in sys.path if p]
    if out.get("PYTHONPATH"):
        paths.append(out["PYTHONPATH"])
    out["PYTHONPATH"] = os.pathsep.join(paths)
    if device is not None:
        out[DEVICE_ENV] = str(device)
    return out


# ---------------------------------------------------------------------------
# the runtime the entry points share


class Runtime:
    """The device the C calls run on, the handle registry, and whether the
    C API started the process group (``slate_finalize`` then ends it)."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self.handles: Dict[int, np.ndarray] = {}
        self.next_handle = 1
        self.owns_group = False


_rt: Optional[Runtime] = None


def init() -> int:
    """Pick the device from ``SLATE_TPU_TORCH_DEVICE`` (default ``cuda``) once
    per process; raises when it is not available (``slate_init``)."""
    global _rt
    if _rt is None:
        _rt = Runtime(os.environ.get(DEVICE_ENV) or "cuda")
    return 0


def runtime() -> Runtime:
    init()
    return _rt


def finalize() -> None:
    """Drop the grid and the handles; end the process group if the C API
    started it, after the device has finished (``slate_finalize``)."""
    global _rt
    scalapack_api.gridexit()
    if _rt is not None:
        if _rt.device.type == "cuda":
            torch.cuda.synchronize(_rt.device)
        if _rt.owns_group:
            from .parallel import mesh

            mesh.destroy()
    _rt = None


def _skin(fn):
    """``fn`` (a ScaLAPACK- or LAPACK-style skin) on the C API's device."""
    def call(*args):
        return fn(*args, device=runtime().device)
    return call


def _p(letter: str, name: str):
    return _skin(getattr(scalapack_api, f"p{letter}{name}"))


def _mat(mem, dt, ld: int, rows: int, cols: int) -> np.ndarray:
    """The leading rows x cols block of a column-major buffer of leading
    dimension ``ld``, as a numpy view of the caller's memory."""
    flat = np.frombuffer(mem, dt)
    return flat[:ld * cols].reshape(cols, ld).T[:rows] if cols else np.empty((rows, 0), dt)


def _down(x: np.ndarray) -> torch.Tensor:
    """A view of the caller's buffer as a tensor on the C API's device (a
    copy; a column-major one is transposed on the device)."""
    return lapack_api._as(x.dtype, runtime().device, x)[0]


def _up(dst: np.ndarray, t: torch.Tensor) -> None:
    """``t`` into ``dst``, a column-major view of the caller's buffer:
    transposed on the device, so the copy to the host is a plain one."""
    torch.from_numpy(dst.T).copy_(t.mT.contiguous())


def _vec(mem, dt, n: int) -> np.ndarray:
    return np.frombuffer(mem, dt)[:n]


def _scalar(x, dt):
    """alpha / beta: a real number, or a buffer of one complex element."""
    if isinstance(x, memoryview):
        return np.frombuffer(x, dt)[0]
    return dt(x)


def _put(dst: np.ndarray, src) -> None:
    """A host result into ``dst``, a column-major view of the caller's
    buffer.  A row-major result goes through the device, where it is
    transposed: that is cheaper than numpy's strided copy on the host."""
    src = np.asarray(src, dst.dtype)
    if src.ndim < 2 or src.flags.f_contiguous:
        dst[...] = src
    else:
        _up(dst, torch.from_numpy(np.ascontiguousarray(src)).to(runtime().device))


def _put_triangle(dst: np.ndarray, kept: torch.Tensor, factor: torch.Tensor, uplo) -> None:
    """``factor``'s triangle (diagonal included) into ``dst``, the view of the
    caller's buffer that ``kept`` is a device copy of: the other triangle
    keeps ``kept``'s entries."""
    tri = torch.ones(kept.shape, dtype=torch.bool, device=kept.device)
    tri = tri.tril_() if str(uplo).lower().startswith("l") else tri.triu_()
    _up(dst, torch.where(tri, factor, kept))


# ---------------------------------------------------------------------------
# runtime and grid


def gridinit(p: int, q: int) -> int:
    """``slate_gridinit``: select a p x q grid on the C API's device; 1 (the
    reason on stderr) when no process group of p·q ranks can be had."""
    import torch.distributed as dist

    rt = runtime()
    had_group = dist.is_initialized()
    try:
        scalapack_api.gridinit(int(p), int(q), device=rt.device)
    except (ValueError, RuntimeError, SlateError) as e:   # no world of p·q ranks
        print(e, file=sys.stderr)
        return 1
    rt.owns_group = rt.owns_group or (not had_group and dist.is_initialized())
    return 0


def gridexit() -> int:
    scalapack_api.gridexit()
    return 0


# ---------------------------------------------------------------------------
# BLAS-3, solvers, eig / SVD, norms: one body per family, typed below.  The
# skins copy their operands to the device, so the bodies hand them views of
# the caller's buffers and write the results back through those views (a
# column-major operand is transposed on the device, a row-major result on the
# host).


def _gemm(t, transa, transb, m, n, k, alpha, A, lda, B, ldb, beta, C, ldc):
    """C = alpha op(A) op(B) + beta C.  With no grid on device tensors of its
    own, so C comes back column-major without a transpose on the host."""
    dt = _DT[t]
    ar = (m, k) if transa.lower() == "n" else (k, m)
    br = (k, n) if transb.lower() == "n" else (n, k)
    a, b, c = _mat(A, dt, lda, *ar), _mat(B, dt, ldb, *br), _mat(C, dt, ldc, m, n)
    alpha, beta = _scalar(alpha, dt), _scalar(beta, dt)
    if scalapack_api.current_grid() is not None:
        _put(c, _p(t, "gemm")(transa, transb, alpha, a, b, beta, c))
        return 0
    ops = {"n": lambda M: M, "t": lambda M: M.T, "c": lambda M: M.H}
    Am, Bm, Cm = (Matrix.from_array(_down(x), nb=lapack_api._nb(max(x.shape)))
                  for x in (a, b, c))
    blas.gemm(alpha, ops[transa.lower()](Am), ops[transb.lower()](Bm), beta, Cm,
              lapack_api._opts())
    _up(c, Cm.array)
    return 0


def _gesv(t, n, nrhs, A, lda, ipiv, B, ldb):
    """getrf then getrs: the LU factors into A, 1-based pivots, X into B.
    With no grid the factors stay on the device between the two, so A
    crosses down once and the LU back once."""
    dt = _DT[t]
    a, b = _mat(A, dt, lda, n, n), _mat(B, dt, ldb, n, nrhs)
    if scalapack_api.current_grid() is not None:
        lu, piv, info = _p(t, "getrf")(a)
        _put(a, lu)
        _vec(ipiv, np.int64, n)[...] = np.asarray(piv, np.int64)
        if info == 0:
            _put(b, _p(t, "getrs")("n", lu, piv, b))
        return int(info)
    opts = lapack_api._opts()
    lu, perm, info = linalg.getrf(_down(a), opts)
    _up(a, lu)
    _vec(ipiv, np.int64, n)[...] = linalg.perm_to_pivots(perm)
    if int(info) == 0:
        _up(b, linalg.getrs(lu, perm, _down(b), opts))
    return int(info)


def _posv(t, uplo, n, nrhs, A, lda, B, ldb):
    """potrf then potrs (potrf alone when B is None): the factor into A's
    stored triangle (the other one is kept), X into B.  With no grid the
    factor stays on the device between the two, so A crosses down once and
    the factor back once."""
    dt = _DT[t]
    a = _mat(A, dt, lda, n, n)
    if scalapack_api.current_grid() is not None:
        lf, info = _p(t, "potrf")(uplo, a)
        lf = np.asarray(lf, dt)
        _put_triangle(a, _down(a), _down(lf), uplo)
        if info == 0 and B is not None:
            b = _mat(B, dt, ldb, n, nrhs)
            _put(b, _p(t, "potrs")(uplo, lf, b))
        return int(info)
    u = Uplo.Lower if str(uplo).lower().startswith("l") else Uplo.Upper
    ad = _down(a)
    lf, info = linalg.potrf(ad, lapack_api._opts(), uplo=u)
    _put_triangle(a, ad, lf, uplo)
    if int(info) == 0 and B is not None:
        b = _mat(B, dt, ldb, n, nrhs)
        _up(b, linalg.potrs(lf, _down(b), uplo=u))
    return int(info)


def _potrf(t, uplo, n, A, lda):
    return _posv(t, uplo, n, 0, A, lda, None, 1)


def _getrf(t, m, n, A, lda, ipiv):
    """getrf: the packed LU into A and min(m, n) 1-based pivots.  A tall
    factor's rows below min(m, n) are put where those pivots alone move them,
    so the truncated ipiv and the returned L rows agree."""
    dt = _DT[t]
    a = _mat(A, dt, lda, m, n)
    k = min(m, n)
    lu, piv, info = _p(t, "getrf")(a)
    piv = np.asarray(piv, np.int64)
    if m > k:
        invp = np.argsort(linalg.pivots_to_perm(piv))
        perm2 = linalg.pivots_to_perm(np.concatenate([piv[:k], np.arange(k + 1, m + 1)]))
        lu = np.asarray(lu)[invp[perm2]]
    _put(a, lu)
    _vec(ipiv, np.int64, k)[...] = piv[:k]
    return int(info)


def _getrs(t, trans, n, nrhs, A, lda, ipiv, B, ldb):
    dt = _DT[t]
    b = _mat(B, dt, ldb, n, nrhs)
    _put(b, _p(t, "getrs")(trans, _mat(A, dt, lda, n, n), _vec(ipiv, np.int64, n), b))
    return 0


def _trsm(t, side, uplo, transa, diag, m, n, alpha, A, lda, B, ldb):
    dt = _DT[t]
    ka = m if side.lower() == "l" else n
    b = _mat(B, dt, ldb, m, n)
    _put(b, _p(t, "trsm")(side, uplo, transa, diag, dt(alpha), _mat(A, dt, lda, ka, ka), b))
    return 0


def dgels(trans, m, n, nrhs, A, lda, B, ldb):
    """The least-squares X into the leading rows of B."""
    b = _mat(B, np.float64, ldb, ldb, nrhs)
    x = _p("d", "gels")(trans, _mat(A, np.float64, lda, m, n), b[:m, :nrhs])
    _put(b[:x.shape[0], :nrhs], x)
    return 0


def _heev(t, jobz, uplo, n, A, lda, W):
    """syev (s/d) / heev (c/z): ascending values into W (real), vectors into A
    for jobz 'v'."""
    dt = _DT[t]
    wdt = np.float64 if t in "dz" else np.float32
    a = _mat(A, dt, lda, n, n)
    lam, z = _p(t, "heev" if t in "cz" else "syev")(jobz, uplo, a)
    _vec(W, wdt, n)[...] = np.asarray(lam, wdt)
    if jobz.lower() == "v" and z is not None:
        _put(a, z)
    return 0


def _gesvd(t, jobu, jobvt, m, n, A, lda, S, U, ldu, VT, ldvt):
    """Singular values into S (real double), U / VT where asked and given."""
    dt = _DT[t]
    k = min(m, n)
    s, u, vt = _p(t, "gesvd")(jobu, jobvt, _mat(A, dt, lda, m, n))
    _vec(S, np.float64, k)[...] = np.asarray(np.real(s))[:k]
    if u is not None and U is not None:
        _put(_mat(U, dt, ldu, m, u.shape[1]), u)
    if vt is not None and VT is not None:
        _put(_mat(VT, dt, ldvt, vt.shape[0], n), vt)
    return 0


def dsyevx(jobz, uplo, n, A, lda, il, iu, W, Z, ldz):
    """Subset eigenpairs il..iu (1-based inclusive); the arguments were
    checked in C."""
    k = iu - il + 1
    lam, z = _skin(lapack_api.dsyevx)(jobz, uplo, _mat(A, np.float64, lda, n, n), il, iu)
    _vec(W, np.float64, k)[...] = np.asarray(lam)
    if z is not None and Z is not None:
        _put(_mat(Z, np.float64, ldz, n, k), z)
    return 0


def dgesvdx(jobu, jobvt, m, n, A, lda, il, iu, S, U, ldu, VT, ldvt):
    """Subset singular triplets il..iu of the descending values (1-based
    inclusive); the arguments were checked in C."""
    k = iu - il + 1
    s, u, vt = _skin(lapack_api.dgesvdx)(jobu, jobvt, _mat(A, np.float64, lda, m, n), il, iu)
    _vec(S, np.float64, k)[...] = np.asarray(s)
    if u is not None and U is not None:
        _put(_mat(U, np.float64, ldu, m, k), u)
    if vt is not None and VT is not None:
        _put(_mat(VT, np.float64, ldvt, k, n), vt)
    return 0


def dsygv(itype, jobz, uplo, n, A, lda, B, ldb, W):
    """Generalized eigenproblem.  B is factored first, LAPACK's order: a
    non-SPD B gives info n + i and no eigensolve; otherwise B gets that
    factor's triangle (the driver factors again inside)."""
    a, bm = _mat(A, np.float64, lda, n, n), _mat(B, np.float64, ldb, n, n)
    lf, finfo = _p("d", "potrf")(uplo, bm)
    if finfo != 0:
        return int(n) + int(finfo)
    lam, z = _p("d", "sygv")(int(itype), jobz, uplo, a, bm)
    _vec(W, np.float64, n)[...] = np.asarray(lam, np.float64)
    if jobz.lower() == "v" and z is not None:
        _put(a, z)
    _put_triangle(bm, _down(bm), _down(np.asarray(lf, np.float64)), uplo)
    return 0


def dlange(norm, m, n, A, lda) -> float:
    return float(_p("d", "lange")(norm, _mat(A, np.float64, lda, m, n)))


# ---------------------------------------------------------------------------
# band and indefinite solvers (LAPACK band layouts; ldab was checked in C)


def _pbsv(t, uplo, n, kd, nrhs, AB, ldab, B, ldb):
    """SPD band solve on LAPACK band storage (lower AB[i-j, j] = A[i, j],
    upper AB[kd+i-j, j] = A[i, j]): factor once, solve, and write the factor
    band back (L for lower storage, L^H for upper)."""
    dt = _DT[t]
    ab, b = _mat(AB, dt, ldab, ldab, n), _mat(B, dt, ldb, n, nrhs)
    low = uplo.lower().startswith("l")
    a = np.zeros((n, n), dt)
    for d in range(kd + 1):
        a += np.diag(ab[d, :n - d] if low else ab[kd - d, d:], -d if low else d)
    a = a + (np.tril(a, -1) if low else np.triu(a, 1)).conj().T
    lf, info = _p(t, "pbtrf")("l", int(kd), a)
    if info == 0:
        lf = np.asarray(lf, dt)
        _put(b, _p(t, "pbtrs")("l", int(kd), lf, b))
        for d in range(kd + 1):
            diag = np.diagonal(lf, -d)
            if low:
                ab[d, :n - d] = diag
            else:
                ab[kd - d, d:] = diag.conj()
    return int(info)


def _gbsv(t, n, kl, ku, nrhs, AB, ldab, B, ldb):
    """General band solve on LAPACK dgbsv storage, AB[kl+ku+i-j, j] = A[i, j]
    (the top kl rows are factor workspace, ignored on input; AB is not
    written)."""
    dt = _DT[t]
    ab, b = _mat(AB, dt, ldab, ldab, n), _mat(B, dt, ldb, n, nrhs)
    off = kl + ku
    a = np.zeros((n, n), dt)
    for d in range(-kl, ku + 1):
        a += np.diag(ab[off - d, max(0, d):n + min(0, d)], d)
    x, info = _p(t, "gbsv")(int(kl), int(ku), a, b)
    if info == 0:
        _put(b, x)
    return int(info)


def _sysv(t, uplo, n, nrhs, A, lda, B, ldb):
    """Symmetric (s/d) / Hermitian (c/z) indefinite solve; A is not written."""
    dt = _DT[t]
    b = _mat(B, dt, ldb, n, nrhs)
    x, info = _p(t, "hesv" if t in "cz" else "sysv")(uplo, _mat(A, dt, lda, n, n), b)
    if info == 0:
        _put(b, x)
    return int(info)


# ---------------------------------------------------------------------------
# matrix handles: each owns a host copy; the C side sizes its buffers from
# matrix_shape


def _new_handle(arr: np.ndarray) -> int:
    rt = runtime()
    h = rt.next_handle
    rt.handles[h] = np.array(arr, order="K", copy=True)
    rt.next_handle += 1
    return h


def _matrix_create(t, m, n, data, lda) -> int:
    return _new_handle(_mat(data, _DT[t], lda, m, n))


def matrix_shape(h):
    """(rows, cols) of handle ``h``, or None when there is no such handle."""
    a = runtime().handles.get(int(h))
    return None if a is None else a.shape


def _matrix_read(t, h, out, ld):
    a = runtime().handles.get(int(h))
    if a is None:
        return -1
    _put(_mat(out, _DT[t], ld, *a.shape), a)
    return 0


def matrix_destroy(h):
    runtime().handles.pop(int(h), None)
    return 0


def _handles(*hs):
    got = [runtime().handles.get(int(h)) for h in hs]
    return None if any(a is None for a in got) else got


def matrix_gemm(transa, transb, alpha, hA, hB, beta, hC):
    """C = alpha op(A) op(B) + beta C in C's precision."""
    got = _handles(hA, hB, hC)
    if got is None:
        return -1
    a, b, c = got
    out = _p(_LETTER[c.dtype], "gemm")(transa, transb, c.dtype.type(alpha), a, b,
                                       c.dtype.type(beta), c)
    runtime().handles[int(hC)] = np.asarray(out, c.dtype)
    return 0


def matrix_potrf(h, uplo):
    got = _handles(h)
    if got is None:
        return -1
    (a,) = got
    lf, info = _p(_LETTER[a.dtype], "potrf")(uplo, a)
    if info == 0:
        runtime().handles[int(h)] = np.asarray(lf, a.dtype)
    return int(info)


def matrix_gesv(hA, hB):
    """Solve A X = B; B's handle gets X (A's is left as it was)."""
    got = _handles(hA, hB)
    if got is None:
        return -1
    a, b = got
    t = _LETTER[a.dtype]
    lu, piv, info = _p(t, "getrf")(a)
    if info == 0:
        runtime().handles[int(hB)] = np.asarray(_p(t, "getrs")("n", lu, piv, b), b.dtype)
    return int(info)


def matrix_syev(h, jobz, uplo, W):
    got = _handles(h)
    if got is None:
        return -1
    (a,) = got
    t = _LETTER[a.dtype]
    lam, z = _p(t, "heev" if t in "cz" else "syev")(jobz, uplo, a)
    _vec(W, np.float64, a.shape[0])[...] = np.asarray(lam, np.float64)
    if jobz.lower() == "v" and z is not None:
        runtime().handles[int(h)] = np.asarray(z, a.dtype)
    return 0


def matrix_gesvd(h, S, want_u, want_vt):
    """Singular values into S; (info, U's new handle, VT's new handle), 0 for
    a handle not asked for."""
    got = _handles(h)
    if got is None:
        return -1, 0, 0
    (a,) = got
    k = min(a.shape)
    s, u, vt = _p(_LETTER[a.dtype], "gesvd")("s" if want_u else "n",
                                             "s" if want_vt else "n", a)
    _vec(S, np.float64, k)[...] = np.asarray(np.real(s), np.float64)[:k]
    hu = _new_handle(np.asarray(u, a.dtype)) if want_u and u is not None else 0
    hv = _new_handle(np.asarray(vt, a.dtype)) if want_vt and vt is not None else 0
    return 0, hu, hv


# ---------------------------------------------------------------------------
# the typed names the C entry points call (slate_<name> -> <name>)


def _typed(body, t: str, name: str):
    def fn(*args):
        return body(t, *args)

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"slate_{name}: {body.__doc__ or body.__name__.lstrip('_')} ({t})."
    return fn


_FAMILIES = {
    "gemm": (_gemm, "sdcz"), "gesv": (_gesv, "sdcz"), "posv": (_posv, "sdcz"),
    "potrf": (_potrf, "sdcz"), "getrf": (_getrf, "sd"), "getrs": (_getrs, "sd"),
    "trsm": (_trsm, "sd"), "syev": (_heev, "d"), "heev": (_heev, "cz"),
    "gesvd": (_gesvd, "dz"), "pbsv": (_pbsv, "sd"), "gbsv": (_gbsv, "sd"),
    "sysv": (_sysv, "sd"), "hesv": (_sysv, "cz"),
}
for _name, (_body, _letters) in _FAMILIES.items():
    for _t in _letters:
        globals()[_t + _name] = _typed(_body, _t, _t + _name)
for _t in "sdcz":
    globals()[f"matrix_create_{_t}"] = _typed(_matrix_create, _t, f"matrix_create_{_t}")
    globals()[f"matrix_read_{_t}"] = _typed(_matrix_read, _t, f"matrix_read_{_t}")
