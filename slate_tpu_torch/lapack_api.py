"""LAPACK-style compatibility API (≅ lapack_api/, 3.2 kLoC).

The reference exports ``slate_dgesv``-style drop-ins so LAPACK callers can link
against SLATE unchanged (lapack_api/lapack_gesv.cc etc.), tuned through
``SLATE_LAPACK_*`` environment variables.  This module is the Python equivalent:
every routine family the reference's lapack_api covers —

    gemm hemm symm herk syrk her2k syr2k trmm trsm          (BLAS-3)
    lange lansy lanhe lantr laset                            (norms, set)
    gesv gesv_mixed getrf getrs getri gecon                  (LU)
    posv potrf potrs potri pocon                             (Cholesky)
    gels                                                     (least squares)
    heev heevd syev syevd hegv sygv gesvd                    (eig / SVD)
    heevx syevx hegvx sygvx gesvdx                           (subsets)
    pbsv pbtrf pbtrs gbsv hesv sysv                          (band, indefinite)
    trcon                                                    (condition)

— is exposed with all four type prefixes (s, d, c, z): ``dgesv(a, b)``,
``spotrf(uplo, a)``, ``zheev(jobz, uplo, a)``, …  numpy in / numpy out, LAPACK
calling shapes simplified to value-returning Python (info returned, not raised).
Each function takes a keyword-only ``device=`` (default ``cuda``; the port's
entry-point rule, raising without CUDA) on which the call runs.

Env tuning (≅ lapack_slate.hh:34-96): ``SLATE_LAPACK_NB`` sets the block size,
``SLATE_LAPACK_VERBOSE=1`` prints each call.
"""

from __future__ import annotations

import os
import sys
import warnings

import numpy as np
import torch

from . import blas as _blas
from . import linalg as _la
from .core.matrix import (HermitianMatrix, Matrix, SymmetricMatrix, TriangularMatrix,
                          resolve_device)
from .core.types import Norm, Options, Uplo

_TYPES = {"s": np.float32, "d": np.float64, "c": np.complex64, "z": np.complex128}


def _opts() -> Options:
    kw = {}
    nb = os.environ.get("SLATE_LAPACK_NB")
    if nb:
        kw["block_size"] = int(nb)
    return Options.make(kw)


def _verbose(name, *shapes):
    if os.environ.get("SLATE_LAPACK_VERBOSE"):
        print(f"slate_lapack: {name} {shapes}", file=sys.stderr)


def _as(dtype, dev, *arrays):
    """The operands as tensors of ``dtype`` on ``dev`` (copies; on the card
    one host copy for a row-major operand and none for a column-major one,
    padded or not, which is transposed on the card)."""
    out = []
    for a in arrays:
        a = np.asarray(a, dtype=dtype)
        if dev.type == "cpu":
            out.append(torch.tensor(a))
            continue
        with warnings.catch_warnings():      # read-only buffers are only read
            warnings.filterwarnings("ignore", "The given NumPy array is not writable")
            if a.ndim == 2 and a.strides[0] == a.itemsize and not a.flags.c_contiguous:
                out.append(torch.from_numpy(a.T).to(dev).mT.contiguous())
            else:
                out.append(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """numpy copy of a tensor."""
    return t.detach().resolve_conj().cpu().numpy()


def _np(x):
    """numpy copy of a result (a wrapper's tensor, a tensor, or host data)."""
    if hasattr(x, "array"):
        x = x.array
    if isinstance(x, torch.Tensor):
        return _host(x)
    return np.asarray(x)


def _nb(n: int) -> int:
    return min(_opts().block_size, max(8, n))


# ---------------------------------------------------------------------------
# per-routine implementations, parameterized on dtype

def _gemm(dt, dev, transa, transb, alpha, a, b, beta, c):
    a, b, c = _as(dt, dev, a, b, c)
    A = Matrix.from_array(a, nb=_nb(max(a.shape)))
    B = Matrix.from_array(b, nb=_nb(max(b.shape)))
    if transa.lower() in ("t", "c"):
        A = A.H if transa.lower() == "c" else A.T
    if transb.lower() in ("t", "c"):
        B = B.H if transb.lower() == "c" else B.T
    C = Matrix.from_array(c, nb=_nb(max(c.shape)))
    _blas.gemm(alpha, A, B, beta, C, _opts())
    return _np(C)


def _hemm(dt, dev, side, uplo, alpha, a, b, beta, c, *, sy=False):
    a, b, c = _as(dt, dev, a, b, c)
    M = (SymmetricMatrix if sy else HermitianMatrix).from_array(
        Uplo.from_string(uplo), a, nb=_nb(a.shape[0]))
    B = Matrix.from_array(b, nb=_nb(max(b.shape)))
    C = Matrix.from_array(c, nb=_nb(max(c.shape)))
    (_blas.symm if sy else _blas.hemm)(side, alpha, M, B, beta, C, _opts())
    return _np(C)


def _herk(dt, dev, uplo, trans, alpha, a, beta, c, *, sy=False):
    a, c = _as(dt, dev, a, c)
    A = Matrix.from_array(a, nb=_nb(max(a.shape)))
    if trans.lower() in ("t", "c"):
        A = A.H if trans.lower() == "c" else A.T
    C = (SymmetricMatrix if sy else HermitianMatrix).from_array(
        Uplo.from_string(uplo), c, nb=_nb(c.shape[0]))
    (_blas.syrk if sy else _blas.herk)(alpha, A, beta, C, _opts())
    return _np(C.full_array())


def _her2k(dt, dev, uplo, trans, alpha, a, b, beta, c, *, sy=False):
    a, b, c = _as(dt, dev, a, b, c)
    A = Matrix.from_array(a, nb=_nb(max(a.shape)))
    B = Matrix.from_array(b, nb=_nb(max(b.shape)))
    if trans.lower() in ("t", "c"):
        A, B = (A.H, B.H) if trans.lower() == "c" else (A.T, B.T)
    C = (SymmetricMatrix if sy else HermitianMatrix).from_array(
        Uplo.from_string(uplo), c, nb=_nb(c.shape[0]))
    (_blas.syr2k if sy else _blas.her2k)(alpha, A, B, beta, C, _opts())
    return _np(C.full_array())


def _trmm(dt, dev, side, uplo, transa, diag, alpha, a, b, *, solve=False):
    a, b = _as(dt, dev, a, b)
    T = TriangularMatrix.from_array(Uplo.from_string(uplo), a,
                                    nb=_nb(a.shape[0]), diag=diag)
    if transa.lower() in ("t", "c"):
        T = T.H if transa.lower() == "c" else T.T
    B = Matrix.from_array(b, nb=_nb(max(b.shape)))
    (_blas.trsm if solve else _blas.trmm)(side, alpha, T, B, _opts(), diag=diag)
    return _np(B)


def _lange(dt, dev, norm, a):
    (a,) = _as(dt, dev, a)
    return float(_blas.norm(norm, Matrix.from_array(a, nb=_nb(max(a.shape))),
                            _opts()))


def _lanhe(dt, dev, norm, uplo, a, *, sy=False):
    (a,) = _as(dt, dev, a)
    M = (SymmetricMatrix if sy else HermitianMatrix).from_array(
        Uplo.from_string(uplo), a, nb=_nb(a.shape[0]))
    return float(_blas.norm(norm, M, _opts()))


def _lantr(dt, dev, norm, uplo, diag, a):
    (a,) = _as(dt, dev, a)
    T = TriangularMatrix.from_array(Uplo.from_string(uplo), a,
                                    nb=_nb(a.shape[0]), diag=diag)
    return float(_blas.norm(norm, T, _opts(), diag=diag))


def _gesv(dt, dev, a, b):
    a, b = _as(dt, dev, a, b)
    X, perm, info = _la.gesv(a, b, _opts())
    return _np(X), _la.perm_to_pivots(perm), int(info)


def _gesv_mixed(dt, dev, a, b):
    a, b = _as(dt, dev, a, b)
    X, perm, info, iters = _la.gesv_mixed(a, b, _opts())
    return _np(X), _la.perm_to_pivots(perm), int(info), int(iters)


def _getrf(dt, dev, a):
    """Returns (LU, ipiv, info) with 1-based LAPACK ipiv — the same pivot format
    _gesv returns and _getrs/_getri/_gecon consume."""
    (a,) = _as(dt, dev, a)
    lu_, perm, info = _la.getrf(a, _opts())
    return _np(lu_), _la.perm_to_pivots(perm), int(info)


def _perm(ipiv, dev):
    return torch.as_tensor(_la.pivots_to_perm(ipiv), device=dev)


def _getrs(dt, dev, trans, lu_, ipiv, b):
    lu_, b = _as(dt, dev, lu_, b)
    return _np(_la.getrs(lu_, _perm(ipiv, dev), b, _opts(), trans=trans.lower()))


def _getri(dt, dev, lu_, ipiv):
    (lu_,) = _as(dt, dev, lu_)
    return _np(_la.getri(lu_, _perm(ipiv, dev), _opts()))


def _gecon(dt, dev, norm, lu_, ipiv, anorm):
    (lu_,) = _as(dt, dev, lu_)
    kind = Norm.Inf if str(norm).lower()[0] == "i" else Norm.One
    return float(_la.gecondest(lu_, _perm(ipiv, dev), anorm, _opts(), norm_kind=kind))


def _laset(dt, dev, uplo, m, n, alpha, beta, a=None):
    """dlaset (scalapack_api/scalapack_laset.cc): set the selected region of
    A to alpha off-diagonal / beta on the diagonal.  ``uplo`` 'g' sets the
    whole matrix, 'l'/'u' the triangle (the untouched triangle keeps A's
    entries, which is why A is an optional input)."""
    from .ops import elementwise

    u = str(uplo).lower()[0]
    m, n = int(m), int(n)
    if a is None:
        a = np.zeros((m, n), dtype=dt)
    (a,) = _as(dt, dev, a)
    # LAPACK sets only the leading m x n region of A; the rest is untouched
    sub = a[:m, :n]
    if u in ("l", "u"):
        out = elementwise.tzset(Uplo.Lower if u == "l" else Uplo.Upper,
                                alpha, beta, sub)
    else:
        out = elementwise.geset(alpha, beta, sub)
    a = a.clone()
    a[:m, :n] = out
    return _np(a)


def _posv(dt, dev, uplo, a, b):
    a, b = _as(dt, dev, a, b)
    M = HermitianMatrix.from_array(Uplo.from_string(uplo), a, nb=_nb(a.shape[0]))
    B = Matrix.from_array(b, nb=_nb(max(b.shape)))
    X, info = _la.posv(M, B, _opts())
    return _np(B), int(info)


def _potrf(dt, dev, uplo, a):
    (a,) = _as(dt, dev, a)
    M = HermitianMatrix.from_array(Uplo.from_string(uplo), a, nb=_nb(a.shape[0]))
    L, info = _la.potrf(M, _opts())
    return _np(L), int(info)


def _potrs(dt, dev, uplo, lf, b):
    lf, b = _as(dt, dev, lf, b)
    M = HermitianMatrix.from_array(Uplo.from_string(uplo), lf, nb=_nb(lf.shape[0]))
    B = Matrix.from_array(b, nb=_nb(max(b.shape)))
    _la.potrs(M, B, _opts(), uplo=Uplo.from_string(uplo))
    return _np(B)


def _potri(dt, dev, uplo, lf):
    (lf,) = _as(dt, dev, lf)
    M = HermitianMatrix.from_array(Uplo.from_string(uplo), lf, nb=_nb(lf.shape[0]))
    return _np(_la.potri(M, _opts(), uplo=Uplo.from_string(uplo)))


def _pocon(dt, dev, uplo, lf, anorm):
    (lf,) = _as(dt, dev, lf)
    return float(_la.pocondest(lf, anorm, _opts(), uplo=uplo))


def _trcon(dt, dev, norm, uplo, diag, a):
    (a,) = _as(dt, dev, a)
    return float(_la.trcondest(a, _opts(), uplo=uplo, diag=diag, norm_kind=norm))


def _gels(dt, dev, trans, a, b):
    a, b = _as(dt, dev, a, b)
    A = a.conj().T if trans.lower() in ("t", "c") else a
    return _np(_la.gels(A, b, _opts()))


def _heev(dt, dev, jobz, uplo, a, *, sy=False):
    (a,) = _as(dt, dev, a)
    M = (SymmetricMatrix if sy else HermitianMatrix).from_array(
        Uplo.from_string(uplo), a, nb=_nb(a.shape[0]))
    lam, z = _la.heev(M, _opts(), want_vectors=jobz.lower() == "v")
    return (_np(lam), _np(z)) if jobz.lower() == "v" else (_np(lam), None)


def _heevx(dt, dev, jobz, uplo, a, il, iu, *, sy=False):
    """LAPACK heevx/syevx range='I' (1-based INCLUSIVE il..iu, per LAPACK):
    subset eigensolve via index-targeted bisection + inverse iteration —
    a routine family the reference's lapack_api does not cover at all."""
    (a,) = _as(dt, dev, a)
    M = (SymmetricMatrix if sy else HermitianMatrix).from_array(
        Uplo.from_string(uplo), a, nb=_nb(a.shape[0]))
    lam, z = _la.heev_range(M, _opts(), want_vectors=jobz.lower() == "v",
                            il=int(il) - 1, iu=int(iu))
    return (_np(lam), _np(z)) if jobz.lower() == "v" else (_np(lam), None)


def _hegvx(dt, dev, itype, jobz, uplo, a, b, il, iu, *, sy=False):
    """LAPACK hegvx/sygvx range='I' (1-based inclusive): generalized subset
    eigensolve — another family the reference's lapack_api lacks."""
    a, b = _as(dt, dev, a, b)
    lam, z = _la.hegv_range(int(itype), a, b, _opts(), uplo=uplo,
                            il=int(il) - 1, iu=int(iu),
                            want_vectors=jobz.lower() == "v")
    return (_np(lam), _np(z)) if jobz.lower() == "v" else (_np(lam), None)


def _gesvdx(dt, dev, jobu, jobvt, a, il, iu):
    """LAPACK gesvdx range='I' (1-based inclusive il..iu of the DESCENDING
    singular values): subset/top-k SVD — another family the reference's
    lapack_api does not cover."""
    (a,) = _as(dt, dev, a)
    want = jobu.lower() == "v" or jobvt.lower() == "v"
    S, U, VT = _la.svd_range(a, _opts(), il=int(il) - 1, iu=int(iu),
                             want_vectors=want)
    return (_np(S),
            _np(U) if want and jobu.lower() == "v" else None,
            _np(VT) if want and jobvt.lower() == "v" else None)


def _hegv(dt, dev, itype, jobz, uplo, a, b, *, sy=False):
    a, b = _as(dt, dev, a, b)
    lam, z = _la.hegv(int(itype), a, b, _opts(), uplo=uplo,
                      want_vectors=jobz.lower() == "v")
    return (_np(lam), _np(z)) if jobz.lower() == "v" else (_np(lam), None)


def _complete_basis(u: np.ndarray, full: int) -> np.ndarray:
    """Extend orthonormal columns u (m x k) to a full m x m orthogonal basis:
    QR of [u | I] keeps the leading k columns equal to u (up to sign, fixed)."""
    m, k = u.shape
    q, r = np.linalg.qr(np.concatenate([u, np.eye(m, dtype=u.dtype)], axis=1))
    q = q[:, :full]
    d = np.sign(np.real(np.diagonal(r)[:k]))
    d[d == 0] = 1
    q[:, :k] = q[:, :k] * d[None, :]     # undo QR's sign choice so q[:, :k] == u
    return q


def _svd_finish(s, u, vt, jobu, jobvt, m, n):
    """Apply the LAPACK gesvd job semantics to raw SVD outputs — None-filter
    by job flag and complete to a full basis for job 'a'."""
    u = _np(u) if u is not None and jobu.lower() != "n" else None
    vt = _np(vt) if vt is not None and jobvt.lower() != "n" else None
    if u is not None and jobu.lower() == "a" and u.shape[1] < m:
        u = _complete_basis(u, m)        # LAPACK job 'a': full m x m U
    if vt is not None and jobvt.lower() == "a" and vt.shape[0] < n:
        vt = _complete_basis(vt.conj().T, n).conj().T
    return _np(s), u, vt


def _pbsv(dt, dev, uplo, kd, a, b):
    """SPD band solve (lapack_api/lapack_pbsv.cc).  ``a`` is the DENSE banded
    matrix (the skin's simplified shapes); ``kd`` its half-bandwidth.  Returns
    (X, info)."""
    a, b = _as(dt, dev, a, b)
    X, info = _la.pbsv(a, b, _opts(), uplo=uplo, kd=int(kd))
    return _np(X), int(info)


def _pbtrf(dt, dev, uplo, kd, a):
    """Band Cholesky factor (lapack_pbtrf.cc): dense banded in, dense lower
    band factor out.  Returns (L, info)."""
    (a,) = _as(dt, dev, a)
    Lb, info = _la.pbtrf(a, _opts(), uplo=uplo, kd=int(kd))
    return _np(Lb), int(info)


def _pbtrs(dt, dev, uplo, kd, lf, b):
    """Solve from the band Cholesky factor (lapack_pbtrs.cc); ``lf`` is the
    dense LOWER band factor _pbtrf returns (uplo records the original
    storage and is accepted for call-shape parity)."""
    lf, b = _as(dt, dev, lf, b)
    return _np(_la.pbtrs(lf, b, _opts(), kd=int(kd)))


def _gbsv(dt, dev, kl, ku, a, b):
    """General band solve (lapack_gbsv.cc): dense banded in.  Returns
    (X, info)."""
    a, b = _as(dt, dev, a, b)
    X, info = _la.gbsv(a, b, _opts(), kl=int(kl), ku=int(ku))
    return _np(X), int(info)


def _hesv(dt, dev, uplo, a, b, *, sy=False):
    """Symmetric/Hermitian-indefinite solve via CA-Aasen (lapack_hesv.cc);
    returns (X, info)."""
    a, b = _as(dt, dev, a, b)
    fn = _la.sysv if sy else _la.hesv
    X, info = fn(a, b, _opts(), uplo=uplo)
    return _np(X), int(info)


def _gesvd(dt, dev, jobu, jobvt, a):
    (a,) = _as(dt, dev, a)
    m, n = a.shape
    want_u = jobu.lower() != "n"
    want_vt = jobvt.lower() != "n"
    out = _la.svd(a, _opts(), want_u=want_u, want_vt=want_vt)
    return _svd_finish(out[0], out[1] if want_u else None,
                       out[2] if want_vt and len(out) > 2 else None,
                       jobu, jobvt, m, n)


# ---------------------------------------------------------------------------
# generate the typed entry points: sgemm/dgemm/cgemm/zgemm, ...

_FAMILIES = {
    "gemm": (_gemm, {}),
    "hemm": (_hemm, {}), "symm": (_hemm, {"sy": True}),
    "herk": (_herk, {}), "syrk": (_herk, {"sy": True}),
    "her2k": (_her2k, {}), "syr2k": (_her2k, {"sy": True}),
    "trmm": (_trmm, {}), "trsm": (_trmm, {"solve": True}),
    "lange": (_lange, {}), "lanhe": (_lanhe, {}), "lansy": (_lanhe, {"sy": True}),
    "lantr": (_lantr, {}), "laset": (_laset, {}),
    "gesv": (_gesv, {}), "gesv_mixed": (_gesv_mixed, {}),
    "getrf": (_getrf, {}), "getrs": (_getrs, {}), "getri": (_getri, {}),
    "gecon": (_gecon, {}),
    "posv": (_posv, {}), "potrf": (_potrf, {}), "potrs": (_potrs, {}),
    "potri": (_potri, {}), "pocon": (_pocon, {}), "trcon": (_trcon, {}),
    "gels": (_gels, {}),
    "heev": (_heev, {}), "heevd": (_heev, {}),
    "syev": (_heev, {"sy": True}), "syevd": (_heev, {"sy": True}),
    "heevx": (_heevx, {}), "syevx": (_heevx, {"sy": True}),
    "gesvdx": (_gesvdx, {}),
    "hegv": (_hegv, {}), "sygv": (_hegv, {"sy": True}),
    "hegvx": (_hegvx, {}), "sygvx": (_hegvx, {"sy": True}),
    "gesvd": (_gesvd, {}),
    "pbsv": (_pbsv, {}), "pbtrf": (_pbtrf, {}), "pbtrs": (_pbtrs, {}),
    "gbsv": (_gbsv, {}),
    "hesv": (_hesv, {}), "sysv": (_hesv, {"sy": True}),
}

# complex-only / real-only aliasing like LAPACK: cheev/zheev but ssyev/dsyev
_SKIP = {
    ("s", "hemm"), ("d", "hemm"), ("s", "herk"), ("d", "herk"),
    ("s", "her2k"), ("d", "her2k"), ("s", "lanhe"), ("d", "lanhe"),
    ("s", "heev"), ("d", "heev"), ("s", "heevd"), ("d", "heevd"),
    ("c", "syev"), ("z", "syev"), ("c", "syevd"), ("z", "syevd"),
    ("s", "heevx"), ("d", "heevx"), ("c", "syevx"), ("z", "syevx"),
    ("s", "hegv"), ("d", "hegv"), ("c", "sygv"), ("z", "sygv"),
    ("s", "hegvx"), ("d", "hegvx"), ("c", "sygvx"), ("z", "sygvx"),
    ("s", "hesv"), ("d", "hesv"),   # LAPACK: ssysv/dsysv but chesv/zhesv
    # LAPACK's csysv/zsysv solve complex *symmetric* (A == A.T) systems;
    # the backend's indefinite solver is Hermitian CA-Aasen — exposing the
    # names would silently factor conj-mirrored matrices.  Not offered.
    ("c", "sysv"), ("z", "sysv"),
}

__all__ = []


def _make(letter, name, impl, fixed):
    dt = _TYPES[letter]

    def fn(*args, **kw):
        dev = resolve_device(kw.pop("device", None))
        _verbose(letter + name, *(getattr(a, "shape", a) for a in args))
        return impl(dt, dev, *args, **dict(fixed, **kw))

    fn.__name__ = letter + name
    fn.__qualname__ = letter + name
    fn.__doc__ = (f"slate_{letter}{name} — LAPACK-compatible wrapper over "
                  f"slate_tpu_torch (lapack_api/lapack_{name.split('_')[0]}.cc); "
                  f"keyword-only device= (default cuda).")
    return fn


for _letter in _TYPES:
    for _name, (_impl, _fixed) in _FAMILIES.items():
        if (_letter, _name) in _SKIP:
            continue
        _f = _make(_letter, _name, _impl, _fixed)
        globals()[_letter + _name] = _f
        __all__.append(_letter + _name)

# dsgesv — the classic mixed-precision name (f64 system, f32 factor)
dsgesv = globals()["dgesv_mixed"]
zcgesv = globals()["zgesv_mixed"]
__all__ += ["dsgesv", "zcgesv"]
