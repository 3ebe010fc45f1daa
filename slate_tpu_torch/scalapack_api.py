"""ScaLAPACK-style compatibility API (≅ scalapack_api/, 4.4 kLoC).

The reference exports ``pdgemm``/``pdpotrf``-style entry points that build SLATE
matrices ``fromScaLAPACK`` on the caller's BLACS grid (scalapack_api/
scalapack_gemm.cc:14-27 etc.).  Here the BLACS grid is a
:class:`~slate_tpu_torch.parallel.ProcessGrid`: ``gridinit(p, q)`` plays
``Cblacs_gridinit``.  The grid is multi-controller — a world of p·q ranks, one
process each (``torchrun``, or a launcher's process group) — and every rank
passes the same whole host operands and gets the same numpy results back.

On a grid of at least ``core.matrix.BIND_MIN_RANKS`` ranks (2 by default) these
families run the distributed drivers of ``slate_tpu_torch.parallel``: gemm
(SUMMA all-gather), potrf/posv, getrf/gesv/getrs (tournament-pivoted LU),
gesv_mixed, gels (2-D CAQR), trsm (left side), trmm, hemm/symm, herk/syrk/
her2k/syr2k, heev/syev (+ the 'x' subsets), gesvd(x), the norms, the condition
estimates and the inverses.  Variants without a distributed body (right-side
trsm, transposed getrs, underdetermined gels, ...) and every other routine run
the LAPACK-style skins (:mod:`slate_tpu_torch.lapack_api`) on the grid's
device.  With no grid selected everything runs single-device, exactly like
ScaLAPACK on one process (``device=`` as for the LAPACK skins).

Routine coverage is the LAPACK skins', each with the p<type> prefix (pdgemm,
psposv, pzheev, ...).  ``SLATE_SCALAPACK_NB`` sets the distribution block size
of the distributed bodies.

Data movement: every p* call takes and returns host numpy arrays — the
ScaLAPACK calling convention — so each call copies its operands to the device
and its result back.  Pipelines that want device residency should use the
wrappers and ``slate_tpu_torch.parallel`` directly.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import lapack_api as _lapi
from .core import matrix as _cm
from .core.exceptions import SlateError
from .core.types import Norm

_grid = None
#: p* calls by route since import: a distributed body, or the LAPACK skin
ROUTES = {"distributed": 0, "lapack": 0}

__all__ = ["gridinit", "gridexit", "current_grid", "blacs_gridinit"]


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def gridinit(p: int, q: int, *, device=None):
    """Create and select a p x q process grid on ``device`` (``cuda`` unless
    the caller names the CPU; one rank per card) — ≅ Cblacs_gridinit.  Needs
    a world of at least p·q ranks (a grid of one starts its own)."""
    global _grid
    from .parallel.mesh import ProcessGrid

    dev = _cm.resolve_device(device)
    world = _world_size()
    if p * q > world:
        raise ValueError(f"grid {p}x{q} needs {p * q} ranks, have {world}")
    _grid = ProcessGrid.cached(p, q, device=dev)
    return _grid


blacs_gridinit = gridinit   # familiar alias


def gridexit() -> None:
    """Drop the current grid (≅ Cblacs_gridexit); the process group stays."""
    global _grid
    _grid = None


def current_grid():
    return _grid


def _nb() -> int:
    """Distribution block size for the p* routines (SLATE_SCALAPACK_NB,
    mirroring the reference's lapack_api/scalapack env tuning)."""
    return int(os.environ.get("SLATE_SCALAPACK_NB", "256"))


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


def _t(x, dt) -> torch.Tensor:
    """A host operand as a tensor of ``dt`` on the grid's device (a copy)."""
    return _lapi._as(dt, _grid.device, x)[0]


def _host(x) -> np.ndarray:
    """numpy of a result (a distributed one gathered first)."""
    from .parallel.distribute import gather, is_dist

    if is_dist(x):
        x = gather(x)
    return _lapi._host(x)


def _op(x: torch.Tensor, trans) -> torch.Tensor:
    t = str(trans).lower()
    return x.mH if t == "c" else x.mT if t == "t" else x


def _lower(uplo) -> bool:
    return str(uplo).lower().startswith("l")


def _sym_full(uplo, a: torch.Tensor, herm: bool = True) -> torch.Tensor:
    """Full Hermitian/symmetric matrix from the stored triangle (fromScaLAPACK
    builds the SLATE HermitianMatrix the same way).  The Hermitian case
    real-casts the diagonal, matching HermitianMatrix.full_array() and BLAS
    herk semantics (the imaginary part of a Hermitian diagonal is ignored)."""
    d = torch.diagonal(a)
    if herm and a.is_complex():
        d = d.real.to(a.dtype)
    tri = torch.tril(a, -1) if _lower(uplo) else torch.triu(a, 1)
    return torch.diag_embed(d) + tri + (tri.mH if herm else tri.mT)


def _finite_info(x: torch.Tensor) -> int:
    return 0 if bool(torch.isfinite(x).all()) else 1


def _rhs(b, dt):
    """(B as a 2-D tensor, whether b was a vector)."""
    B = _t(b, dt)
    return (B[:, None], True) if B.ndim == 1 else (B, False)


def _unvec(X, vec: bool) -> np.ndarray:
    X = _host(X)
    return X[:, 0] if vec else X


def _pgemm_distributed(dt, transa, transb, alpha, a, b, beta, c):
    """SUMMA all-gather gemm over the current grid (parallel/summa.py).
    Operands are zero-padded to grid multiples where the grid does not divide
    them (the pad-and-mask edge policy, SURVEY.md §7) and the result sliced
    back; dt enforces the routine's declared precision like the lapack_api
    skins do."""
    from .parallel import gather, gemm_allgather

    A, B, C = _op(_t(a, dt), transa), _op(_t(b, dt), transb), _t(c, dt)
    m, k = A.shape
    n = B.shape[1]
    p, q = _grid.p, _grid.q
    pm, pk, pn = _ceil_mult(m, p), _ceil_mult(k, p * q), _ceil_mult(n, q)
    if (pm, pk, pn) != (m, k, n):
        pad = torch.nn.functional.pad
        A = pad(A, (0, pk - k, 0, pm - m))
        B = pad(B, (0, pn - n, 0, pk - k))
    out = gather(gemm_allgather(A, B, _grid))[:m, :n]
    return _host(alpha * out + beta * C)


def _ppotrf_distributed(dt, uplo, a):
    from .parallel import gather, potrf_distributed

    full = _sym_full(uplo, _t(a, dt))
    L = gather(potrf_distributed(full, _grid, nb=_nb()))
    out = L if _lower(uplo) else L.mH
    return _host(out), _finite_info(out)


def _pposv_distributed(dt, uplo, a, b):
    from .parallel import gather, posv_distributed

    full = _sym_full(uplo, _t(a, dt))
    B, vec = _rhs(b, dt)
    X = gather(posv_distributed(full, B, _grid, nb=_nb()))
    return _unvec(X, vec), _finite_info(X)


def _pgetrf_distributed(dt, a):
    from .linalg import perm_to_pivots
    from .parallel import getrf_distributed

    LU, perm, info = getrf_distributed(_t(a, dt), _grid, nb=_nb())
    return _host(LU), perm_to_pivots(perm), int(info)


def _pgesv_distributed(dt, a, b):
    from .linalg import perm_to_pivots
    from .parallel import getrf_distributed, getrs_distributed

    B, vec = _rhs(b, dt)
    LU, perm, info = getrf_distributed(_t(a, dt), _grid, nb=_nb())
    X = getrs_distributed(LU, perm, B, _grid)
    return _unvec(X, vec), perm_to_pivots(perm), int(info)


def _pgesv_mixed_distributed(dt, a, b):
    from .linalg import perm_to_pivots
    from .parallel import gesv_mixed_distributed

    B, vec = _rhs(b, dt)
    X, perm, info, iters, _ = gesv_mixed_distributed(_t(a, dt), B, _grid, nb=_nb())
    return _unvec(X, vec), perm_to_pivots(perm), int(info), int(iters)


def _perm(ipiv) -> torch.Tensor:
    from .linalg import pivots_to_perm

    return torch.from_numpy(pivots_to_perm(ipiv)).to(_grid.device)


def _pgetrs_distributed(dt, trans, lu_, ipiv, b):
    from .parallel import getrs_distributed

    B, vec = _rhs(b, dt)
    return _unvec(getrs_distributed(_t(lu_, dt), _perm(ipiv), B, _grid), vec)


def _pgels_distributed(dt, trans, a, b):
    from .parallel import gels_caqr_distributed

    A = _t(a, dt)
    if str(trans).lower() in ("t", "c"):
        A = A.mH
    B, vec = _rhs(b, dt)
    return _unvec(gels_caqr_distributed(A, B, _grid, nb=_nb()), vec)


def _ptrsm_distributed(dt, side, uplo, transa, diag, alpha, a, b):
    from .parallel import trsm_distributed

    A = _t(a, dt)
    lower = _lower(uplo)
    tri = torch.tril(A) if lower else torch.triu(A)
    if str(diag).lower().startswith("u"):
        tri.diagonal().fill_(1)
    B, vec = _rhs(b, dt)
    X = trsm_distributed(tri, B, _grid, lower=lower,
                         conj_trans=str(transa).lower() in ("t", "c"))
    X = _host(X) * alpha
    return X[:, 0] if vec else X


def _pheev_distributed(dt, jobz, uplo, a):
    from .parallel import heev_distributed

    full = _sym_full(uplo, _t(a, dt))
    want = str(jobz).lower() == "v"
    lam, z = heev_distributed(full, _grid, nb=_nb(), want_vectors=want)
    return _host(lam), (_host(z) if want else None)


def _pheevx_distributed(dt, jobz, uplo, a, il, iu):
    """p?syevx/p?heevx (range='I', 1-based inclusive like ScaLAPACK's
    pdsyevx): distributed subset eigensolve — sharded stage 1, subset
    bisection, thin back-transforms (parallel.heev_range_distributed)."""
    from .parallel import heev_range_distributed

    full = _sym_full(uplo, _t(a, dt))
    want = str(jobz).lower() == "v"
    lam, z = heev_range_distributed(full, _grid, int(il) - 1, int(iu), nb=_nb(),
                                    want_vectors=want)
    return _host(lam), (_host(z) if want else None)


def _pgesvd_distributed(dt, jobu, jobvt, a):
    from .parallel import svd_distributed

    A = _t(a, dt)
    want = str(jobu).lower() != "n" or str(jobvt).lower() != "n"
    S, U, VT = svd_distributed(A, _grid, nb=_nb(), want_vectors=want)
    return _lapi._svd_finish(_host(S), None if U is None else _host(U),
                             None if VT is None else _host(VT), jobu, jobvt,
                             *A.shape)


def _pgesvdx_distributed(dt, jobu, jobvt, a, il, iu):
    """p?gesvdx (range='I', 1-based inclusive of the DESCENDING singular
    values): distributed top-k SVD (parallel.svd_range_distributed)."""
    from .parallel import svd_range_distributed

    want = str(jobu).lower() == "v" or str(jobvt).lower() == "v"
    S, U, VT = svd_range_distributed(_t(a, dt), _grid, int(il) - 1, int(iu),
                                     nb=_nb(), want_vectors=want)
    return (_host(S),
            _host(U) if want and str(jobu).lower() == "v" else None,
            _host(VT) if want and str(jobvt).lower() == "v" else None)


def _norm_kind(norm) -> Norm:
    """Resolve a LAPACK norm character through the shared Norm enum — unknown
    characters raise exactly like the single-device route."""
    return Norm.from_string(str(norm).lower()[0])


def _plange_distributed(dt, norm, a):
    from .parallel import norm_distributed

    return float(norm_distributed(_norm_kind(norm), _t(a, dt), _grid))


def _planhe_distributed(dt, norm, uplo, a, *, herm=True):
    from .parallel import norm_distributed

    full = _sym_full(uplo, _t(a, dt), herm=herm)
    return float(norm_distributed(_norm_kind(norm), full, _grid))


def _plansy_distributed(dt, norm, uplo, a):
    # symmetric (not Hermitian) mirror: a complex diagonal keeps its imaginary
    # part — real-casting it would change one/inf/fro norms for zlansy
    return _planhe_distributed(dt, norm, uplo, a, herm=False)


def _pherk_distributed(dt, uplo, trans, alpha, a, beta, c, *, sy=False,
                       two=False, b=None):
    from .parallel import (gather, her2k_distributed, herk_distributed,
                           syr2k_distributed, syrk_distributed)

    tl = str(trans).lower()
    A, C = _op(_t(a, dt), tl), _t(c, dt)
    u = "lower" if _lower(uplo) else "upper"
    if two:
        B = _op(_t(b, dt), tl)
        fn = syr2k_distributed if sy else her2k_distributed
        out = fn(alpha, A, B, beta, C, _grid, uplo=u)
    else:
        fn = syrk_distributed if sy else herk_distributed
        out = fn(alpha, A, beta, C, _grid, uplo=u)
    # mirror the stored triangle: the lapack_api routines return
    # full_array() of the Hermitian result, so the distributed path matches
    return _host(_sym_full(uplo, gather(out), herm=not sy))


def _psyrk_distributed(dt, uplo, trans, alpha, a, beta, c):
    return _pherk_distributed(dt, uplo, trans, alpha, a, beta, c, sy=True)


def _pher2k_distributed(dt, uplo, trans, alpha, a, b, beta, c):
    return _pherk_distributed(dt, uplo, trans, alpha, a, beta, c, two=True, b=b)


def _psyr2k_distributed(dt, uplo, trans, alpha, a, b, beta, c):
    return _pherk_distributed(dt, uplo, trans, alpha, a, beta, c, sy=True,
                              two=True, b=b)


def _phemm_distributed(dt, side, uplo, alpha, a, b, beta, c, *, sy=False):
    from .parallel import hemm_distributed

    u = "lower" if _lower(uplo) else "upper"
    return _host(hemm_distributed(side, alpha, _t(a, dt), _t(b, dt), beta,
                                  _t(c, dt), _grid, uplo=u, herm=not sy))


def _psymm_distributed(dt, side, uplo, alpha, a, b, beta, c):
    return _phemm_distributed(dt, side, uplo, alpha, a, b, beta, c, sy=True)


def _ptrmm_distributed(dt, side, uplo, transa, diag, alpha, a, b):
    from .parallel import trmm_distributed

    u = "lower" if _lower(uplo) else "upper"
    return _host(trmm_distributed(side, alpha, _t(a, dt), _t(b, dt), _grid, uplo=u,
                                  conj_trans=str(transa).lower() in ("t", "c"),
                                  unit_diag=str(diag).lower().startswith("u")))


def _plantr_distributed(dt, norm, uplo, diag, a):
    from .parallel import norm_distributed

    A = _t(a, dt)
    if str(diag).lower().startswith("u"):
        A.diagonal().fill_(1)
    u = "lower" if _lower(uplo) else "upper"
    return float(norm_distributed(_norm_kind(norm), A, _grid, uplo=u))


def _ptrcon_distributed(dt, norm, uplo, diag, a):
    from .parallel import trcondest_distributed

    return float(trcondest_distributed(
        _t(a, dt), _grid, lower=_lower(uplo),
        unit_diagonal=str(diag).lower().startswith("u"),
        norm_kind=_norm_kind(norm)))


def _pgecon_distributed(dt, norm, lu_, ipiv, anorm):
    from .parallel import gecondest_distributed

    kind = Norm.Inf if str(norm).lower()[0] == "i" else Norm.One
    return float(gecondest_distributed(_t(lu_, dt), _perm(ipiv), anorm, _grid,
                                       norm_kind=kind))


def _ppocon_distributed(dt, uplo, lf, anorm):
    from .parallel import pocondest_distributed

    L = _t(lf, dt)
    if not _lower(uplo):
        L = L.mH.contiguous()         # the distributed estimate takes the L factor
    return float(pocondest_distributed(L, anorm, _grid))


def _pgetri_distributed(dt, lu_, ipiv):
    from .parallel import getri_distributed

    return _host(getri_distributed(_t(lu_, dt), _perm(ipiv), _grid))


def _ppotri_distributed(dt, uplo, lf):
    from .parallel import gather, potri_distributed

    L = _t(lf, dt)
    upper = not _lower(uplo)
    if upper:
        L = L.mH
    out = gather(potri_distributed(torch.tril(L), _grid, lower=True))
    return _host(out.mH if upper else out)


# routines with a distributed body; everything else runs through the LAPACK
# skins (the single-device driver layer) on the grid's device
_DISTRIBUTED = {
    "gemm": _pgemm_distributed,
    "potrf": _ppotrf_distributed,
    "posv": _pposv_distributed,
    "getrf": _pgetrf_distributed,
    "gesv": _pgesv_distributed,
    "gesv_mixed": _pgesv_mixed_distributed,
    "getrs": _pgetrs_distributed,
    "gels": _pgels_distributed,
    "trsm": _ptrsm_distributed,
    "heev": _pheev_distributed,
    "heevd": _pheev_distributed,
    "syev": _pheev_distributed,
    "syevd": _pheev_distributed,
    "heevx": _pheevx_distributed,
    "syevx": _pheevx_distributed,
    "gesvd": _pgesvd_distributed,
    "gesvdx": _pgesvdx_distributed,
    "lange": _plange_distributed,
    "lanhe": _planhe_distributed,
    "lansy": _plansy_distributed,
    "herk": _pherk_distributed,
    "syrk": _psyrk_distributed,
    "her2k": _pher2k_distributed,
    "syr2k": _psyr2k_distributed,
    "hemm": _phemm_distributed,
    "symm": _psymm_distributed,
    "trmm": _ptrmm_distributed,
    # laset has no distributed body: the numpy-ABI skin brings the result to
    # the host either way, so the elementwise fill runs single-device
    "lantr": _plantr_distributed,
    "trcon": _ptrcon_distributed,
    "gecon": _pgecon_distributed,
    "pocon": _ppocon_distributed,
    "getri": _pgetri_distributed,
    "potri": _ppotri_distributed,
}


def _supports_distributed(name, args, kw) -> bool:
    # side/trans/shape combinations without a mesh path fall back to the
    # single-device driver layer
    if name == "getrs":
        return len(args) >= 1 and str(args[0]).lower().startswith("n")
    if name == "trsm":
        if len(args) < 7 or not str(args[0]).lower().startswith("l"):
            return False
        # plain transpose of a complex triangle has no mesh kernel (the
        # distributed solve implements conjugate-transpose)
        return not (str(args[2]).lower() == "t" and np.iscomplexobj(args[5]))
    if name == "trmm":
        # same restriction: the mesh kernel's trans is conjugate-transpose
        return not (len(args) >= 7 and str(args[2]).lower() == "t"
                    and np.iscomplexobj(args[5]))
    if name == "gels":
        if len(args) < 2:
            return False
        a = np.asarray(args[1])
        m, n = a.shape
        if str(args[0]).lower() in ("t", "c"):
            m, n = n, m
        return m >= n
    if name in ("getrf", "gesv", "gesv_mixed"):
        if len(args) < 1:
            return False
        a = np.asarray(args[0])
        if a.ndim != 2:
            return False
        # getrf handles every shape on the mesh (wide via the leading-block
        # split, tall via the 1-D TSLU — the round-2 m <= 2n embedding guard
        # is gone); solves need square
        return True if name == "getrf" else a.shape[0] == a.shape[1]
    return True


def _make(letter, name, lapack_fn):
    def fn(*args, **kw):
        # the distributed body on a grid this rank belongs to that binds
        # wrappers (core.matrix.BIND_MIN_RANKS ranks or more); other grids and
        # unsupported variants run the LAPACK skin on the grid's device
        g = _grid
        if g is not None:
            dev = kw.pop("device", None)
            if dev is not None and _cm.resolve_device(dev) != g.device:
                raise SlateError(f"p{letter}{name}: device {dev} is not the "
                                 f"grid's {g.device}")
            if (g.size >= _cm.BIND_MIN_RANKS and g.rank >= 0
                    and name in _DISTRIBUTED
                    and _supports_distributed(name, args, kw)):
                ROUTES["distributed"] += 1
                return _DISTRIBUTED[name](_lapi._TYPES[letter], *args, **kw)
            kw["device"] = g.device
        ROUTES["lapack"] += 1
        return lapack_fn(*args, **kw)

    fn.__name__ = "p" + letter + name
    fn.__qualname__ = "p" + letter + name
    fn.__doc__ = (f"p{letter}{name} — ScaLAPACK-compatible wrapper "
                  f"(scalapack_api/scalapack_{name.split('_')[0]}.cc) over the "
                  f"current gridinit() process grid; with no grid, keyword-only "
                  f"device= (default cuda).")
    return fn


for _name in _lapi.__all__:
    _letter, _routine = _name[0], _name[1:]
    if _letter not in "sdcz":
        continue
    _f = _make(_letter, _routine, getattr(_lapi, _name))
    globals()["p" + _name] = _f
    __all__.append("p" + _name)
