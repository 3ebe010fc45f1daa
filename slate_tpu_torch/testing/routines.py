"""Routine dispatch table + per-routine runners and numerical checks.

≅ test/test.cc:117-320 (dispatch) and the per-routine ``test_<routine>.cc`` files.
Each runner follows the reference's test strategy (SURVEY.md §4): generate inputs
with matgen, time the library call, then verify with a **residual identity that
needs no reference implementation** — gemm via the random-RHS trick
(test_gemm.cc:192-207), factorizations via reconstruction (‖A − LLᴴ‖-style), eig/svd
via ‖AZ − ZΛ‖ + orthogonality of Z.  ``--ref`` additionally times the numpy
reference on the same problem (driver._REF_FNS — the analogue of the ScaLAPACK
reference path, reported in the ref(s) column).

Each runner takes ``(params, slate, dev)``: inputs are drawn by the port's
matgen on ``dev``, placed there once outside the clock, and handed to the
drivers as tensors; the checks run in numpy on the host (:func:`_np`).  A timed
call builds its output wrappers afresh, so every repeat of ``--repeat`` solves
the same problem.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import matgen
from ..core.exceptions import NumericalError, SlateError
from ..core.matrix import resolve_device, torch_dtype
from .sweeper import TestResult, time_call

# filled by @_routine below: name -> {"category", "runner", "doc"}
ROUTINES: Dict[str, Dict[str, Any]] = {}


def _routine(name: str, category: str):
    def wrap(fn):
        ROUTINES[name] = {"category": category, "runner": fn, "doc": fn.__doc__ or ""}
        return fn
    return wrap


# ---------------------------------------------------------------------------
# helpers

def _phases(routine: str) -> dict:
    """Driver phase map for the tester row (--timer-level-2 analogue): the
    he2hb / chase / tridiag / back-transform attribution recorded by the last
    heev/svd call (utils.trace.record_phases).  Host-side spans — on the card
    they attribute dispatch, not device time, unless ``trace.on()`` makes each
    phase end in a sync."""
    from ..utils.trace import last_phases, phase_report

    t = last_phases(routine)
    return phase_report(t, min_frac=0.02) if t else {}


def _grid(p, dev=None):
    """ProcessGrid for a grid-swept row (tester p x q dimension, like the
    reference tester's --p/--q sweep) on the row's device, or None for
    single-device rows.  A grid larger than the process group's world (one
    rank when the tester runs without a launcher) is the row's error."""
    g = p.get("grid")
    if not g:
        return None
    from ..parallel import ProcessGrid

    return ProcessGrid.cached(g[0], g[1], device=dev)


def _np(x) -> np.ndarray:
    """Host numpy copy of a result: a wrapper's tensor, a tensor on any device
    (a distributed one gathered), or host data."""
    from ..parallel.distribute import gather

    if hasattr(x, "array"):
        x = x.array
    x = gather(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(a, dev) -> torch.Tensor:
    """An input placed on the device (once, outside the clock)."""
    return torch.tensor(np.asarray(a), device=dev)


def _wide(a):
    """a in float64 / complex128: the references the checks compare against."""
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def _eps(dtype) -> float:
    return float(np.finfo(np.dtype(dtype).char.lower()
                          if np.dtype(dtype).kind == "c" else dtype).eps)


def _tol(p) -> float:
    """Default accept threshold: 3·eps scaled by problem size^1/2 with generous
    headroom for blocked algorithms (the reference gates at 3·eps for gemm and
    looser per-routine factors elsewhere)."""
    n = max(p["m"], p["n"], p["k"])
    return 50.0 * _eps(p["dtype"]) * max(1.0, n ** 0.5)


def _gen(kind, m, n, p, dev, **kw):
    A, _ = matgen.generate_matrix(kind, m, n, dtype=p["dtype"], seed=p["seed"],
                                  device=dev, **kw)
    return _np(A)


def _spd(n, p, dev):
    cond = p.get("cond") or 100.0
    return _gen("poev_geo", n, n, p, dev, cond=cond)


def _herm(n, p, dev):
    cond = p.get("cond") or 100.0
    return _gen("heev_geo", n, n, p, dev, cond=cond)


def _cplx_mult(dtype) -> float:
    return 4.0 if np.dtype(dtype).kind == "c" else 1.0


def _rel(err, scale) -> float:
    return float(err) / max(float(scale), 1e-30)


def _result(p, error, flops, t, tol_mult: float = 1.0, ref_time=None) -> dict:
    tol = _tol(p) * tol_mult
    return {
        "error": error, "time_s": t,
        "gflops": flops * _cplx_mult(p["dtype"]) / t / 1e9 if t and flops else None,
        "ref_time_s": ref_time,
        "status": "pass" if error is not None and error <= tol else "FAILED",
        "message": "" if error is not None and error <= tol else f"err>{tol:.1e}",
    }


# ---------------------------------------------------------------------------
# BLAS-3

@_routine("gemm", "blas3")
def run_gemm(p, slate, dev):
    """C = alpha A B + beta C; random-RHS residual check (test_gemm.cc:192-207)."""
    m, n, k = p["m"], p["n"], p["k"]
    A = _gen(p["kind"], m, k, p, dev)
    B = _gen(p["kind"], k, n, dict(p, seed=p["seed"] + 1), dev)
    C0 = _gen(p["kind"], m, n, dict(p, seed=p["seed"] + 2), dev)
    alpha, beta = 2.5, 0.5
    g = _grid(p, dev)
    Am = slate.Matrix.from_array(_t(A, dev), nb=p["nb"], grid=g)
    Bm = slate.Matrix.from_array(_t(B, dev), nb=p["nb"], grid=g)
    C0_t = _t(C0, dev)
    C, t = time_call(lambda: slate.gemm(
        alpha, Am, Bm, beta, slate.Matrix.from_array(C0_t, nb=p["nb"], grid=g)),
        repeat=p["repeat"], device=dev)
    C = _np(C)
    w = np.random.default_rng(0).standard_normal((n,)).astype(
        np.dtype(p["dtype"]).char.lower() if np.dtype(p["dtype"]).kind == "c"
        else p["dtype"])
    y = C @ w - (alpha * (A @ (B @ w)) + beta * (C0 @ w))
    scale = (abs(alpha) * np.linalg.norm(A) * np.linalg.norm(B) +
             abs(beta) * np.linalg.norm(C0)) * np.linalg.norm(w)
    return _result(p, _rel(np.linalg.norm(y), scale), 2.0 * m * n * k, t)


def _tri_solve_row(p, slate, dev, solve, side="left"):
    """Shared body of trsm/trsmA/trsmB: T (T^-1 B) == B."""
    m, n = p["m"], p["n"]
    side_left = side == "left"
    tn = m if side_left else n
    T = np.tril(_gen("rands", tn, tn, p, dev)) + tn * np.eye(tn, dtype=p["dtype"])
    B0 = _gen("rands", m, n, p, dev)
    B0_t = _t(B0, dev)
    Tm = slate.TriangularMatrix.from_array(slate.Uplo.Lower, _t(T, dev), nb=p["nb"])
    X, t = time_call(lambda: solve(side, 1.0, Tm,
                                   slate.Matrix.from_array(B0_t, nb=p["nb"])),
                     repeat=p["repeat"], device=dev)
    X = _np(X)
    R = T @ X - B0 if side_left else X @ T - B0
    scale = np.linalg.norm(T) * np.linalg.norm(X)
    flops = m * m * n if side_left else m * n * n
    return _result(p, _rel(np.linalg.norm(R), scale), flops, t)


@_routine("trsm", "blas3")
def run_trsm(p, slate, dev):
    """op(T)^-1 B; identity check T (T^-1 B) == B."""
    return _tri_solve_row(p, slate, dev, slate.trsm, p.get("side", "left"))


@_routine("trsmA", "blas3")
def run_trsmA(p, slate, dev):
    """Stationary-A triangular solve (src/trsmA.cc): same identity check as
    trsm through the explicit-method driver."""
    return _tri_solve_row(p, slate, dev, slate.trsmA)


@_routine("trsmB", "blas3")
def run_trsmB(p, slate, dev):
    """Stationary-B triangular solve (src/trsmB.cc)."""
    return _tri_solve_row(p, slate, dev, slate.trsmB)


@_routine("trmm", "blas3")
def run_trmm(p, slate, dev):
    """op(T) B vs dense multiply."""
    m, n = p["m"], p["n"]
    T = np.tril(_gen("rands", m, m, p, dev))
    B0 = _gen("rands", m, n, p, dev)
    B0_t = _t(B0, dev)
    Tm = slate.TriangularMatrix.from_array(slate.Uplo.Lower, _t(T, dev), nb=p["nb"])
    out, t = time_call(lambda: slate.trmm(
        "left", 1.0, Tm, slate.Matrix.from_array(B0_t, nb=p["nb"])),
        repeat=p["repeat"], device=dev)
    err = _rel(np.linalg.norm(_np(out) - T @ B0),
               np.linalg.norm(T) * np.linalg.norm(B0))
    return _result(p, err, m * m * n, t)


def _herm_out(C0_t, p, slate):
    """A fresh lower-stored Hermitian output wrapper over C0 (adopted, so the
    routine's first write copies it)."""
    return slate.HermitianMatrix.from_array(slate.Uplo.Lower, C0_t, nb=p["nb"])


@_routine("herk", "blas3")
def run_herk(p, slate, dev):
    """C = alpha A A^H + beta C on the stored triangle."""
    n, k = p["n"], p["k"]
    A = _gen("randn", n, k, p, dev)
    C0 = _herm(n, p, dev)
    Am, C0_t = slate.Matrix.from_array(_t(A, dev), nb=p["nb"]), _t(C0, dev)

    def call():
        Cm = _herm_out(C0_t, p, slate)
        slate.herk(1.5, Am, 0.5, Cm)
        return Cm

    Cm, t = time_call(call, repeat=p["repeat"], device=dev)
    C = _np(Cm.full_array())
    expect = 1.5 * (A @ A.conj().T) + 0.5 * C0
    err = _rel(np.linalg.norm(C - expect), np.linalg.norm(expect))
    return _result(p, err, n * n * k, t)


@_routine("her2k", "blas3")
def run_her2k(p, slate, dev):
    n, k = p["n"], p["k"]
    A = _gen("randn", n, k, p, dev)
    B = _gen("randn", n, k, dict(p, seed=p["seed"] + 1), dev)
    C0 = _herm(n, p, dev)
    Am = slate.Matrix.from_array(_t(A, dev), nb=p["nb"])
    Bm = slate.Matrix.from_array(_t(B, dev), nb=p["nb"])
    C0_t = _t(C0, dev)

    def call():
        Cm = _herm_out(C0_t, p, slate)
        slate.her2k(1.0, Am, Bm, 0.5, Cm)
        return Cm

    Cm, t = time_call(call, repeat=p["repeat"], device=dev)
    C = _np(Cm.full_array())
    expect = A @ B.conj().T + B @ A.conj().T + 0.5 * C0
    err = _rel(np.linalg.norm(C - expect), np.linalg.norm(expect))
    return _result(p, err, 2.0 * n * n * k, t)


@_routine("hemm", "blas3")
def run_hemm(p, slate, dev):
    m, n = p["m"], p["n"]
    A = _herm(m, p, dev)
    B = _gen("randn", m, n, p, dev)
    C0_t = torch.zeros((m, n), dtype=torch_dtype(p["dtype"]), device=dev)
    Am = slate.HermitianMatrix.from_array(slate.Uplo.Lower, _t(A, dev), nb=p["nb"])
    Bm = slate.Matrix.from_array(_t(B, dev), nb=p["nb"])
    C, t = time_call(lambda: slate.hemm(
        "left", 1.0, Am, Bm, 0.0, slate.Matrix.from_array(C0_t, nb=p["nb"])),
        repeat=p["repeat"], device=dev)
    err = _rel(np.linalg.norm(_np(C) - A @ B),
               np.linalg.norm(A) * np.linalg.norm(B))
    return _result(p, err, 2.0 * m * m * n, t)


@_routine("norm", "aux")
def run_norm(p, slate, dev):
    """Max/One/Inf/Fro norms vs numpy on the same matrix, the references in
    float64 (numpy's float32 ``norm`` and axis-0 sums accumulate in float32:
    at 16384^2 its Frobenius norm is 1.8e-3 off, over the f32 gate)."""
    m, n = p["m"], p["n"]
    A = _gen(p["kind"], m, n, p, dev)
    Am = slate.Matrix.from_array(_t(A, dev), nb=p["nb"])
    W = _wide(A)
    worst = 0.0
    t_total = 0.0
    for which, npval in [("max", np.abs(W).max()),
                         ("one", np.abs(W).sum(axis=0).max()),
                         ("inf", np.abs(W).sum(axis=1).max()),
                         ("fro", np.linalg.norm(W))]:
        val, t = time_call(lambda w=which: slate.norm(w, Am),
                           repeat=p["repeat"], device=dev)
        t_total += t
        worst = max(worst, _rel(abs(float(val) - npval), npval))
    return _result(p, worst, m * n, t_total)


# ---------------------------------------------------------------------------
# linear systems

@_routine("potrf", "cholesky")
def run_potrf(p, slate, dev):
    """‖A − L Lᴴ‖/‖A‖ reconstruction check."""
    n = p["n"]
    A = _spd(n, p, dev)
    A_t, g = _t(A, dev), _grid(p, dev)
    (L, info), t = time_call(lambda: slate.potrf(
        slate.HermitianMatrix.from_array(slate.Uplo.Lower, A_t, nb=p["nb"], grid=g)),
        repeat=p["repeat"], device=dev)
    Lf = np.tril(_np(L))
    err = _rel(np.linalg.norm(A - Lf @ Lf.conj().T), np.linalg.norm(A))
    return _result(p, err, n ** 3 / 3, t, tol_mult=10 * (p.get("cond") or 100.0) ** 0.5)


@_routine("posv", "cholesky")
def run_posv(p, slate, dev):
    n, nrhs = p["n"], p.get("nrhs", 10)
    A = _spd(n, p, dev)
    b = _gen("randn", n, nrhs, p, dev)
    A_t, b_t, g = _t(A, dev), _t(b, dev), _grid(p, dev)

    def call():
        Bm = slate.Matrix.from_array(b_t, nb=p["nb"])
        slate.posv(slate.HermitianMatrix.from_array(slate.Uplo.Lower, A_t,
                                                    nb=p["nb"], grid=g), Bm)
        return Bm

    Bm, t = time_call(call, repeat=p["repeat"], device=dev)
    x = _np(Bm)
    err = _rel(np.linalg.norm(A @ x - b),
               np.linalg.norm(A) * np.linalg.norm(x))
    return _result(p, err, n ** 3 / 3 + 2.0 * n * n * nrhs, t)


@_routine("potri", "cholesky")
def run_potri(p, slate, dev):
    """potrf then potri (the reference's potri consumes the factor)."""
    n = p["n"]
    A = _spd(n, p, dev)
    A_t = _t(A, dev)

    def factor_invert():
        M = slate.HermitianMatrix.from_array(slate.Uplo.Lower, A_t, nb=p["nb"])
        L, info = slate.potrf(M)
        return slate.potri(L)

    inv, t = time_call(factor_invert, repeat=p["repeat"], device=dev)
    Ainv = _np(inv.full_array() if hasattr(inv, "full_array") else inv)
    if Ainv.ndim == 2 and not np.allclose(Ainv, Ainv.conj().T):
        Ainv = np.tril(Ainv) + np.tril(Ainv, -1).conj().T   # lower-stored result
    err = _rel(np.linalg.norm(A @ Ainv - np.eye(n)),
               np.linalg.norm(A) * np.linalg.norm(Ainv))
    return _result(p, err, n ** 3, t)


@_routine("getrf", "lu")
def run_getrf(p, slate, dev):
    """‖P A − L U‖/‖A‖."""
    n = p["n"]
    A = _gen(p["kind"], n, n, p, dev)
    A_t = _t(A, dev)
    (lu_, perm, info), t = time_call(lambda: slate.getrf(A_t),
                                     repeat=p["repeat"], device=dev)
    lu_np = _np(lu_)
    L = np.tril(lu_np, -1) + np.eye(n, dtype=p["dtype"])
    U = np.triu(lu_np)
    err = _rel(np.linalg.norm(A[_np(perm)] - L @ U), np.linalg.norm(A))
    return _result(p, err, 2 * n ** 3 / 3, t)


@_routine("gesv", "lu")
def run_gesv(p, slate, dev):
    n, nrhs = p["n"], p.get("nrhs", 10)
    A = _gen(p["kind"], n, n, p, dev) + n * np.eye(n, dtype=p["dtype"])
    b = _gen("randn", n, nrhs, p, dev)
    A_t, b_t, g = _t(A, dev), _t(b, dev), _grid(p, dev)
    # wrapper built per call: gesv's getrf writes the LU factor back into a
    # Matrix argument, so a hoisted wrapper would poison repeat > 1 timings
    (X, perm, info), t = time_call(lambda: slate.gesv(
        slate.Matrix.from_array(A_t.clone(), nb=p["nb"], grid=g)
        if g is not None else A_t, b_t), repeat=p["repeat"], device=dev)
    x = _np(X)
    err = _rel(np.linalg.norm(A @ x - b), np.linalg.norm(A) * np.linalg.norm(x))
    return _result(p, err, 2 * n ** 3 / 3 + 2.0 * n * n * nrhs, t)


@_routine("gesv_mixed", "lu")
def run_gesv_mixed(p, slate, dev):
    """Mixed-precision IR (src/gesv_mixed.cc: low-precision factor + IR).

    The mixed path only exists where a lower precision exists (d->s, z->c),
    so an s/c sweep row PROMOTES to its d/z counterpart (noted in the row)
    instead of skipping outright — every sweep line exercises the actual
    factor-low/refine-high pipeline (no precision scope is needed: torch has
    float64 everywhere).  The IR iteration count is recorded in the tester
    row (details["ir_iters"], the reference tester's iters column)."""
    promoted = {np.dtype(np.float32): np.float64,
                np.dtype(np.complex64): np.complex128}.get(np.dtype(p["dtype"]))
    if promoted is not None:
        out = _gesv_mixed_body(dict(p, dtype=promoted), slate, dev)
        out.setdefault("details", {})["promoted"] = \
            f"s/c -> {np.dtype(promoted).char}"
        return out
    return _gesv_mixed_body(p, slate, dev)


def _gesv_mixed_body(p, slate, dev):
    n = p["n"]
    A = _gen(p["kind"], n, n, p, dev) + n * np.eye(n, dtype=p["dtype"])
    b = _gen("randn", n, 1, p, dev)
    A_t, b_t = _t(A, dev), _t(b, dev)
    (X, perm, info, iters), t = time_call(lambda: slate.gesv_mixed(A_t, b_t),
                                          repeat=p["repeat"], device=dev)
    x = _np(X)
    err = _rel(np.linalg.norm(A @ x - b), np.linalg.norm(A) * np.linalg.norm(x))
    out = _result(p, err, 2 * n ** 3 / 3, t)
    out["details"] = {"ir_iters": int(iters)}
    return out


@_routine("gesv_rbt", "lu")
def run_gesv_rbt(p, slate, dev):
    n = p["n"]
    A = _gen(p["kind"], n, n, p, dev) + n * np.eye(n, dtype=p["dtype"])
    b = _gen("randn", n, 1, p, dev)
    A_t, b_t = _t(A, dev), _t(b, dev)
    out, t = time_call(lambda: slate.gesv_rbt(A_t, b_t), repeat=p["repeat"], device=dev)
    x = _np(out[0])
    err = _rel(np.linalg.norm(A @ x - b), np.linalg.norm(A) * np.linalg.norm(x))
    return _result(p, err, 2 * n ** 3 / 3, t)


def _f64ir_row(p, A, b, solve, flops, dev):
    """Shared body of gesv_f64ir/posv_f64ir: the double-f32 iterate read back
    in float64, gated at a double-class forward error (orders below f32 eps;
    the dtype-derived suite tolerance would under-test the emulation)."""
    A_t, b_t = _t(A, dev), _t(b, dev)
    (Xh, Xl, iters, info), t = time_call(lambda: solve(A_t, b_t),
                                         repeat=p["repeat"], device=dev)
    wide = np.complex128 if np.iscomplexobj(A) else np.float64
    x = _np(Xh).astype(wide) + _np(Xl).astype(wide)
    n = A.shape[0]
    err = _rel(np.linalg.norm(A.astype(wide) @ x - b),
               np.linalg.norm(A) * np.linalg.norm(x))
    out = _result(p, err, flops, t)
    strict = 1e-9 * max(1.0, n ** 0.5)
    out["status"] = "pass" if err is not None and err <= strict else "FAILED"
    out["message"] = "" if out["status"] == "pass" \
        else f"err>{strict:.1e} (double-class gate)"
    return out


@_routine("gesv_f64ir", "lu")
def run_gesv_f64ir(p, slate, dev):
    """Emulated-f64 IR solve (ops/f64emu.py): f32 factor + exact-Ozaki
    residuals; the tester's rows verify double-class forward error (gate
    scaled to the emulation envelope, not the f32 eps the suite-wide
    tolerance assumes)."""
    n = p["n"]
    A = _gen(p["kind"], n, n, p, dev) + n * np.eye(n, dtype=p["dtype"])
    if np.iscomplexobj(A):
        b = _gen("randn", n, 1, p, dev) + 1j * _gen("randn", n, 1, p, dev)
    else:
        b = _gen("randn", n, 1, p, dev)
    return _f64ir_row(p, A, b, slate.gesv_f64ir, 2 * n ** 3 / 3, dev)


@_routine("posv_f64ir", "chol")
def run_posv_f64ir(p, slate, dev):
    """SPD sibling of gesv_f64ir: f32 Cholesky + emulated-f64 refinement
    (ops/f64emu.posv_f64ir), same double-class gate."""
    n = p["n"]
    G = _gen(p["kind"], n, n, p, dev)
    A = G @ np.conj(G.T) + n * np.eye(n, dtype=p["dtype"])
    b = _gen("randn", n, 1, p, dev)
    return _f64ir_row(p, A, b, slate.posv_f64ir, n ** 3 / 3, dev)


@_routine("hesv", "indefinite")
def run_hesv(p, slate, dev):
    n = p["n"]
    A = _herm(n, p, dev)
    b = _gen("randn", n, 4, p, dev)
    A_t, b_t = _t(A, dev), _t(b, dev)
    out, t = time_call(lambda: slate.hesv(A_t, b_t, None), repeat=p["repeat"], device=dev)
    x = _np(out[0])
    err = _rel(np.linalg.norm(A @ x - b), np.linalg.norm(A) * np.linalg.norm(x))
    return _result(p, err, n ** 3 / 3, t, tol_mult=20)


@_routine("gbsv", "band")
def run_gbsv(p, slate, dev):
    n, kl, ku = p["n"], p.get("kl", 8), p.get("ku", 8)
    A = _gen("randn", n, n, p, dev)
    band = np.triu(np.tril(A, kl), -ku) + n * np.eye(n, dtype=p["dtype"])
    b = _gen("randn", n, 2, p, dev)
    band_t, b_t = _t(band, dev), _t(b, dev)
    out, t = time_call(lambda: slate.gbsv(band_t, b_t, kl=kl, ku=ku),
                       repeat=p["repeat"], device=dev)
    x = _np(out[0])
    err = _rel(np.linalg.norm(band @ x - b), np.linalg.norm(band) * np.linalg.norm(x))
    return _result(p, err, 2.0 * n * kl * ku, t)


@_routine("pbsv", "band")
def run_pbsv(p, slate, dev):
    n, kd = p["n"], p.get("kd", 8)
    A = _spd(n, p, dev)
    band = np.triu(np.tril(A, kd), -kd) + n * np.eye(n, dtype=p["dtype"])
    b = _gen("randn", n, 2, p, dev)
    band_t, b_t = _t(band, dev), _t(b, dev)
    out, t = time_call(lambda: slate.pbsv(band_t, b_t, kd=kd),
                       repeat=p["repeat"], device=dev)
    x = _np(out[0])
    err = _rel(np.linalg.norm(band @ x - b), np.linalg.norm(band) * np.linalg.norm(x))
    return _result(p, err, n * kd * kd, t)


# ---------------------------------------------------------------------------
# least squares / QR

@_routine("geqrf", "qr")
def run_geqrf(p, slate, dev):
    """‖A − Q R‖/‖A‖ + ‖I − QᴴQ‖."""
    m, n = p["m"], p["n"]
    A = _gen(p["kind"], m, n, p, dev)
    A_t = _t(A, dev)
    fac, t = time_call(lambda: slate.geqrf(A_t), repeat=p["repeat"], device=dev)
    Q = _np(fac.Q())
    R = _np(fac.R())
    k = min(m, n)
    err1 = _rel(np.linalg.norm(A - Q @ R), np.linalg.norm(A))
    err2 = np.linalg.norm(Q.conj().T @ Q - np.eye(k)) / k
    return _result(p, max(err1, err2), 2.0 * m * n * n - 2 * n ** 3 / 3, t)


@_routine("cholqr", "qr")
def run_cholqr(p, slate, dev):
    m, n = p["m"], p["n"]
    A = _gen("randn", m, n, p, dev)
    A_t = _t(A, dev)
    (Q, R), t = time_call(lambda: slate.cholqr(A_t), repeat=p["repeat"], device=dev)
    Q, R = _np(Q), _np(R)
    err1 = _rel(np.linalg.norm(A - Q @ R), np.linalg.norm(A))
    err2 = np.linalg.norm(Q.conj().T @ Q - np.eye(n)) / n
    # CholeskyQR2's orthogonality envelope is ~eps*cond(A) (it is a
    # tall-panel algorithm; square randn has cond ~ n, which the generic
    # gate does not budget for).  16x keeps the gate meaningful while
    # respecting the envelope on square sweep shapes.
    return _result(p, max(err1, err2), 2.0 * m * n * n, t, tol_mult=16)


@_routine("gels", "qr")
def run_gels(p, slate, dev):
    """Normal-equations residual ‖Aᴴ(A x − b)‖ / (‖A‖² ‖x‖)."""
    m, n = p["m"], p["n"]
    A = _gen(p["kind"], m, n, p, dev)
    b = _gen("randn", m, 2, p, dev)
    A_t, b_t = _t(A, dev), _t(b, dev)
    X, t = time_call(lambda: slate.gels(A_t, b_t), repeat=p["repeat"], device=dev)
    x = _np(X)[:n]
    r = A @ x - b
    err = _rel(np.linalg.norm(A.conj().T @ r),
               np.linalg.norm(A) ** 2 * max(np.linalg.norm(x), 1e-10))
    # square consistent systems amplify the normal-equations residual by cond(A)
    return _result(p, err, 2.0 * m * n * n, t, tol_mult=100)


# ---------------------------------------------------------------------------
# batched serving tier (slate_tpu_torch.serve; the reference's batch-BLAS L1
# has no tester rows — these sweep the batched drivers the serving queue packs)

def _batch_stack(gen_one, bs):
    return np.stack([gen_one(i) for i in range(bs)])


def _batched_result(p, errs, flops, t, tol_mult=1.0):
    out = _result(p, max(errs), flops, t, tol_mult=tol_mult)
    out.setdefault("details", {})["batch"] = len(errs)
    return out


def _batched_operands(p, dev, gen_a, m, nrhs):
    bs = int(p.get("batch", 4))
    A = _batch_stack(lambda i: gen_a(dict(p, seed=p["seed"] + i)), bs)
    b = _batch_stack(lambda i: _gen("randn", m, nrhs,
                                    dict(p, seed=100 + p["seed"] + i), dev), bs)
    return A, b, bs


def _require_zero_info(info):
    assert not _np(info).any(), f"nonzero batched info {info}"


def _solve_errs(A, b, x, bs):
    return [_rel(np.linalg.norm(A[i] @ x[i] - b[i]),
                 np.linalg.norm(A[i]) * np.linalg.norm(x[i]))
            for i in range(bs)]


@_routine("gesv_batched", "serve")
def run_gesv_batched(p, slate, dev):
    """Batched gesv (serve.gesv_batched): max over the batch of per-element
    residuals; per-element info must be all-zero."""
    n, nrhs = p["n"], min(p.get("nrhs", 4), 4)
    A, b, bs = _batched_operands(
        p, dev, lambda q: _gen("randn", n, n, q, dev) + n * np.eye(n, dtype=p["dtype"]),
        n, nrhs)
    A_t, b_t = _t(A, dev), _t(b, dev)
    (X, perm, info), t = time_call(lambda: slate.serve.gesv_batched(A_t, b_t),
                                   repeat=p["repeat"], device=dev)
    _require_zero_info(info)
    errs = _solve_errs(A, b, _np(X), bs)
    return _batched_result(p, errs, bs * (2 * n**3 / 3 + 2.0 * n * n * nrhs), t)


@_routine("posv_batched", "serve")
def run_posv_batched(p, slate, dev):
    """Batched SPD solve (serve.posv_batched) over a stack of full Hermitian
    operands."""
    n, nrhs = p["n"], min(p.get("nrhs", 4), 4)
    A, b, bs = _batched_operands(p, dev, lambda q: _spd(n, q, dev), n, nrhs)
    A_t, b_t = _t(A, dev), _t(b, dev)
    (X, info), t = time_call(lambda: slate.serve.posv_batched(A_t, b_t),
                             repeat=p["repeat"], device=dev)
    _require_zero_info(info)
    errs = _solve_errs(A, b, _np(X), bs)
    return _batched_result(p, errs, bs * (n**3 / 3 + 2.0 * n * n * nrhs), t)


@_routine("gels_batched", "serve")
def run_gels_batched(p, slate, dev):
    """Batched least squares (serve.gels_batched): normal-equations residual
    per element, sweeping the tall/square/wide shape grid via --tall/--wide."""
    m, n, nrhs = p["m"], p["n"], min(p.get("nrhs", 4), 4)
    A, b, bs = _batched_operands(p, dev, lambda q: _gen("randn", m, n, q, dev),
                                 m, nrhs)
    A_t, b_t = _t(A, dev), _t(b, dev)
    (X, info), t = time_call(lambda: slate.serve.gels_batched(A_t, b_t),
                             repeat=p["repeat"], device=dev)
    _require_zero_info(info)
    x = _np(X)
    errs = []
    for i in range(bs):
        if m >= n:
            r = A[i].conj().T @ (A[i] @ x[i] - b[i])
            errs.append(_rel(np.linalg.norm(r), np.linalg.norm(A[i]) ** 2
                             * max(np.linalg.norm(x[i]), 1e-10)))
        else:       # consistent underdetermined system: direct residual
            errs.append(_rel(np.linalg.norm(A[i] @ x[i] - b[i]),
                             np.linalg.norm(A[i]) * np.linalg.norm(x[i])))
    return _batched_result(p, errs, bs * 2.0 * m * n * min(m, n), t,
                           tol_mult=100)


# ---------------------------------------------------------------------------
# eig / svd

@_routine("heev", "eig")
def run_heev(p, slate, dev):
    """‖A Z − Z Λ‖/‖A‖ + ‖I − ZᴴZ‖ (the reference's eig check)."""
    n = p["n"]
    A = _herm(n, p, dev)
    A_t, g = _t(A, dev), _grid(p, dev)
    Aop = (slate.HermitianMatrix.from_array(slate.Uplo.Lower, A_t.clone(),
                                            nb=p["nb"], grid=g)
           if g is not None else A_t)
    (lam, Z), t = time_call(lambda: slate.heev(Aop), repeat=p["repeat"], device=dev)
    lam, Z = _np(lam), _np(Z)
    err1 = _rel(np.linalg.norm(A @ Z - Z * lam[None, :]), np.linalg.norm(A))
    err2 = np.linalg.norm(Z.conj().T @ Z - np.eye(n)) / n
    out = _result(p, max(err1, err2), 9.0 * n ** 3, t)
    out["details"] = {"phases": _phases("heev")}
    return out


@_routine("heevx", "eig")
def run_heevx(p, slate, dev):
    """Subset eigenpairs (no reference analogue): indices [n/4, n/2) via
    index-targeted bisection + thin back-transforms; residual +
    orthogonality on the k computed columns."""
    n = p["n"]
    il, iu = n // 4, n // 2
    A = _herm(n, p, dev)
    A_t = _t(A, dev)
    (lam, Z), t = time_call(lambda: slate.heev_range(A_t, il=il, iu=iu),
                            repeat=p["repeat"], device=dev)
    lam, Z = _np(lam), _np(Z)
    k = iu - il
    err1 = _rel(np.linalg.norm(A @ Z - Z * lam[None, :]), np.linalg.norm(A))
    err2 = np.linalg.norm(Z.conj().T @ Z - np.eye(k)) / n
    # index-targeting gate: the one behavior heevx adds over heev
    ref = np.linalg.eigvalsh(_wide(A))
    err3 = _rel(np.max(np.abs(lam - ref[il:iu])), max(np.max(np.abs(ref)), 1e-10))
    err1 = max(err1, err3)
    # stage 1 dominates: 4/3 n^3 band reduction + O(n^2 (nb + k)) tail
    return _result(p, max(err1, err2), 4.0 * n ** 3 / 3.0, t)


@_routine("hegvx", "eig")
def run_hegvx(p, slate, dev):
    """Generalized subset eigenpairs (no reference analogue): indices
    [n/4, n/2) of A x = lam B x; generalized residual + index gate."""
    import scipy.linalg as _sla

    n = p["n"]
    il, iu = n // 4, n // 2
    A = _herm(n, p, dev)
    Bm = _gen("randn", n, n, p, dev)
    B = (Bm @ Bm.conj().T + n * np.eye(n)).astype(p["dtype"])
    A_t, B_t = _t(A, dev), _t(B, dev)
    out, t = time_call(lambda: slate.hegv_range(1, A_t, B_t, il=il, iu=iu),
                       repeat=p["repeat"], device=dev)
    lam, Z = (_np(x) for x in out)
    err1 = _rel(np.linalg.norm(A @ Z - B @ Z * lam[None, :]),
                np.linalg.norm(A) + np.linalg.norm(B) * np.max(np.abs(lam)))
    ref = _sla.eigh(_wide(A), _wide(B), eigvals_only=True)
    err2 = _rel(np.max(np.abs(lam - ref[il:iu])), max(np.max(np.abs(ref)), 1e-10))
    return _result(p, max(err1, err2), 4.0 * n ** 3 / 3.0, t)


@_routine("gesvdx", "svd")
def run_gesvdx(p, slate, dev):
    """Top-k singular triplets (no reference analogue): GK-bisection subset
    + thin back-transforms; triplet residual on the k columns."""
    n = p["n"]
    k = max(1, n // 8)
    A = _gen("randn", n, n, p, dev)
    A_t = _t(A, dev)
    out, t = time_call(lambda: slate.svd_range(A_t, il=0, iu=k),
                       repeat=p["repeat"], device=dev)
    S, U, VT = (_np(x) for x in out)
    err1 = _rel(np.linalg.norm(A @ VT.conj().T - U * S[None, :]), np.linalg.norm(A))
    err2 = np.linalg.norm(U.conj().T @ U - np.eye(k)) / n
    err3 = np.linalg.norm(VT @ VT.conj().T - np.eye(k)) / n
    return _result(p, max(err1, err2, err3), 8.0 * n ** 3 / 3.0, t)


def _tridiag(p, dtype):
    """A random symmetric tridiagonal (d, e) of ``dtype`` from the row's
    seed, and its float64 dense T for the reference."""
    n = p["n"]
    rng = np.random.default_rng(p["seed"])
    d = rng.standard_normal(n).astype(dtype)
    e = rng.standard_normal(n - 1).astype(dtype)
    T = np.diag(d.astype(np.float64)) + np.diag(e.astype(np.float64), 1) \
        + np.diag(e.astype(np.float64), -1)
    return d, e, T


@_routine("steqr", "eig")
def run_steqr(p, slate, dev):
    """Tridiagonal QR iteration (src/steqr.cc): ‖T Q − Q Λ‖/‖T‖ +
    orthogonality, real implicit-shift sweeps at every size."""
    n = p["n"]
    d, e, T = _tridiag(p, p["dtype"])
    d_t, e_t = _t(d, dev), _t(e, dev)
    (lam, Q), t = time_call(lambda: slate.steqr(d_t, e_t), repeat=p["repeat"], device=dev)
    lam, Q = _np(lam).astype(np.float64), _np(Q).astype(np.float64)
    err1 = _rel(np.linalg.norm(T @ Q - Q * lam[None, :]), np.linalg.norm(T))
    err2 = np.linalg.norm(Q.T @ Q - np.eye(n)) / n
    # ~3 sweeps/eigenvalue x n^2-class rotation+gemm work: 6 n^3 job model.
    # Accuracy envelope of accumulated QR iteration is O(sweeps*eps) =
    # O(n*eps); the suite-wide tol carries sqrt(n), so the gate needs the
    # other sqrt(n) factor
    return _result(p, max(err1, err2), 6.0 * n ** 3, t,
                   tol_mult=max(1.0, n ** 0.5) / 10.0)


@_routine("sterf", "eig")
def run_sterf(p, slate, dev):
    """Stage-level tester for the tridiagonal VALUES solver (test_sterf.cc):
    eigenvalues of T(d, e) vs the f64 dense reference — the sweep surface
    that localizes a two-stage regression to the tridiag phase."""
    from ..linalg.eig import sterf

    n = p["n"]
    d, e, T = _tridiag(p, np.dtype(p["dtype"]).char.lower())   # real-only, like LAPACK
    d_t, e_t = _t(d, dev), _t(e, dev)
    lam, t = time_call(lambda: sterf(d_t, e_t), repeat=p["repeat"], device=dev)
    lam = np.sort(_np(lam).astype(np.float64))
    ref = np.linalg.eigvalsh(T)
    err = _rel(np.max(np.abs(lam - ref)), max(np.max(np.abs(ref)), 1e-30))
    # O(n^2) bisection work model (PWK/sterf class)
    return _result(p, err, 2.0 * n * n, t)


@_routine("he2hb", "eig")
def run_he2hb(p, slate, dev):
    """Stage-level tester for the full->band reduction (test_he2hb.cc):
    ‖Qᴴ A Q − B‖/‖A‖ via the stacked block reflectors, plus band shape."""
    from ..linalg.eig import default_band_nb, he2hb, he2hb_q

    n = p["n"]
    A = _herm(n, p, dev)
    A_t = _t(A, dev)
    nb = default_band_nb(n, None)
    (band, Vs, Ts), t = time_call(lambda: he2hb(A_t, nb=nb),
                                  repeat=p["repeat"], device=dev)
    band, Q = _np(band), _np(he2hb_q(Vs, Ts))
    err1 = _rel(np.linalg.norm(Q.conj().T @ A @ Q - band), np.linalg.norm(A))
    err2 = np.linalg.norm(Q.conj().T @ Q - np.eye(n)) / n
    r, c = np.nonzero(np.abs(band) > 0)
    bw_ok = (len(r) == 0) or (np.max(np.abs(r - c)) <= nb)
    out = _result(p, max(err1, err2), 4.0 * n ** 3 / 3.0, t, tol_mult=4)
    if not bw_ok:
        out["status"], out["message"] = "FAILED", f"bandwidth > nb={nb}"
    out["details"] = {"nb": nb}
    return out


@_routine("hb2st", "eig")
def run_hb2st(p, slate, dev):
    """Stage-level tester for the band->tridiagonal chase (test_hb2st.cc):
    ‖B Q2 − Q2 T‖/‖B‖ + orthogonality of the accumulated Q2."""
    from ..linalg.eig import hb2st

    n = p["n"]
    kd = max(2, min(8, n // 8))
    A = _herm(n, p, dev)
    r_idx = np.arange(n)
    band = np.where(np.abs(r_idx[:, None] - r_idx[None, :]) <= kd, A, 0)
    band_t = _t(band, dev)
    (d, e, Q2), t = time_call(lambda: hb2st(band_t, kd=kd, want_vectors=True),
                              repeat=p["repeat"], device=dev)
    d, e, Q2 = _np(d), _np(e), _np(Q2)
    T = np.diag(d.astype(np.float64)) + np.diag(e.astype(np.float64), 1) \
        + np.diag(e.astype(np.float64), -1)
    err1 = _rel(np.linalg.norm(band @ Q2 - Q2 @ T.astype(Q2.dtype)),
                np.linalg.norm(band))
    err2 = np.linalg.norm(Q2.conj().T @ Q2 - np.eye(n)) / n
    # chase work model: O(n^2 kd) reflector flops + O(n^3)-class Q2 gemms
    out = _result(p, max(err1, err2), 2.0 * n ** 3, t, tol_mult=4)
    out["details"] = {"kd": kd}
    return out


@_routine("hegv", "eig")
def run_hegv(p, slate, dev):
    n = p["n"]
    A = _herm(n, p, dev)
    B = _spd(n, dict(p, seed=p["seed"] + 3), dev)
    A_t, B_t = _t(A, dev), _t(B, dev)
    (lam, Z), t = time_call(lambda: slate.hegv(1, A_t, B_t),
                            repeat=p["repeat"], device=dev)
    lam, Z = _np(lam), _np(Z)
    err = _rel(np.linalg.norm(A @ Z - (B @ Z) * lam[None, :]),
               np.linalg.norm(A) * np.linalg.norm(Z))
    return _result(p, err, 14.0 * n ** 3, t, tol_mult=20)


@_routine("svd", "svd")
def run_svd(p, slate, dev):
    m, n = p["m"], p["n"]
    A = _gen(p["kind"], m, n, p, dev)
    A_t, g = _t(A, dev), _grid(p, dev)
    Aop = (slate.Matrix.from_array(A_t.clone(), nb=p["nb"], grid=g)
           if g is not None else A_t)
    (S, U, VT), t = time_call(lambda: slate.svd(Aop), repeat=p["repeat"], device=dev)
    S, U, VT = _np(S), _np(U), _np(VT)
    k = min(m, n)
    err1 = _rel(np.linalg.norm(A - (U[:, :k] * S[None, :k]) @ VT[:k]),
                np.linalg.norm(A))
    err2 = np.linalg.norm(U.conj().T @ U - np.eye(U.shape[1])) / k
    out = _result(p, max(err1, err2), 4.0 * m * n * min(m, n), t)
    out["details"] = {"phases": _phases("svd")}
    return out


@_routine("gecondest", "condest")
def run_gecondest(p, slate, dev):
    """Condition estimate within 100x of the true cond (estimates are bounds)."""
    n = p["n"]
    cond = p.get("cond") or 100.0
    A = _gen("svd_geo", n, n, p, dev, cond=cond)
    A_t = _t(A, dev)
    lu_, perm, info = slate.getrf(A_t)
    est, t = time_call(lambda: slate.gecondest(lu_, perm, slate.norm("one", A_t)),
                       repeat=p["repeat"], device=dev)
    true = np.linalg.cond(A, 1)
    rcond_est = float(est)
    ratio = (1.0 / max(rcond_est, 1e-30)) / true
    ok = 0.01 < ratio < 100.0
    return {"error": abs(np.log10(max(ratio, 1e-30))), "time_s": t, "gflops": None,
            "ref_time_s": None, "status": "pass" if ok else "FAILED",
            "message": "" if ok else f"est/true ratio {ratio:.2e}"}


# ---------------------------------------------------------------------------
# entry

def run_routine(name: str, params: dict, device=None) -> TestResult:
    """Run one routine at one parameter point on ``device`` (``cuda`` unless
    named); never raises, except for an unknown routine name."""
    import slate_tpu_torch as slate
    spec = ROUTINES.get(name)
    if spec is None:
        raise KeyError(f"unknown routine '{name}'; known: {sorted(ROUTINES)}")
    try:
        fields = spec["runner"](params, slate, resolve_device(device))
        return TestResult(routine=name, params=params, **fields)
    except NumericalError as e:
        # the taxonomy is reported, never swallowed: the row carries the
        # exact failure class (SingularMatrixError / ConvergenceError / ...)
        # plus any info index, so a sweep distinguishes "matrix was singular"
        # from tester plumbing blowing up
        info = getattr(e, "info", None)
        detail = f" info={info}" if info else ""
        return TestResult(routine=name, params=params, status="error",
                          message=f"{type(e).__name__}: {e}{detail}")
    except Exception as e:  # noqa: BLE001 — the tester reports, it doesn't crash
        return TestResult(routine=name, params=params, status="error",
                          message=f"{type(e).__name__}: {e}")
