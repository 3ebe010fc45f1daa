"""The slice end to end: the SPD solve with its norm-checked residual and
condition estimates, through the PyTorch port and through the JAX package.

The port side is ``chip_smoke.main_path``, the function ``chip_smoke.py`` runs at
n = 16384 f32 on the card; here it runs at n = 256, nb = 64, in f64 on the CPU
(the plain norm path).  The JAX side makes the same calls through
``slate_tpu``.  Tolerances: X to 1e-12 relative (same algorithm, different
libraries), norms and condition estimates to rtol 1e-10, info identical.
"""

import math

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from chip_smoke import check_main_path, main_path

N, NB, NRHS = 256, 64, 10


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(2024)
    m = rng.standard_normal((N, N))
    a = m @ m.T / N + 2.0 * np.eye(N)
    b = rng.standard_normal((N, NRHS))
    return a, b


def _jax_main_path(a, b, nb):
    opts = {"target": "tiled", "block_size": nb}
    Aw = sj.HermitianMatrix.from_array("lower", a, nb=nb)
    X, info = sj.posv(Aw, sj.Matrix.from_array(b, nb=nb), opts)
    R = sj.gemm(-1.0, a, X, 1.0, sj.Matrix.from_array(b, nb=nb))
    r_fro, a_fro, x_fro = (float(sj.norm("fro", M)) for M in (R, a, X))
    L = np.tril(np.asarray(Aw.array))
    one = sj.norm("one", a)
    bad = a.copy()
    bad[N // 2, N // 2] = -1.0
    return {
        "info": int(info), "X": np.asarray(X), "r_fro": r_fro, "a_fro": a_fro,
        "x_fro": x_fro, "backward_error": r_fro / (a_fro * x_fro),
        "one": float(one), "inf": float(sj.norm("inf", a)),
        "max": float(sj.norm("max", a)),
        "col_norms_max": float(np.max(np.asarray(sj.col_norms("max", a)))),
        "col_norms_min": float(np.min(np.asarray(sj.col_norms("max", a)))),
        "trcondest": float(sj.trcondest(sj.TriangularMatrix.from_array("lower", L,
                                                                       nb=nb))),
        "pocondest": float(sj.pocondest(L, one)),
        "non_spd_info": int(sj.posv(bad, b, opts, uplo="lower")[1]),
    }


def test_main_path_matches_jax(problem):
    a, b = problem
    A, B = torch.tensor(a), torch.tensor(b)
    keep = A.clone()
    got = main_path(A, B, NB)
    want = _jax_main_path(a, b, NB)
    check_main_path(got, N)
    assert torch.equal(A, keep)                   # the caller's A is untouched
    assert got["info"] == want["info"] == 0
    assert got["non_spd_info"] == want["non_spd_info"] > 0
    x = got["X"].numpy()
    assert np.linalg.norm(x - want["X"]) / np.linalg.norm(want["X"]) <= 1e-12
    for key in ("a_fro", "x_fro", "one", "inf", "max", "col_norms_max",
                "col_norms_min", "trcondest", "pocondest"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-10, err_msg=key)
    # the residual is at rounding level in both: compare it to the gate, not
    # digit for digit
    tol = 50 * np.finfo(np.float64).eps * math.sqrt(N)
    assert got["backward_error"] <= tol and want["backward_error"] <= tol
    assert got["backward_tol"] == pytest.approx(tol)
    assert set(got["times"]) >= {"posv_s", "residual_s", "trcondest_s"}


def test_main_path_f32(problem):
    """The dtype the card runs: the same gate in f32, and agreement with the
    JAX package's f32 solve."""
    a, b = (x.astype(np.float32) for x in problem)
    got = main_path(torch.from_numpy(a), torch.from_numpy(b), NB)
    check_main_path(got, N)
    Xj, _ = sj.posv(sj.HermitianMatrix.from_array("lower", a, nb=NB),
                    sj.Matrix.from_array(b, nb=NB), {"target": "tiled", "block_size": NB})
    Xj = np.asarray(Xj)
    assert Xj.dtype == got["X"].numpy().dtype == np.float32
    assert np.linalg.norm(got["X"].numpy() - Xj) / np.linalg.norm(Xj) <= 1e-5


# ---------------------------------------------------------------------------
# the condition estimators on their own (rtol 1e-10: the same power iteration
# on the same factors)
# ---------------------------------------------------------------------------


def _tri(n, seed, upper=False):
    t = np.tril(np.random.default_rng(seed).standard_normal((n, n))) + 4 * np.eye(n)
    return t.T.copy() if upper else t


@pytest.mark.parametrize("norm_kind", ["one", "inf"])
@pytest.mark.parametrize("uplo", ["lower", "upper"])
@pytest.mark.parametrize("diag", ["nonunit", "unit"])
def test_trcondest_matches_jax(uplo, diag, norm_kind):
    t = _tri(40, 41, upper=uplo == "upper")
    want = sj.trcondest(sj.TriangularMatrix.from_array(uplo, t, diag=diag),
                        norm_kind=norm_kind)
    got = st.trcondest(st.TriangularMatrix.from_array(uplo, t, diag=diag, device="cpu"),
                       norm_kind=norm_kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


def test_pocondest_and_norm1est_match_jax(problem):
    a, _ = problem
    L = np.linalg.cholesky(a)
    anorm = np.abs(a).sum(0).max()
    for uplo, F in (("lower", L), ("upper", L.T.copy())):
        np.testing.assert_allclose(
            float(st.pocondest(torch.from_numpy(F), anorm, uplo=uplo)),
            float(sj.pocondest(F, anorm, uplo=uplo)), rtol=1e-10)
    inv = np.linalg.inv(a)
    est_t = st.norm1est(lambda x: torch.from_numpy(inv) @ x,
                        lambda x: torch.from_numpy(inv.T) @ x, N, torch.float64,
                        device="cpu")
    est_j = sj.norm1est(lambda x: inv @ x, lambda x: inv.T @ x, N, np.float64)
    np.testing.assert_allclose(float(est_t), float(est_j), rtol=1e-12)


@pytest.mark.parametrize("norm_kind", ["one", "inf"])
def test_gecondest_matches_jax(norm_kind):
    """From one packed LU factor with its row permutation (A[perm] = L U)."""
    from jax import lax
    a = np.random.default_rng(43).standard_normal((30, 30)) + 3 * np.eye(30)
    lu, _, perm = (np.array(x) for x in lax.linalg.lu(a))
    anorm = np.abs(a).sum(0 if norm_kind == "one" else 1).max()
    want = sj.gecondest(lu, perm, anorm, norm_kind=norm_kind)
    got = st.gecondest(torch.from_numpy(lu), torch.from_numpy(perm), anorm,
                       norm_kind=norm_kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    exact = 1.0 / (anorm * np.abs(np.linalg.inv(a)).sum(0 if norm_kind == "one"
                                                         else 1).max())
    assert exact <= float(got) * (1 + 1e-10)     # an estimate never exceeds ‖A⁻¹‖
