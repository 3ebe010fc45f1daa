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


# ---------------------------------------------------------------------------
# the general solvers' path of chip_smoke.py (LU, least squares, mixed
# precision, ladders) at a small size on the CPU, against the JAX package
# (f32 quantities to rtol 1e-4: two f32 factorizations of one matrix; f64 and
# info codes, iteration counts and report chains as stated per check)
# ---------------------------------------------------------------------------

import chip_smoke as cs  # noqa: E402

SMALL = {"n": 192, "nrhs": 10, "calu_nb": 64, "calu_ib": 32, "ls_m": 1024,
         "ls_n": 64, "ls_nrhs": 16, "mixed_n": 192}


def test_general_path_matches_jax():
    got = cs.general_path("cpu", SMALL)
    cs.check_general_path(got, SMALL)
    n, k = SMALL["n"], SMALL["nrhs"]
    a = cs.randn((n, n), torch.float32, "cpu", cs.SEED + 10).numpy()
    b = cs.randn((n, k), torch.float32, "cpu", cs.SEED + 11).numpy()
    lu, perm, info = sj.getrf(a.copy())
    assert int(info) == got["gesv_info"] == 0
    for kind in ("one", "inf"):
        want = sj.gecondest(lu, perm, sj.norm(kind, a), norm_kind=kind)
        np.testing.assert_allclose(got[f"gecondest_{kind}"], float(want), rtol=1e-4)
    sing = a.copy()
    sing[:, n // 3] = 0.0
    assert got["singular_gesv_info"] == int(sj.gesv(sing, b)[2]) > 0
    for panel in ("tournament", "pp"):
        _, _, info = sj.getrf(a.copy(), {"method_lu": "calu", "block_size": 64,
                                         "inner_blocking": 32, "lu_panel": panel})
        assert got[f"calu_{panel}_info"] == int(info) == 0
    bm = cs.randn((n, k), torch.float64, "cpu", cs.SEED + 15).numpy()
    g = cs.randn((n, n), torch.float64, "cpu", cs.SEED + 17).numpy()
    *_, iters, rep = sj.linalg.gesv_mixed(g, bm, {"solve_report": True})
    assert (got["gesv_mixed_iters"], got["gesv_mixed_chain"]) == \
        (int(iters), rep.fallback_chain)
    assert set(got["times"]) >= {"gesv_s", "calu_tournament_s", "calu_pp_s",
                                 "gels_cholqr_s", "gels_qr_s", "posv_mixed_s"}


def test_small_general_and_the_card_check_on_the_cpu():
    """The n = 4096 phase (here n = 96) with its forced escalations, and the
    card-vs-CPU routine list on the CPU against the JAX package."""
    res = cs.small_general("cpu", 96)
    cs.check_small_general(res, 96)
    host = cs.general_routines("cpu", 64)
    assert cs.compare_general_routines(host, host)
    rng = np.random.default_rng(cs.SEED + 30)
    g = rng.standard_normal((64, 64))      # the routine list's first two draws
    b = rng.standard_normal((64, 3))
    X, _, info = sj.gesv(g, b)
    assert host["gesv_xla_info"] == int(info) == 0
    assert np.linalg.norm(host["gesv_xla"].numpy() - np.asarray(X)) \
        <= 1e-12 * np.linalg.norm(np.asarray(X))


def test_lu_route_phase_on_the_cpu():
    """Phase 17 of chip_smoke.py (the pivot kernels' checks, the private copy
    and NaN guard against the library route's, and the lookahead
    route against the library route) at a small size on the CPU, where the
    kernels take their plain versions.  Both routes name the zeroed pivot as
    the JAX package does, and the NaN on the diagonal as LAPACK does."""
    lists = cs.pivot_kernel_checks("cpu", cases=((1, 1, 0), (7, 7, 93), (64, 500, 0),
                                                 (64, 100, 400)), mover_shape=(300, 50),
                                   hpl_mover=(160, 16), panel_shape=(120, 16))
    assert lists["pivot_moves_w7_mw7_live"] > 0
    assert lists["move_rows_hpl_n160_pairs"] == 32
    assert lists["panel_lu_float64_diff"] == 0.0
    guard = cs.nan_guard_checks("cpu", shape=(9, 7), hpl_n=160)
    assert guard["nan_guard_small_cases"] == 4 * 6 * 7 + 2 * 6
    assert guard["nan_guard_hpl_n160_info"] == 160 // 2 + 8
    res = cs.lu_route_checks("cpu", {"check_n": (160,), "info_n": 96})
    assert res["probe_error_lookahead_n160"] < 1e-15
    assert res["info_n160"] == (0, 0)
    A = cs.hpl_matrix(96, cs.SEED, "cpu")
    A.diagonal().add_(96.0)
    sing = A.numpy().copy()
    sing[:, 32] = sing[32, :] = 0.0
    assert res["info_singular"] == (int(sj.getrf(sing)[2]),) * 2 == (33, 33)
    assert res["info_nan"] == (49, 49)


# ---------------------------------------------------------------------------
# the serving phase of chip_smoke.py (slate_tpu_torch.serve) at a small size
# on the CPU: every part of serve_path with its checks, and the card-vs-CPU
# request list against the JAX package's packer (f32 requests: X to rtol
# 1e-4, info identical)
# ---------------------------------------------------------------------------

SMALL_SERVE = {"requests": 150, "scale_requests": 90, "executor_counts": (1, 2),
               "ab_requests": 40, "ab_rounds": 1, "burst": 40,
               "check_requests": 24, "device_requests": 24, "start_batch": 8,
               "start_n": 16}


def test_serve_path_on_the_cpu(tmp_path):
    res = cs.serve_path("cpu", SMALL_SERVE, str(tmp_path / "flight.json"))
    cs.check_serve_path(res, SMALL_SERVE)
    assert res["mixed"]["requests"] == 150
    assert res["mixed"]["distinct_buckets"] >= 4
    assert set(res["times"]) == {"start_s", "mixed_s", "scale_s",
                                 "continuous_s", "ab_s", "chaos_s",
                                 "device_operands_s"}
    assert res["chaos"]["worker_crash"]["capacity_fraction"] == 0.5


def test_serve_check_matches_jax():
    host = cs.serve_check("cpu", SMALL_SERVE["check_requests"])
    cmp = cs.compare_serve_check(host, host)
    assert cmp["worst_backward_error_over_gate"] <= 1.0
    reqs = sj.serve.make_requests(SMALL_SERVE["check_requests"], seed=9)
    want = sj.serve.solve_many(reqs)
    for got, (xj, ij) in zip(host["requests"], want):
        xj = np.asarray(xj, dtype=np.float64)
        assert got["info"] == int(ij) == 0
        assert np.linalg.norm(got["x"] - xj) <= 1e-4 * np.linalg.norm(xj)


# ---------------------------------------------------------------------------
# the eigenvalue and SVD slice: a HermitianMatrix of the JAX package carried
# across with from_reference_state, then heev and svd through the top-level
# names against the JAX package's (f64: values within 1e-12·‖A‖₂, vectors by
# the sign-free test |diag(Z_jaxᵀ Z_port)| >= 1 − 1e-10); and the eig phase
# of chip_smoke.py at a small size on the CPU with its checks (the f32 gates)
# ---------------------------------------------------------------------------

SMALL_EIG = {"n": 96, "two_stage_n": 64, "small_n": 64, "method_n": 40,
             "check_n": 48, "range_k": 8, "band_k": 4}


@pytest.mark.parametrize("method", ["fused", "two_stage"])
def test_eig_slice_matches_jax(method):
    rng = np.random.default_rng(5)
    m = rng.standard_normal((48, 48))
    a = (m + m.T) / 2
    Aj = sj.HermitianMatrix.from_array("upper", np.triu(a), nb=16)
    state = {"class": "HermitianMatrix", "array": np.asarray(Aj.array),
             "uplo": "upper", "nb": 16}
    At = st.core.matrix.from_reference_state(state, device="cpu")
    opts = {"block_size": 16}
    lam, Z = st.heev(At, opts, method=method, chase_pipeline=True)
    lam_j, Z_j = sj.heev(Aj, opts, method=method)
    scale = np.abs(np.asarray(lam_j)).max()
    assert np.abs(lam.numpy() - np.asarray(lam_j)).max() <= 1e-12 * scale
    assert np.abs(np.sum(Z.numpy() * np.asarray(Z_j), axis=0)).min() >= 1 - 1e-10
    S, U, VT = st.svd(st.Matrix.from_array(m, nb=16, device="cpu"), opts, method=method,
                      chase_pipeline=True)
    S_j, U_j, VT_j = sj.svd(sj.Matrix.from_array(m, nb=16), opts, method=method)
    assert np.abs(S.numpy() - np.asarray(S_j)).max() <= 1e-12 * float(S_j[0])
    assert np.abs(np.sum(U.numpy() * np.asarray(U_j), axis=0)).min() >= 1 - 1e-10


def test_eig_path_on_the_cpu():
    res = cs.eig_path("cpu", SMALL_EIG)
    cs.check_eig_path(res, SMALL_EIG)
    assert res["svd_driver"] == "gesvd"
    assert set(res["times"]) >= {"heev_values_s", "heev_vectors_s", "svd_vals_s",
                                 "heev_two_stage_values_s", "svd_two_stage_values_s"}
    assert set(res["heev_two_stage_phases"]) >= {"heev::he2hb", "heev::hb2st", "heev::stev"}
    assert set(res["svd_two_stage_phases"]) >= {"svd::ge2tb", "svd::bdsqr"}
    n = SMALL_EIG["n"]
    a = cs.sym_normal(n, torch.float32, "cpu", cs.SEED + 50).numpy()
    lam_j, _ = sj.heev(a, uplo="lower", want_vectors=False)
    lam, _ = st.heev(torch.from_numpy(a), uplo="lower", want_vectors=False)
    assert np.abs(lam.numpy() - np.asarray(lam_j)).max() <= 1e-5 * np.abs(lam_j).max()


def test_small_eig_and_the_card_check_on_the_cpu():
    """The n = 4096 / 512 checks (here 64 / 40) and the card-vs-CPU routine
    list on the CPU, its first entries against the JAX package."""
    res = cs.small_eig("cpu", SMALL_EIG)
    cs.check_small_eig(res, SMALL_EIG)
    host = cs.eig_routines("cpu", SMALL_EIG["check_n"])
    assert cs.compare_eig_routines(host, host)
    n = SMALL_EIG["check_n"]
    g = np.random.default_rng(cs.SEED + 70).standard_normal((n, n))
    a = (g + g.T) / 2
    lam_j = np.asarray(sj.heev(a, method="two_stage")[0])
    assert np.abs(host["heev_auto_values"].numpy() - lam_j).max() <= 1e-12 * np.abs(lam_j).max()
    assert host["pbsv_info"] == host["gbsv_info"] == host["hesv_info"] == 0
    assert host["gbtrf_singular_info"] > 0 and host["pbtrf_non_spd_info"] > 0
