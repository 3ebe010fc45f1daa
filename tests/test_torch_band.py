"""Band and Hermitian-indefinite solvers of the PyTorch port
(slate_tpu_torch.linalg.band, .indefinite) against the JAX package's:
gbmm/hbmm/tbsm/tbsm_pivots, pbtrf/pbtrs/pbsv, gbtrf/gbtrs/gbsv with BandLU,
hetrf/hetrs/hesv with HermitianFactors, and factors carried across with
``from_reference_factors``.

Inputs come from a numpy seed and go through both packages on the CPU, at
n = 45 (ragged against nb = 8) with kl = 5, ku = 3, kd = 4.  Tolerances:
the products, factors and solutions agree within 1e-12 relative (Frobenius)
in f64 — the same windowed algorithm, with the library panel LU / Cholesky
of each package; ``info`` codes equal; permutations identical.
"""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu_torch.core.matrix import from_reference_factors

N, NB, KL, KU, KD = 45, 8, 5, 3, 4
OPTS = {"block_size": NB}


def _band(n, kl, ku, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    r, c = np.indices((n, n))
    a = np.where((c - r <= ku) & (r - c <= kl), a, 0.0)
    return a


def _spd_band(n, kd, seed):
    a = _band(n, kd, kd, seed)
    a = (a + a.T) / 2
    return a + np.diag(np.abs(a).sum(1) + 1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


# ---------------------------------------------------------------------------
# band BLAS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vec", [False, True], ids=["matrix", "vector"])
def test_gbmm_matches_jax(vec):
    a = _band(N, KL, KU, 1)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((N,) if vec else (N, 3))
    c = rng.standard_normal(b.shape)
    got = st.gbmm(2.0, _t(a), _t(b), 0.5, _t(c), OPTS, kl=KL, ku=KU)
    want = sj.gbmm(2.0, a, b, 0.5, c, OPTS, kl=KL, ku=KU)
    assert _rel(got, want) <= 1e-12
    assert _rel(got, 2.0 * a @ b + 0.5 * c) <= 1e-12
    Aw = st.BandMatrix(N, N, KL, KU, NB, dtype=torch.float64, device="cpu")
    Aw.set_array(_t(a))
    assert _rel(st.gbmm(2.0, Aw, _t(b), 0.5, _t(c), OPTS), want) <= 1e-12


@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_hbmm_matches_jax(uplo):
    a = _spd_band(N, KD, 3)
    stored = np.tril(a) if uplo == "lower" else np.triu(a)
    b = np.random.default_rng(4).standard_normal((N, 2))
    got = st.hbmm("left", 1.0, _t(stored), _t(b), 0.0, _t(np.zeros_like(b)), OPTS,
                  uplo=uplo, kd=KD)
    want = sj.hbmm("left", 1.0, stored, b, 0.0, np.zeros_like(b), OPTS, uplo=uplo, kd=KD)
    assert _rel(got, want) <= 1e-12 and _rel(got, a @ b) <= 1e-12
    with pytest.raises(st.SlateError, match="side='left'"):
        st.hbmm("right", 1.0, _t(stored), _t(b), 0.0, _t(b), uplo=uplo, kd=KD)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("diag", ["nonunit", "unit"])
@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_tbsm_matches_jax(uplo, diag, trans):
    kl, ku = (KD, 0) if uplo == "lower" else (0, KD)
    a = _band(N, kl, ku, 5) + 4 * np.eye(N)
    b = np.random.default_rng(6).standard_normal((N, 2))
    got = st.tbsm("left", 1.5, _t(a), _t(b), OPTS, uplo=uplo, diag=diag, trans=trans, kd=KD)
    want = sj.tbsm("left", 1.5, a, b, OPTS, uplo=uplo, diag=diag, trans=trans, kd=KD)
    assert _rel(got, want) <= 1e-12
    T = a.copy()
    if diag == "unit":
        np.fill_diagonal(T, 1.0)
    op = T.T if trans else T
    x = got.numpy()     # backward error: the unit-diagonal systems are ill-conditioned
    assert (np.linalg.norm(op @ x - 1.5 * b)
            / (np.linalg.norm(op) * np.linalg.norm(x))) <= 1e-14


# ---------------------------------------------------------------------------
# band Cholesky
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_pbsv_matches_jax(uplo):
    a = _spd_band(N, KD, 7)
    stored = np.tril(a) if uplo == "lower" else np.triu(a)
    b = np.random.default_rng(8).standard_normal((N, 3))
    L, info = st.pbtrf(_t(stored), OPTS, uplo=uplo, kd=KD)
    Lj, infoj = sj.pbtrf(stored, OPTS, uplo=uplo, kd=KD)
    assert int(info) == int(infoj) == 0 and _rel(L, Lj) <= 1e-12
    x = st.pbtrs(L, _t(b), OPTS, kd=KD)
    assert _rel(x, sj.pbtrs(Lj, b, OPTS, kd=KD)) <= 1e-12
    X, info = st.pbsv(_t(stored), _t(b), OPTS, uplo=uplo, kd=KD)
    Xj, infoj = sj.pbsv(stored, b, OPTS, uplo=uplo, kd=KD)
    assert int(info) == int(infoj) == 0 and _rel(X, Xj) <= 1e-12
    assert _rel(a @ X.numpy(), b) <= 1e-12


def test_pbtrf_info_and_wrapper():
    a = _spd_band(N, KD, 9)
    a[20, 20] = -50.0
    L, info = st.pbtrf(_t(np.tril(a)), OPTS, kd=KD)
    Lj, infoj = sj.pbtrf(np.tril(a), OPTS, kd=KD)
    assert int(info) == int(infoj) > 0
    good = _spd_band(N, KD, 10)
    Aw = st.HermitianBandMatrix("lower", N, KD, NB, dtype=torch.float64, device="cpu")
    Aw.set_array(_t(np.tril(good)))
    b = np.ones((N, 1))
    X, info = st.pbsv(Aw, _t(b), OPTS)
    assert int(info) == 0 and _rel(good @ X.numpy(), b) <= 1e-12


# ---------------------------------------------------------------------------
# band LU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vec", [False, True], ids=["matrix", "vector"])
def test_gbsv_matches_jax(vec):
    a = _band(N, KL, KU, 11)
    b = np.random.default_rng(12).standard_normal((N,) if vec else (N, 4))
    fac, info = st.gbtrf(_t(a), OPTS, kl=KL, ku=KU)
    facj, infoj = sj.gbtrf(a, OPTS, kl=KL, ku=KU)
    assert int(info) == int(infoj) == 0
    assert _rel(fac.lu, facj.lu) <= 1e-12
    np.testing.assert_array_equal(fac.perms.numpy(), np.asarray(facj.perms))
    assert (fac.kl, fac.ku, fac.nb) == (facj.kl, facj.ku, facj.nb)
    x = st.gbtrs(fac, _t(b), OPTS)
    assert _rel(x, sj.gbtrs(facj, b, OPTS)) <= 1e-12
    X, info = st.gbsv(_t(a), _t(b), OPTS, kl=KL, ku=KU)
    assert int(info) == 0 and _rel(a @ X.numpy(), b) <= 1e-12
    # the forward sweep alone, through tbsm_pivots / tbsmPivots
    y = st.tbsm_pivots("left", 1.0, fac.lu, fac, _t(np.atleast_2d(b.T).T), OPTS, uplo="lower")
    yj = sj.tbsm_pivots("left", 1.0, facj.lu, facj, np.atleast_2d(b.T).T, OPTS, uplo="lower")
    assert _rel(y, yj) <= 1e-12 and st.tbsmPivots is st.tbsm_pivots


def test_gbtrs_with_factors_carried_across():
    """A BandLU of the JAX package, rebuilt as the port's, solves the same."""
    a = _band(N, KL, KU, 13)
    b = np.random.default_rng(14).standard_normal((N, 2))
    facj, _ = sj.gbtrf(a, OPTS, kl=KL, ku=KU)
    d = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in facj._asdict().items()}
    fac = from_reference_factors(d, device="cpu")
    assert isinstance(fac, st.linalg.BandLU)
    assert _rel(st.gbtrs(fac, _t(b)), sj.gbtrs(facj, b)) <= 1e-12


def test_gbtrf_singular_info_equals_jax():
    a = _band(N, KL, KU, 15)
    a[:, 17] = 0.0
    _, info = st.gbtrf(_t(a), OPTS, kl=KL, ku=KU)
    _, infoj = sj.gbtrf(a, OPTS, kl=KL, ku=KU)
    assert int(info) == int(infoj) > 0


# ---------------------------------------------------------------------------
# Hermitian indefinite (Aasen)
# ---------------------------------------------------------------------------


def _indefinite(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return (M + M.T) / 2


@pytest.mark.parametrize("n", [40, 45], ids=["even", "ragged"])
def test_hesv_matches_jax(n):
    a = _indefinite(n, 16)
    b = np.random.default_rng(17).standard_normal((n, 3))
    fac, info = st.hetrf(_t(a), OPTS)
    facj, infoj = sj.hetrf(a, OPTS)
    assert int(info) == int(infoj) == 0
    np.testing.assert_array_equal(fac.perm.numpy(), np.asarray(facj.perm))
    np.testing.assert_array_equal(fac.inv_perm.numpy(), np.asarray(facj.inv_perm))
    assert _rel(fac.L, facj.L) <= 1e-12 and _rel(fac.T, facj.T) <= 1e-12
    P = np.eye(n)[fac.perm.numpy()]
    L, T = fac.L.numpy(), fac.T.numpy()
    assert _rel(L @ T @ L.T, P @ a @ P.T) <= 1e-12
    x = st.hetrs(fac, _t(b))
    assert _rel(x, sj.hetrs(facj, b)) <= 1e-12
    X, info = st.hesv(_t(a), _t(b), OPTS)
    assert int(info) == 0 and _rel(a @ X.numpy(), b) <= 1e-12


def test_hetrs_with_factors_carried_across_and_aliases():
    a = _indefinite(N, 18)
    b = np.random.default_rng(19).standard_normal(N)
    facj, _ = sj.hetrf(a, OPTS)
    d = {k: (v._asdict() if hasattr(v, "_asdict") else v) for k, v in facj._asdict().items()}
    d["T_fac"] = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in d["T_fac"].items()}
    d = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in d.items()}
    fac = from_reference_factors(d, device="cpu")
    assert isinstance(fac, st.linalg.HermitianFactors)
    assert _rel(st.hetrs(fac, _t(b)), sj.hetrs(facj, b)) <= 1e-12
    assert st.sysv is st.hesv and st.sytrf is st.hetrf and st.sytrs is st.hetrs


def test_hesv_solve_report_and_wrapper():
    a = _indefinite(24, 20)
    Aw = st.HermitianMatrix.from_array("lower", np.tril(a), nb=8, device="cpu")
    X, info, rep = st.hesv(Aw, _t(np.ones((24, 1))), {"block_size": 8, "solve_report": True})
    Xj, infoj, repj = sj.hesv(sj.HermitianMatrix.from_array("lower", np.tril(a), nb=8),
                              np.ones((24, 1)), {"block_size": 8, "solve_report": True})
    assert int(info) == int(infoj) == 0
    assert rep.fallback_chain == repj.fallback_chain == ("aasen",)
    assert rep.precision_used == repj.precision_used and rep.recovered
    assert _rel(X, Xj) <= 1e-12
