"""Cholesky family of the PyTorch port (slate_tpu_torch) against the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU.
Tolerance: ||L_torch - L_jax||_F / ||L_jax||_F <= 1e-12 in f64 and 1e-5 in f32
(both factor the same matrix with the same blocked algorithm; the libraries
round differently); ``info`` must be identical.
"""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu_torch.linalg import chol as tchol

FACTOR_RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _spd(n, seed, dtype=np.float64):
    """M M^T / n + 2 I, the way bench.py builds its potrf input."""
    m = np.random.default_rng(seed).standard_normal((n, n))
    return (m @ m.T / n + 2.0 * np.eye(n)).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _both_potrf(a, opts, uplo="lower", nb=64):
    """potrf through both packages on HermitianMatrix wrappers; returns
    (factor_jax, info_jax, stored_jax, factor_torch, info_torch, stored_torch)."""
    Aj = sj.HermitianMatrix.from_array(uplo, a.copy(), nb=nb)
    Fj, ij = sj.potrf(Aj, opts)
    At = st.HermitianMatrix.from_array(uplo, a.copy(), nb=nb, device="cpu")
    Ft, it = st.potrf(At, opts)
    return (np.asarray(Fj), int(ij), np.asarray(Aj.array),
            Ft.numpy(), int(it), At.array.numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,nb", [(300, 64), (640, 512)], ids=["ragged", "recursive"])
@pytest.mark.parametrize("target", ["tiled", "xla"])
def test_potrf_matches_jax(target, n, nb, dtype):
    """n=300, nb=64 leaves a ragged last block; n=640, nb=512 factors a
    512 diagonal block through the recursive _chol_blocked (base 256)."""
    a = _spd(n, n, dtype)
    opts = {"target": target, "block_size": nb}
    Fj, ij, Sj, Ft, it, St = _both_potrf(a, opts, nb=nb)
    assert ij == it == 0
    assert Ft.dtype == Fj.dtype
    assert _rel(Ft, Fj) <= FACTOR_RTOL[dtype]
    # write-back into the stored (lower) triangle only
    np.testing.assert_array_equal(np.triu(St, 1), np.triu(a, 1))
    assert _rel(np.tril(St), np.tril(Sj)) <= FACTOR_RTOL[dtype]


@pytest.mark.parametrize("inv_trsm", [False, True], ids=["trsm", "inv-trsm"])
@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_potrf_tiled_upper_and_trsm_via_inverse(uplo, inv_trsm):
    a = _spd(300, 3)
    opts = {"target": "tiled", "block_size": 64, "trsm_via_inverse": inv_trsm}
    Fj, ij, Sj, Ft, it, St = _both_potrf(a, opts, uplo=uplo)
    assert ij == it == 0
    assert _rel(Ft, Fj) <= 1e-12
    keep = np.tril if uplo == "upper" else np.triu
    # the unstored triangle is untouched, the stored one holds the factor
    np.testing.assert_array_equal(keep(St, -1 if uplo == "upper" else 1),
                                  keep(a, -1 if uplo == "upper" else 1))
    np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-12)
    F = Ft if uplo == "lower" else Ft.T
    assert np.linalg.norm(F @ F.T - a) / np.linalg.norm(a) < 1e-14


def test_potrf_does_not_mutate_callers_tensor():
    a = torch.from_numpy(_spd(200, 4))
    keep = a.clone()
    for target in ("tiled", "xla"):
        opts = {"target": target, "block_size": 64}
        st.potrf(st.HermitianMatrix.from_array("lower", a, nb=64), opts)
        st.potrf(a, opts)
        st.posv(a, torch.ones((200, 2), dtype=a.dtype), opts)
        assert torch.equal(a, keep)


def _lower_only(n, seed):
    a = _spd(n, seed)
    return a, np.tril(a) + np.triu(np.full((n, n), np.nan), 1)


@pytest.mark.parametrize("n", [200, 300])
def test_factorizations_read_only_the_lower_triangle(n):
    """The trailing updates maintain only the lower half, so every library
    Cholesky call must ignore the upper triangle (chol.py:114-124)."""
    a, poisoned = _lower_only(n, 5)
    ref = np.linalg.cholesky(a)
    t = torch.from_numpy(poisoned)
    assert np.abs(tchol._cholesky(t).numpy() - ref).max() < 1e-12
    assert np.abs(tchol._chol_blocked(t).numpy() - ref).max() < 1e-12
    L = tchol._potrf_tiled(t.clone(), 64).numpy()
    assert np.abs(L - ref).max() < 1e-12
    # and through the public driver: a wrapper whose upper triangle is NaN
    F, info = st.potrf(st.HermitianMatrix.from_array("lower", t, nb=64),
                       {"target": "tiled", "block_size": 64})
    assert int(info) == 0 and np.abs(F.numpy() - ref).max() < 1e-12


def _not_spd():
    """8 x 8 SPD matrix with a[3, 3] = -50: LAPACK's first bad pivot is 4."""
    a = np.random.default_rng(11).standard_normal((8, 8))
    a = a @ a.T + 8 * np.eye(8)
    a[3, 3] = -50.0
    return a


@pytest.mark.parametrize("exact", [False, True], ids=["default", "exact_info"])
@pytest.mark.parametrize("target", ["tiled", "xla"])
def test_info_parity_not_spd(target, exact):
    """XLA NaN-fills a failed Cholesky (info 1 from the factor diagonal);
    exact_info refines to LAPACK's index 4.  The port must agree."""
    a = _not_spd()
    opts = {"target": target, "exact_info": exact}
    _, ij = sj.potrf(a, opts)
    _, it = st.potrf(torch.from_numpy(a), opts)
    assert int(it) == int(ij) == (4 if exact else 1)
    assert it.dtype == torch.int32


@pytest.mark.parametrize("nb", [2, 3, 5])
def test_info_parity_blocked(nb):
    """With small blocks the failing block's first index is reported."""
    a = _not_spd()
    for exact in (False, True):
        opts = {"target": "tiled", "block_size": nb, "exact_info": exact}
        _, ij = sj.potrf(a, opts)
        _, it = st.potrf(torch.from_numpy(a), opts)
        assert int(it) == int(ij) != 0


@pytest.mark.parametrize("where", [(20, 20), (21, 18), (35, 3)], ids=str)
def test_info_parity_nan_input(where):
    """A NaN in the input flows through the JAX package's factorization from
    the first pivot that depends on it, so info names that pivot; the port
    marks its library Cholesky's failure the same way.  (exact_info reports 0
    here in both packages: its host pass does not see the NaN.)"""
    a = _spd(40, 12)
    a[where] = a[where[::-1]] = np.nan
    for target in ("tiled", "xla"):
        for exact in (False, True):
            opts = {"target": target, "block_size": 16, "exact_info": exact}
            _, ij = sj.potrf(a, opts)
            _, it = st.potrf(torch.from_numpy(a), opts)
            assert int(it) == int(ij), (target, exact)


def test_posv_and_potrs_match_jax():
    n = 300
    a = _spd(n, 13)
    # a non-symmetric right-hand side: a wrong triangular-solve flag would
    # still pass on symmetric data
    b = np.random.default_rng(14).standard_normal((n, 7))
    for target in ("tiled", "xla"):
        opts = {"target": target, "block_size": 64}
        Xj, ij = sj.posv(sj.HermitianMatrix.from_array("lower", a, nb=64),
                         sj.Matrix.from_array(b.copy()), opts)
        Bt = st.Matrix.from_array(b.copy(), device="cpu")
        Xt, it = st.posv(st.HermitianMatrix.from_array("lower", a, nb=64,
                                                       device="cpu"), Bt, opts)
        assert int(ij) == int(it) == 0
        assert _rel(Xt, Xj) <= 1e-12
        assert torch.equal(Bt.array, Xt)     # the wrapper holds the solution
    L = np.linalg.cholesky(a)
    for uplo, F in (("lower", L), ("upper", L.T)):
        Xj = sj.potrs(F, b, uplo=uplo)
        Xt = st.potrs(torch.from_numpy(F), torch.from_numpy(b), uplo=uplo)
        assert _rel(Xt, Xj) <= 1e-12
        assert _rel(Xt, np.linalg.solve(a, b)) <= 1e-12


def test_posv_solve_report():
    a, b = _spd(32, 15), np.ones((32, 1))
    X, info, rep = st.posv(torch.from_numpy(a), torch.from_numpy(b),
                           {"solve_report": True})
    _, _, rep_j = sj.posv(a, b, {"solve_report": True})
    assert (rep.routine, rep.info, rep.fallback_chain, rep.recovered) == \
        (rep_j.routine, rep_j.info, rep_j.fallback_chain, rep_j.recovered)
    assert rep.precision_used == rep_j.precision_used == "float64"


def test_posv_core_batched_info():
    a = np.stack([_spd(24, 16), _not_spd_24()])
    b = np.random.default_rng(17).standard_normal((2, 24, 3))
    xt, it = tchol.posv_core(torch.from_numpy(a), torch.from_numpy(b))
    xj, ij = sj.linalg.posv_core(a[0], b[0])
    assert _rel(xt[0], xj) <= 1e-12
    assert int(it[0]) == int(ij) == 0
    assert int(it[1]) != 0 and torch.isnan(xt[1]).all()


def _not_spd_24():
    a = _spd(24, 18)
    a[5, 5] = -100.0
    return a


def test_trtri_trtrm_potri_match_jax():
    n = 48
    rng = np.random.default_rng(19)
    t = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    for uplo, tt in (("lower", t), ("upper", t.T.copy())):
        for diag in ("nonunit", "unit"):
            inv_j = sj.trtri(tt, uplo=uplo, diag=diag)
            inv_t = st.trtri(torch.from_numpy(tt), uplo=uplo, diag=diag)
            assert _rel(inv_t, inv_j) <= 1e-12
        assert _rel(st.trtrm(torch.from_numpy(tt), uplo=uplo),
                    sj.trtrm(tt, uplo=uplo)) <= 1e-12
    a = _spd(n, 20)
    Aj = sj.HermitianMatrix.from_array("lower", a.copy(), nb=16)
    sj.potrf(Aj)
    sj.potri(Aj)
    At = st.HermitianMatrix.from_array("lower", a.copy(), nb=16, device="cpu")
    st.potrf(At)
    st.potri(At)
    assert _rel(At.array, Aj.array) <= 1e-12
    inv = At.array.numpy()
    full = np.tril(inv) + np.tril(inv, -1).T
    np.testing.assert_allclose(full @ a, np.eye(n), atol=1e-10)


def test_trtri_writes_only_the_stored_triangle():
    n = 8
    t = np.tril(np.random.default_rng(21).standard_normal((n, n))) + n * np.eye(n)
    poison = t + np.triu(np.full((n, n), 7.0), 1)
    T = st.TriangularMatrix.from_array("lower", poison.copy(), nb=4, device="cpu")
    st.trtri(T)
    got = T.array.numpy()
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(poison, 1))
    np.testing.assert_allclose(np.tril(got) @ t, np.eye(n), atol=1e-10)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("uplo", ["lower", "upper"])
@pytest.mark.parametrize("diag", ["nonunit", "unit"])
def test_trsm_flags_match_jax(side, uplo, diag):
    """Triangular-solve flags on a non-symmetric right-hand side."""
    n, k = 12, 5
    rng = np.random.default_rng(22)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, k) if side == "left" else (k, n))
    Xj = sj.trsm(side, 2.0, sj.TriangularMatrix.from_array(uplo, a, diag=diag),
                 sj.Matrix.from_array(b.copy()))
    Bt = st.Matrix.from_array(b.copy(), device="cpu")
    Xt = st.trsm(side, 2.0, st.TriangularMatrix.from_array(uplo, a, diag=diag,
                                                          device="cpu"), Bt)
    assert _rel(Xt, Xj) <= 1e-13
    assert torch.equal(Bt.array, Xt)
