"""Tridiagonal eigensolvers of the PyTorch port — Sturm bisection and inverse
iteration (sturm), implicit-shift QR (steqr_qr) and divide & conquer (stedc) —
against the JAX package's.

Inputs come from a numpy seed and go through both packages on the CPU.
Tolerances:
* f64 eigenvalues of ``sterf_bisect``, ``steqr_qr`` and ``stedc`` agree with
  the JAX package's within 1e-12·‖T‖; ``sturm_count_interval`` counts are
  equal; f32 eigenvalues within 1e-5·‖T‖;
* vectors (free column signs) on spectra with gaps above 1e-6·‖T‖:
  |diag(Z_jaxᵀ Z_port)| >= 1 - 1e-10; on clustered spectra the tester's
  gate ‖TZ − ZΛ‖/‖T‖ + ‖I − ZᵀZ‖/n <= 50·eps·√n;
* ``info`` codes equal.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import slate_tpu_torch as st
from slate_tpu.linalg import steqr_qr as jq
from slate_tpu.linalg import sturm as jst
from slate_tpu_torch.linalg import steqr_qr as tq
from slate_tpu_torch.linalg import sturm as tst

jsd = importlib.import_module("slate_tpu.linalg.stedc")
tsd = importlib.import_module("slate_tpu_torch.linalg.stedc")

N = 70          # stedc splits twice (base 32): one merge of 35 + 35 over two leaves each


def _tridiag(n, seed, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal(n), rng.standard_normal(n - 1)
    if kind == "signed":
        return rng.standard_normal(n), -np.abs(rng.standard_normal(n - 1))
    # clustered: a many-fold cluster at 1 plus a few outliers (trips the
    # Newton–Schulz repair gate of the stedc merge)
    d = np.ones(n)
    d[:3] = [-2.0, 3.0, 5.0]
    return d, 1e-9 * rng.standard_normal(n - 1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tnorm(d, e):
    return np.abs(d).max() + 2 * np.abs(e).max()


def _dense(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _sign_free(Zj, Zt, tol=1e-10):
    dots = np.abs(np.sum(np.asarray(Zj) * np.asarray(Zt), axis=0))
    assert dots.min() >= 1 - tol, dots.min()


def _gate(d, e, lam, Z):
    T = _dense(d, e)
    n = len(d)
    res = (np.linalg.norm(T @ Z - Z * lam) / np.linalg.norm(T)
           + np.linalg.norm(np.eye(n) - Z.T @ Z) / n)
    assert res <= 50 * np.finfo(np.float64).eps * np.sqrt(n), res


@pytest.fixture(scope="module")
def jax_tridiag():
    """The JAX package's results, computed once for the module."""
    out = {}
    for kind in ("random", "signed", "clustered"):
        d, e = _tridiag(N, 1, kind)
        out[kind, "stedc"] = [np.asarray(x) for x in jsd.stedc(d, e)]
        out[kind, "steqr"] = [np.asarray(x) for x in jq.steqr_qr(d, e)]
    d, e = _tridiag(N, 1)
    out["bisect"] = np.asarray(jst.sterf_bisect(d, e))
    out["bisect_range"] = np.asarray(jst.sterf_bisect(d, e, il=10, iu=25))
    out["stein"] = np.asarray(jst.stein(d, e, out["bisect"][10:25]))
    return out


# ---------------------------------------------------------------------------
# Sturm bisection, counts, inverse iteration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rng_", ["all", "range"])
def test_sterf_bisect_matches_jax(jax_tridiag, rng_):
    d, e = _tridiag(N, 1)
    kw = {} if rng_ == "all" else {"il": 10, "iu": 25}
    got = tst.sterf_bisect(_t(d), _t(e), **kw).numpy()
    want = jax_tridiag["bisect" if rng_ == "all" else "bisect_range"]
    assert np.abs(got - want).max() <= 1e-12 * _tnorm(d, e)
    assert np.abs(got - np.linalg.eigvalsh(_dense(d, e))[kw.get("il", 0):kw.get("iu", N)]
                  ).max() <= 1e-12 * _tnorm(d, e)


def test_sterf_bisect_f32_and_edges():
    d, e = _tridiag(40, 2)
    got = tst.sterf_bisect(_t(d).float(), _t(e).float()).numpy()
    want = np.asarray(jst.sterf_bisect(jnp.asarray(d, jnp.float32), jnp.asarray(e, jnp.float32)))
    assert np.abs(got - want).max() <= 1e-5 * _tnorm(d, e)
    one = tst.sterf_bisect(_t([2.5]), _t(np.zeros(0)))
    assert one.tolist() == [2.5]
    with pytest.raises(ValueError, match="index range"):
        tst.sterf_bisect(_t(d), _t(e), il=5, iu=5)


@pytest.mark.parametrize("interval", [(-0.5, 0.7), (-10.0, 10.0), (0.7, -0.5), (0.1, 0.2)])
def test_sturm_count_interval_equals_jax(interval):
    d, e = _tridiag(N, 3)
    got = tst.sturm_count_interval(_t(d), _t(e), *interval)
    want = jst.sturm_count_interval(d, e, *interval)
    assert got.dtype == torch.int32 and int(got) == int(want)
    lam = np.linalg.eigvalsh(_dense(d, e))
    assert int(got) == int(((lam >= interval[0]) & (lam < interval[1])).sum())


def test_stein_matches_jax(jax_tridiag):
    d, e = _tridiag(N, 1)
    lam = jax_tridiag["bisect"][10:25]
    V = tst.stein(_t(d), _t(e), _t(lam)).numpy()
    _sign_free(jax_tridiag["stein"], V)
    T = _dense(d, e)
    assert np.linalg.norm(T @ V - V * lam) <= 1e-12 * _tnorm(d, e) * N


def test_gtsv_pivots_like_lapack():
    """The batched solve with row interchanges against numpy's dense solve,
    per shifted column (including a column that needs every interchange)."""
    rng = np.random.default_rng(4)
    n, k = 12, 5
    dl, du = rng.standard_normal(n - 1), rng.standard_normal(n - 1)
    D = 1e-3 * rng.standard_normal((n, k))
    B = rng.standard_normal((n, k))
    X = tst._gtsv(_t(dl), _t(D), _t(du), _t(B)).numpy()
    for j in range(k):
        A = np.diag(D[:, j]) + np.diag(dl, -1) + np.diag(du, 1)
        np.testing.assert_allclose(A @ X[:, j], B[:, j], atol=1e-10)


# ---------------------------------------------------------------------------
# implicit-shift QR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "signed", "clustered"])
def test_steqr_qr_matches_jax(jax_tridiag, kind):
    d, e = _tridiag(N, 1, kind)
    lam_j, Z_j = jax_tridiag[kind, "steqr"]
    lam, Z, info = tq.steqr_qr(_t(d), _t(e), return_info=True)
    assert int(info) == 0
    assert np.abs(lam.numpy() - lam_j).max() <= 1e-12 * _tnorm(d, e)
    if kind == "clustered":
        _gate(d, e, lam.numpy(), Z.numpy())
    else:
        _sign_free(Z_j, Z.numpy())


def test_steqr_qr_values_z_and_f32():
    d, e = _tridiag(40, 5)
    lam = tq.steqr_qr(_t(d), _t(e), want_vectors=False)
    assert np.abs(lam.numpy() - np.linalg.eigvalsh(_dense(d, e))).max() <= 1e-12 * _tnorm(d, e)
    Z0 = np.linalg.qr(np.random.default_rng(6).standard_normal((40, 40)))[0]
    lam2, ZQ = tq.steqr_qr(_t(d), _t(e), _t(Z0))
    lam_j, ZQ_j = jq.steqr_qr(d, e, jnp.asarray(Z0))
    _sign_free(ZQ_j, ZQ.numpy())
    l32 = tq.steqr_qr(_t(d).float(), _t(e).float(), want_vectors=False)
    assert l32.dtype == torch.float32
    lj32 = np.asarray(jq.steqr_qr(jnp.asarray(d, jnp.float32), jnp.asarray(e, jnp.float32),
                                  want_vectors=False))
    assert np.abs(l32.numpy() - lj32).max() <= 1e-5 * _tnorm(d, e)


def test_steqr_qr_budget_poisons_with_nan_and_info():
    """A spent sweep budget returns NaN eigenvalues and the count of
    undeflated off-diagonals, as the JAX package does."""
    d, e = _tridiag(30, 7)
    lam, Z, info = tq.steqr_qr(_t(d), _t(e), max_sweeps=2, return_info=True)
    lam_j, _, info_j = jq.steqr_qr(d, e, max_sweeps=2, return_info=True)
    assert int(info) == int(info_j) > 0
    assert np.isnan(lam.numpy()).all() and np.isnan(np.asarray(lam_j)).all()
    one = tq.steqr_qr(_t([3.0]), _t(np.zeros(0)), return_info=True)
    assert one[0].tolist() == [3.0] and one[1].tolist() == [[1.0]] and int(one[2]) == 0


# ---------------------------------------------------------------------------
# divide & conquer and its stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "signed", "clustered"])
def test_stedc_matches_jax(jax_tridiag, kind):
    """Signed off-diagonals fold into Q; the clustered spectrum runs the
    gated Newton–Schulz repair."""
    d, e = _tridiag(N, 1, kind)
    lam_j, Z_j = jax_tridiag[kind, "stedc"]
    lam, Z = tsd.stedc(_t(d), _t(e))
    assert np.abs(lam.numpy() - lam_j).max() <= 1e-12 * _tnorm(d, e)
    if kind == "clustered":
        _gate(d, e, lam.numpy(), Z.numpy())
    else:
        _sign_free(Z_j, Z.numpy())


def test_stedc_premultiplies_z_and_small_sizes():
    d, e = _tridiag(40, 8)
    Z0 = np.linalg.qr(np.random.default_rng(9).standard_normal((40, 40)))[0]
    lam, ZQ = st.stedc(_t(d), _t(e), _t(Z0))
    lam_j, ZQ_j = jsd.stedc(d, e, jnp.asarray(Z0))
    _sign_free(ZQ_j, ZQ.numpy())
    l1, Q1 = st.stedc(_t([1.5]), _t(np.zeros(0)))
    assert l1.tolist() == [1.5] and Q1.tolist() == [[1.0]]
    l0, Q0 = st.stedc(_t(np.zeros(0)), _t(np.zeros(0)))
    assert l0.numel() == 0 and Q0.shape == (0, 0)


def test_stedc_stage_entry_points_match_jax():
    """sort (stable on ties), z_vector, deflate, secular, merge, solve."""
    rng = np.random.default_rng(10)
    d = np.array([3.0, 1.0, 2.0, 1.0, 0.5, 2.0])
    Q = rng.standard_normal((4, 6))
    ds, Qs = st.stedc_sort(_t(d), _t(Q))
    dj, Qj = jsd.stedc_sort(d, Q)
    np.testing.assert_array_equal(ds.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(Qs.numpy(), np.asarray(Qj))
    Q1, Q2 = rng.standard_normal((3, 3)), rng.standard_normal((4, 4))
    np.testing.assert_array_equal(st.stedc_z_vector(_t(Q1), _t(Q2)).numpy(),
                                  np.asarray(jsd.stedc_z_vector(Q1, Q2)))
    dsort = np.sort(rng.standard_normal(9))
    dsort[4] = dsort[3]                              # an equal pair to space apart
    z = rng.standard_normal(9)
    dh, z2 = st.stedc_deflate(0.7, _t(dsort), _t(z))
    dhj, z2j = jsd.stedc_deflate(0.7, dsort, z)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dhj), rtol=0, atol=1e-14)
    np.testing.assert_allclose(z2.numpy(), np.asarray(z2j), rtol=1e-14)
    lam = st.stedc_secular(0.7, dh, z2).numpy()
    np.testing.assert_allclose(lam, np.asarray(jsd.stedc_secular(0.7, dhj, z2j)),
                               rtol=0, atol=1e-12)
    want = np.linalg.eigvalsh(np.diag(dh.numpy()) + 0.7 * np.outer(np.sqrt(z2), np.sqrt(z2)))
    np.testing.assert_allclose(lam, want, rtol=0, atol=1e-12)
    # one merge of two solved halves
    (da, db), (ea, eb) = (rng.standard_normal(5), rng.standard_normal(6)), (
        rng.standard_normal(4), rng.standard_normal(5))
    la, Za = np.linalg.eigh(_dense(da, ea))
    lb, Zb = np.linalg.eigh(_dense(db, eb))
    lm, Zm = st.stedc_merge(_t(la), _t(Za), _t(lb), _t(Zb), 0.4)
    lmj, Zmj = jsd.stedc_merge(la, Za, lb, Zb, 0.4)
    np.testing.assert_allclose(lm.numpy(), np.asarray(lmj), rtol=0, atol=1e-12)
    _sign_free(Zmj, Zm.numpy())
    d, e = _tridiag(40, 11)
    ls, Zs = st.stedc_solve(_t(d), _t(e))
    np.testing.assert_allclose(ls.numpy(), np.asarray(jsd.stedc_solve(d, e)[0]),
                               rtol=0, atol=1e-12 * _tnorm(d, e))


def test_stedc_chunked_secular_equals_one_chunk(monkeypatch):
    """Bracket chunks of the secular bisection (the memory bound of the
    largest merges) give the roots of one chunk, up to the summation order
    of the secular function (1e-14 absolute on O(1) data)."""
    d, e = _tridiag(N, 12)
    lam, Z = tsd.stedc(_t(d), _t(e))
    monkeypatch.setattr(tsd, "_SECULAR_BUFFER", 7 * N)
    lam_c, Z_c = tsd.stedc(_t(d), _t(e))
    np.testing.assert_allclose(lam_c.numpy(), lam.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(Z_c.numpy(), Z.numpy(), rtol=0, atol=1e-12)


def test_stedc_refuses_a_multi_device_grid():
    """stedc(grid=) no longer refuses a grid (its distributed merges are
    ported).  Below ``_DIST_MERGE_MIN`` the merges stay local, so a grid of
    any size gives the single-device result bit for bit without touching
    it; the merges over a grid are held against the JAX package in
    tests/test_torch_eig_dist.py and tests/test_torch_grid_dispatch.py."""
    class Grid:
        size = 4
    d, e = _tridiag(10, 13)
    lam_g, Q_g = tsd.stedc(_t(d), _t(e), grid=Grid())
    lam, Q = tsd.stedc(_t(d), _t(e))
    assert torch.equal(lam_g, lam) and torch.equal(Q_g, Q)


def test_sturm_guard_pass_equals_the_guarded_recurrence():
    """A shift landing exactly on a pivot (q = 0) makes the unguarded pass
    hold a pivot below pivmin: the pass is redone with stebz's guard, and the
    counts equal those of the always-guarded recurrence and the JAX package's."""
    d = np.array([1.0, 2.0, 3.0, 4.0])
    e = np.array([0.5, 0.5, 0.5])
    x = np.array([1.0, 2.5, 0.0, 10.0])            # x = d_0: q_0 = 0 exactly
    got = tst._sturm_counts(_t(d), _t(e * e), _t(x))
    want = jst._sturm_counts(jnp.asarray(d), jnp.asarray(e * e), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
