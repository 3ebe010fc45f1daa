"""The port's LAPACK-style API (slate_tpu_torch.lapack_api) against the JAX
package's (slate_tpu.lapack_api), on the CPU: the same generated names, and
every family's float64/complex128 entry point giving the JAX package's numbers
on the same numpy inputs (to RTOL relative; eigenvectors and singular vectors
are checked through their residuals, being sign-free).  Then the lapack_api
tests of tests/test_compat_api.py (:21-208, :253-260, :306+), on the port; its
ScaLAPACK half waits for the distributed tier (ROADMAP.md queue A items 15
and 16)."""

import numpy as np
import pytest
import torch

from slate_tpu import lapack_api as japi
from slate_tpu_torch import lapack_api as tapi
from slate_tpu_torch.core.exceptions import SlateError

RTOL = 1e-10
N = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on the
    machine's cores, and torch's thread pool spinning beside them made these
    tests 10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rng(seed=0):
    return np.random.default_rng(seed)


def spd(n, seed=0, dtype=np.float32):
    a = rng(seed).standard_normal((n, n)).astype(dtype)
    return a @ a.T + n * np.eye(n, dtype=dtype)


class _CPU:
    """lapack_api with every call on the CPU (the entry points' default
    device is cuda)."""

    def __getattr__(self, name):
        fn = getattr(tapi, name)
        return lambda *a, **kw: fn(*a, device="cpu", **kw)


lapi = _CPU()


def _close(got, want, rtol=RTOL):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    if want is None:
        assert got is None
        return
    if isinstance(want, (int, np.integer)) and not isinstance(want, bool):
        assert int(got) == int(want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    assert float(np.abs(got - want).max(initial=0.0)) <= rtol * scale


def _problem(cplx=False, seed=0):
    r = rng(seed)
    c = (lambda s: r.standard_normal(s) + 1j * r.standard_normal(s)) if cplx \
        else r.standard_normal
    a, b, c3 = c((N, N)), c((N, 3)), c((N, 3))
    h = a @ a.conj().T + N * np.eye(N)
    return a, b, c3, h


def test_generated_names_match_jax():
    assert tapi.__all__ == japi.__all__
    assert set(tapi._FAMILIES) == set(japi._FAMILIES) and tapi._SKIP == japi._SKIP
    assert tapi.dsgesv is tapi.dgesv_mixed and tapi.zcgesv is tapi.zgesv_mixed


def test_default_device_is_cuda():
    a = np.eye(3)
    if torch.cuda.is_available():
        assert tapi.dgesv(a, a)[2] == 0
    else:
        with pytest.raises(SlateError, match="CUDA"):
            tapi.dgesv(a, a)


@pytest.mark.parametrize("letter", ["d", "z"])
def test_blas3_and_norm_families_match_jax(letter):
    cplx = letter == "z"
    a, b, c, h = _problem(cplx, 1)
    L = np.tril(a) + N * np.eye(N)
    calls = [("gemm", ("n", "c" if cplx else "t", 1.5, a, a, 0.5, h)),
             ("symm", ("left", "lower", 2.0, h, b, 0.5, c)),
             ("syrk", ("lower", "n", 1.0, b, 0.5, h)),
             ("syr2k", ("upper", "n", 1.0, b, c, 0.5, h)),
             ("trmm", ("left", "lower", "n", "n", 2.0, L, b)),
             ("trsm", ("right", "upper", "t", "u", 1.0, L.T.copy(), b.T.copy())),
             ("lange", ("one", a)), ("lange", ("inf", a)), ("lansy", ("fro", "upper", h)),
             ("lantr", ("max", "lower", "unit", a)),
             ("laset", ("u", N, N, 2.0, 3.0, a))]
    if cplx:
        calls += [("hemm", ("right", "upper", 1.0, h, b.T.copy(), 0.0, c.T.copy())),
                  ("herk", ("upper", "c", 1.0, b.T.copy(), 1.0, h)),
                  ("her2k", ("lower", "n", 1.0, b, c, 0.0, h)),
                  ("lanhe", ("one", "lower", h))]
    for name, args in calls:
        _close(getattr(lapi, letter + name)(*args),
               getattr(japi, letter + name)(*args))


@pytest.mark.parametrize("letter", ["d", "z"])
def test_solver_families_match_jax(letter):
    cplx = letter == "z"
    a, b, _, h = _problem(cplx, 2)
    g = a + N * np.eye(N)
    calls = [("gesv", (g, b)), ("getrf", (g,)), ("posv", ("lower", h, b)),
             ("potrf", ("lower", h)), ("gels", ("n", np.vstack([a, a[:3]]),
                                                np.vstack([b, b[:3]]))),
             ("pbsv", ("lower", 2, np.triu(np.tril(h, 2), -2), b)),
             ("gbsv", (1, 2, np.triu(np.tril(g, 1), -2), b))]
    for name, args in calls:
        _close(getattr(lapi, letter + name)(*args),
               getattr(japi, letter + name)(*args))
    lu, ipiv, _ = japi.__dict__[letter + "getrf"](g)
    for name, args in (("getrs", ("c" if cplx else "t", lu, ipiv, b)),
                       ("getri", (lu, ipiv)),
                       ("gecon", ("i", lu, ipiv, np.abs(g).sum(1).max())),
                       ("trcon", ("1", "upper", "n", g))):
        _close(getattr(lapi, letter + name)(*args),
               getattr(japi, letter + name)(*args))
    lf, _ = japi.__dict__[letter + "potrf"]("lower", h)
    for name, args in (("potrs", ("lower", lf, b)), ("potri", ("lower", lf)),
                       ("pocon", ("lower", lf, np.abs(h).sum(0).max()))):
        _close(getattr(lapi, letter + name)(*args),
               getattr(japi, letter + name)(*args))
    lb, _ = japi.__dict__[letter + "pbtrf"]("lower", 2, np.triu(np.tril(h, 2), -2))
    _close(getattr(lapi, letter + "pbtrs")("lower", 2, lb, b),
           getattr(japi, letter + "pbtrs")("lower", 2, lb, b))
    sv = "zhesv" if cplx else "dsysv"
    _close(getattr(lapi, sv)("lower", h - 2 * N * np.eye(N), b),
           getattr(japi, sv)("lower", h - 2 * N * np.eye(N), b), 1e-8)
    x, _, info, _ = getattr(lapi, letter + "gesv_mixed")(g, b)
    xw, _, infow, _ = getattr(japi, letter + "gesv_mixed")(g, b)
    assert info == infow == 0
    _close(x, xw, 1e-12)


@pytest.mark.parametrize("letter", ["d", "z"])
def test_eig_svd_families_match_jax(letter):
    cplx = letter == "z"
    a, _, _, h = _problem(cplx, 3)
    ev = "he" if cplx else "sy"
    spd_b = _problem(cplx, 4)[3]
    for name, args in ((ev + "ev", ("n", "lower", h)), (ev + "evd", ("n", "upper", h)),
                       (ev + "evx", ("n", "lower", h, 3, 7)),
                       (ev + "gv", (1, "n", "lower", h, spd_b)),
                       (ev + "gvx", (1, "n", "lower", h, spd_b, 2, 5)),
                       ("gesvd", ("n", "n", a)), ("gesvdx", ("n", "n", a, 1, 4))):
        _close(getattr(lapi, letter + name)(*args),
               getattr(japi, letter + name)(*args), 1e-9)
    lam, z = getattr(lapi, letter + ev + "ev")("v", "lower", h)
    assert np.linalg.norm(h @ z - z * lam) <= 1e-12 * np.linalg.norm(h)
    s, u, vt = getattr(lapi, letter + "gesvd")("a", "s", a)
    assert u.shape == (N, N) and vt.shape == (N, N)
    assert np.linalg.norm(a - (u * s) @ vt) <= 1e-12 * np.linalg.norm(a)


def test_info_is_returned_not_raised():
    a = np.ones((6, 6))
    assert lapi.dgesv(a, np.ones((6, 1)))[2] > 0
    assert japi.dgesv(a, np.ones((6, 1)))[2] > 0
    bad = -np.eye(5)
    assert lapi.dposv("lower", bad, np.ones((5, 1)))[1] == \
        japi.dposv("lower", bad, np.ones((5, 1)))[1] > 0


def test_verbose_env(monkeypatch, capsys):
    monkeypatch.setenv("SLATE_LAPACK_VERBOSE", "1")
    lapi.dlange("one", np.ones((3, 2)))
    assert "slate_lapack: dlange ('one', (3, 2))" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the lapack_api tests of tests/test_compat_api.py, on the port

class TestBlas3:
    def test_sgemm(self):
        a = rng(1).standard_normal((12, 8)).astype(np.float32)
        b = rng(2).standard_normal((8, 10)).astype(np.float32)
        c = rng(3).standard_normal((12, 10)).astype(np.float32)
        out = lapi.sgemm("n", "n", 2.0, a, b, 0.5, c)
        np.testing.assert_allclose(out, 2.0 * a @ b + 0.5 * c, rtol=1e-4)

    def test_sgemm_trans(self):
        a = rng(1).standard_normal((8, 12)).astype(np.float32)
        b = rng(2).standard_normal((10, 8)).astype(np.float32)
        c = np.zeros((12, 10), np.float32)
        out = lapi.sgemm("t", "t", 1.0, a, b, 0.0, c)
        np.testing.assert_allclose(out, a.T @ b.T, rtol=1e-5)

    def test_zgemm_conj(self):
        r = rng(4)
        a = (r.standard_normal((6, 5)) + 1j * r.standard_normal((6, 5))).astype(np.complex64)
        b = (r.standard_normal((6, 7)) + 1j * r.standard_normal((6, 7))).astype(np.complex64)
        out = lapi.cgemm("c", "n", 1.0, a, b, 0.0, np.zeros((5, 7), np.complex64))
        np.testing.assert_allclose(out, a.conj().T @ b, rtol=1e-4)

    def test_strsm(self):
        t = np.tril(rng(5).standard_normal((8, 8))).astype(np.float32) + \
            8 * np.eye(8, dtype=np.float32)
        b = rng(6).standard_normal((8, 3)).astype(np.float32)
        x = lapi.strsm("left", "lower", "n", "n", 1.0, t, b)
        np.testing.assert_allclose(t @ x, b, rtol=1e-4, atol=1e-4)

    def test_ssyrk(self):
        a = rng(7).standard_normal((6, 4)).astype(np.float32)
        c = spd(6, 8)
        out = lapi.ssyrk("lower", "n", 1.0, a, 1.0, c)
        np.testing.assert_allclose(out, a @ a.T + c, rtol=1e-4)

    def test_slange(self):
        a = rng(9).standard_normal((10, 6)).astype(np.float32)
        assert np.isclose(lapi.slange("fro", a), np.linalg.norm(a), rtol=1e-5)
        assert np.isclose(lapi.slange("one", a), np.abs(a).sum(0).max(), rtol=1e-5)


class TestSolvers:
    def test_sgesv(self):
        n = 12
        a = rng(1).standard_normal((n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
        b = rng(2).standard_normal((n, 2)).astype(np.float32)
        x, ipiv, info = lapi.sgesv(a, b)
        assert info == 0 and ipiv.shape == (n,) and ipiv.min() >= 1
        np.testing.assert_allclose(a @ x, b, rtol=1e-3, atol=1e-3)

    def test_sgetrf_getrs_getri(self):
        n = 10
        a = rng(3).standard_normal((n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
        lu, perm, info = lapi.sgetrf(a)
        lapi.sgetrs("n", lu, perm, rng(4).standard_normal((n,)).astype(np.float32))
        inv = lapi.sgetri(lu, perm)
        np.testing.assert_allclose(a @ inv, np.eye(n), atol=1e-3)

    def test_sposv_potrf_pocon(self):
        n = 16
        a = spd(n, 5)
        b = rng(6).standard_normal((n, 2)).astype(np.float32)
        x, info = lapi.sposv("lower", a, b)
        assert info == 0
        np.testing.assert_allclose(a @ x, b, rtol=1e-2, atol=1e-3)
        lf, info = lapi.spotrf("lower", a)
        np.testing.assert_allclose(np.tril(lf) @ np.tril(lf).T, a, rtol=1e-2, atol=1e-2)
        rcond = lapi.spocon("lower", lf, lapi.slange("one", a))
        assert 0 < rcond < 1

    def test_dsgesv_mixed(self):
        n = 16
        a = spd(n, 7, np.float64)
        b = rng(8).standard_normal((n, 1))
        x, ipiv, info, iters = lapi.dsgesv(a, b)
        np.testing.assert_allclose(a @ x, b, rtol=1e-8)

    def test_sgels(self):
        a = rng(9).standard_normal((20, 6)).astype(np.float32)
        b = rng(10).standard_normal((20, 2)).astype(np.float32)
        x = lapi.sgels("n", a, b)
        expect, *_ = np.linalg.lstsq(a, b, rcond=None)
        np.testing.assert_allclose(np.asarray(x)[:6], expect, rtol=1e-3, atol=1e-3)


class TestEigSvd:
    def test_ssyev(self):
        a = spd(14, 1)
        w, z = lapi.ssyev("v", "lower", a)
        np.testing.assert_allclose(np.sort(w), np.linalg.eigvalsh(a), rtol=1e-3)
        np.testing.assert_allclose(a @ z, z * w[None, :], rtol=1e-2, atol=1e-2)

    def test_cheev(self):
        r = rng(2)
        a = (r.standard_normal((10, 10)) + 1j * r.standard_normal((10, 10))).astype(np.complex64)
        a = a @ a.conj().T + 10 * np.eye(10)
        w, _ = lapi.cheev("n", "lower", a.astype(np.complex64))
        np.testing.assert_allclose(np.sort(w), np.linalg.eigvalsh(a), rtol=1e-3)

    def test_sgesvd(self):
        a = rng(3).standard_normal((12, 8)).astype(np.float32)
        s, u, vt = lapi.sgesvd("s", "s", a)
        np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False), rtol=1e-4)
        np.testing.assert_allclose((u * s[None, :]) @ vt, a, rtol=1e-3, atol=1e-3)

    def test_real_complex_name_split(self):
        assert not hasattr(tapi, "sheev")      # LAPACK has ssyev, not sheev
        assert not hasattr(tapi, "csyev")      # and cheev, not csyev
        assert hasattr(tapi, "dsyevd") and hasattr(tapi, "zheevd")


class TestLapackContracts:
    def test_pivot_format_consistent(self):
        n = 8
        a = rng(11).standard_normal((n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
        b = rng(12).standard_normal((n,)).astype(np.float32)
        x1, ipiv1, _ = lapi.sgesv(a, b.copy())
        lu, ipiv2, _ = lapi.sgetrf(a)
        np.testing.assert_array_equal(ipiv1, ipiv2)
        assert ipiv2.min() >= 1
        x2 = lapi.sgetrs("n", lu, ipiv2, b.copy())
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), rtol=1e-5)

    def test_zgetrs_conjugate_transpose(self):
        n = 6
        r = rng(13)
        a = (r.standard_normal((n, n)) + 1j * r.standard_normal((n, n))
             ).astype(np.complex64) + n * np.eye(n)
        b = (r.standard_normal(n) + 1j * r.standard_normal(n)).astype(np.complex64)
        lu, ipiv, _ = lapi.zgetrf(a)
        x = lapi.zgetrs("c", lu, ipiv, b.copy())
        np.testing.assert_allclose(a.conj().T @ np.asarray(x), b, rtol=1e-3, atol=1e-3)
        xt = lapi.zgetrs("t", lu, ipiv, b.copy())
        np.testing.assert_allclose(a.T @ np.asarray(xt), b, rtol=1e-3, atol=1e-3)

    def test_gecon_inf_norm(self):
        n = 40
        a = np.eye(n)
        a[1:, 0] = 1000.0
        lu, ipiv, _ = lapi.dgetrf(a)
        r1 = lapi.dgecon("1", lu, ipiv, lapi.dlange("one", a))
        ri = lapi.dgecon("i", lu, ipiv, lapi.dlange("inf", a))
        true1 = 1.0 / np.linalg.cond(a, 1)
        truei = 1.0 / np.linalg.cond(a, np.inf)
        assert 0.2 < r1 / true1 < 5
        assert 0.2 < ri / truei < 5
        assert not np.isclose(true1, truei)

    def test_trcon_inf_norm(self):
        n = 40
        t = np.eye(n)
        t[1:, 0] = 1000.0
        ri = lapi.dtrcon("i", "lower", "n", t)
        truei = 1.0 / (np.abs(t).sum(1).max() * np.abs(np.linalg.inv(t)).sum(1).max())
        assert 0.2 < ri / truei < 5

    def test_gesvd_full_matrices(self):
        a = rng(15).standard_normal((12, 8)).astype(np.float32)
        s, u, vt = lapi.sgesvd("a", "a", a)
        assert u.shape == (12, 12) and vt.shape == (8, 8)
        np.testing.assert_allclose(u.T @ u, np.eye(12), atol=1e-4)
        np.testing.assert_allclose(vt @ vt.T, np.eye(8), atol=1e-4)
        np.testing.assert_allclose((u[:, :8] * s[None, :]) @ vt, a, rtol=1e-3, atol=1e-3)


class TestEnvTuning:
    def test_nb_env(self, monkeypatch):
        monkeypatch.setenv("SLATE_LAPACK_NB", "8")
        a = rng(1).standard_normal((16, 16)).astype(np.float32)
        b = rng(2).standard_normal((16, 16)).astype(np.float32)
        out = lapi.sgemm("n", "n", 1.0, a, b, 0.0, np.zeros_like(a))
        np.testing.assert_allclose(out, a @ b, rtol=1e-5)


class TestLaset:
    def test_dlaset(self):
        out = lapi.dlaset("g", 5, 7, 2.0, 9.0)
        assert out.shape == (5, 7) and out[0, 0] == 9.0 and out[0, 1] == 2.0
        base = np.arange(16.0).reshape(4, 4)
        lo = lapi.dlaset("l", 4, 4, 0.0, 1.0, base.copy())
        assert lo[2, 0] == 0.0 and lo[2, 2] == 1.0 and lo[0, 3] == 3.0

    def test_dlaset_submatrix_semantics(self):
        """LAPACK laset touches only the leading m x n region."""
        base = np.ones((4, 4))
        out = lapi.dlaset("g", 2, 2, 0.0, 5.0, base.copy())
        assert out[0, 0] == 5.0 and out[0, 1] == 0.0
        assert (out[2:, :] == 1.0).all() and (out[:, 2:] == 1.0).all()
