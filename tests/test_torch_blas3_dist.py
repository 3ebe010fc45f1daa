"""Parity of the distributed BLAS-3 (``slate_tpu_torch.parallel.blas3_dist``)
with the JAX package's, mirroring ``tests/test_blas3_dist.py`` (TestRankK,
TestHemmSymmTrmm, TestBandDistributed).

The JAX side runs on its 8-device virtual CPU mesh, the port on eight gloo
ranks (one pool for the module) at the same grid shape, in both grid orders.
Each test holds both results to the JAX test's reference and tolerance, and
the port to the JAX result.  The JAX package is imported lazily: the ranks
import this module and need torch only.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from slate_tpu_torch.parallel.launch import GRID, RankPool

G24 = {"col": (2, 4, "col"), "row": (2, 4, "row")}
G22 = {"col": (2, 2, "col"), "row": (2, 2, "row")}


@pytest.fixture(scope="module")
def pool():
    with RankPool(8) as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from slate_tpu import parallel as jp

    return SimpleNamespace(jnp=jnp, jp=jp, g24=jp.ProcessGrid(2, 4),
                           g22=jp.ProcessGrid(2, 2, devices=jax.devices()[:4]))


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _tri_ref(uplo, upd, c):
    mask = (np.tril(np.ones_like(np.real(c))) > 0 if uplo == "lower"
            else np.triu(np.ones_like(np.real(c))) > 0)
    return np.where(mask, upd, c)


def check(pool, jx, name, args, ref, grids=G24, atol=1e-10, **kw):
    """Both packages' results against ``ref``, and the port against JAX."""
    jg = jx.g24 if grids is G24 else jx.g22
    jargs = [jg if a is GRID else (jx.jnp.asarray(a) if isinstance(a, np.ndarray)
                                   else a) for a in args]
    jout = np.asarray(getattr(jx.jp, name)(*jargs, **kw))
    np.testing.assert_allclose(jout, ref, atol=atol)
    for spec in grids.values():
        out = pool.call(name, *args, grid=spec, **kw)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=atol)
        np.testing.assert_allclose(out, jout, atol=atol)


class TestRankK:
    @pytest.mark.parametrize("uplo", ["lower", "upper"])
    def test_syrk(self, pool, jx, rng, uplo):
        n, k = 24, 12   # ragged against the 2x4 grid: exercises the padding
        a = rng.standard_normal((n, k))
        c = rng.standard_normal((n, n))
        check(pool, jx, "syrk_distributed", [0.5, a, 2.0, c, GRID],
              _tri_ref(uplo, 0.5 * a @ a.T + 2.0 * c, c), uplo=uplo)

    def test_herk_complex(self, pool, jx, rng):
        n, k = 16, 8
        a = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
        c0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        c = np.tril(c0) + np.conj(np.tril(c0, -1)).T
        creal = c.copy()
        np.fill_diagonal(creal, np.real(np.diag(c)))
        check(pool, jx, "herk_distributed", [1.0, a, 0.5, c, GRID],
              _tri_ref("lower", a @ np.conj(a).T + 0.5 * creal, c), grids=G22,
              uplo="lower")

    def test_syr2k(self, pool, jx, rng):
        n, k = 16, 8
        a = rng.standard_normal((n, k))
        b = rng.standard_normal((n, k))
        c = rng.standard_normal((n, n))
        check(pool, jx, "syr2k_distributed", [1.5, a, b, 1.0, c, GRID],
              _tri_ref("lower", 1.5 * (a @ b.T + b @ a.T) + c, c))

    def test_her2k_complex(self, pool, jx, rng):
        n, k = 12, 6
        a = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
        b = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
        c = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        alpha = 0.7 + 0.2j
        upd = alpha * a @ np.conj(b).T + np.conj(alpha) * b @ np.conj(a).T
        creal = c.copy()
        np.fill_diagonal(creal, np.real(np.diag(c)))
        check(pool, jx, "her2k_distributed", [alpha, a, b, 2.0, c, GRID],
              _tri_ref("upper", upd + 2.0 * creal, c), grids=G22, uplo="upper")


class TestHemmSymmTrmm:
    @pytest.mark.parametrize("side", ["left", "right"])
    def test_symm(self, pool, jx, rng, side):
        n, m = 20, 20
        s0 = rng.standard_normal((n, n))
        b = rng.standard_normal((n, m))
        c = rng.standard_normal((n, m))
        full = np.tril(s0) + np.tril(s0, -1).T
        prod = full @ b if side == "left" else b @ full
        check(pool, jx, "symm_distributed", [side, 2.0, s0, b, 0.5, c, GRID],
              2.0 * prod + 0.5 * c, uplo="lower")

    def test_hemm_upper_complex(self, pool, jx, rng):
        n = 12
        h0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        b = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        c = np.zeros((n, n), complex)
        up = np.triu(h0, 1)
        full = np.diag(np.real(np.diagonal(h0))) + up + np.conj(up).T
        check(pool, jx, "hemm_distributed", ["left", 1.0, h0, b, 0.0, c, GRID],
              full @ b, grids=G22, uplo="upper")

    @pytest.mark.parametrize("side,uplo", [("left", "lower"), ("right", "upper")])
    def test_trmm(self, pool, jx, rng, side, uplo):
        n = 16
        t0 = rng.standard_normal((n, n))
        b = rng.standard_normal((n, n))
        tri = np.tril(t0) if uplo == "lower" else np.triu(t0)
        prod = tri @ b if side == "left" else b @ tri
        check(pool, jx, "trmm_distributed", [side, 1.5, t0, b, GRID], 1.5 * prod,
              uplo=uplo)

    def test_trmm_unit_conjtrans(self, pool, jx, rng):
        n = 8
        t0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        b = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        tri = np.tril(t0)
        np.fill_diagonal(tri, 1)
        check(pool, jx, "trmm_distributed", ["left", 1.0, t0, b, GRID],
              np.conj(tri).T @ b, grids=G22, uplo="lower", conj_trans=True,
              unit_diag=True)


class TestBandDistributed:
    def test_gbmm(self, pool, jx, rng):
        m, k, n, kl, ku = 20, 16, 12, 3, 2
        a = rng.standard_normal((m, k))
        b = rng.standard_normal((k, n))
        c = rng.standard_normal((m, n))
        band = np.where((np.arange(m)[:, None] - np.arange(k)[None, :] <= kl)
                        & (np.arange(k)[None, :] - np.arange(m)[:, None] <= ku), a, 0.0)
        check(pool, jx, "gbmm_distributed", [2.0, a, b, 0.5, c, GRID],
              2.0 * band @ b + 0.5 * c, kl=kl, ku=ku)

    def test_hbmm(self, pool, jx, rng):
        n, kd = 16, 3
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        b = rng.standard_normal((n, 5)) + 1j * rng.standard_normal((n, 5))
        ii, jj = np.mgrid[0:n, 0:n]
        tri = np.where((ii - jj >= 0) & (ii - jj <= kd), a, 0.0)
        full = (np.diag(np.real(np.diagonal(tri))) + np.tril(tri, -1)
                + np.conj(np.tril(tri, -1)).T)
        check(pool, jx, "hbmm_distributed", [1.0, a, b, 0.0, np.zeros((n, 5), complex),
                                             GRID], full @ b, grids=G22, kd=kd,
              uplo="lower")
        # right side (the reference's Side parameter, slate.hh:215)
        br = np.conj(b).T
        check(pool, jx, "hbmm_distributed", [1.0, a, br, 0.0, np.zeros((5, n), complex),
                                             GRID], br @ full, grids=G22, kd=kd,
              uplo="lower", side="right")
