"""The port's matgen (slate_tpu_torch.matgen) against the JAX package's, on the
CPU: the same kind, shape, dtype and seed give

- the deterministic kinds bit for bit (``generate_tile`` included);
- the uniform-family random kinds (rand, rands, randb, randr) bit for bit —
  the same threefry2x32 streams, keyed per 256x256 block;
- randn within RANDN_ULP ulp (XLA's erf_inv polynomial, evaluated by torch:
  log, log1p and fused multiply-adds may round a last bit differently);
- the spectrum kinds within a relative Frobenius distance of SPECTRUM_RTOL
  (their orthogonal factors come from two libraries' QR), with the spectra
  within 1 ulp (exp and pow are each library's own).

The tests of tests/test_matgen.py follow, each on the port."""

import math

import numpy as np
import pytest
import torch

from slate_tpu import matgen as jm
from slate_tpu_torch import matgen as tm
from slate_tpu_torch.core.exceptions import SlateError

RANDN_ULP = 4
SPECTRUM_RTOL = {np.float32: 2e-5, np.complex64: 2e-5,
                 np.float64: 1e-13, np.complex128: 1e-13}
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)
SHAPES = ((7, 5), (300, 260))     # one block; several blocks, ragged edges


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on the
    machine's cores, and torch's thread pool spinning beside them made these
    tests 10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def npa(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gen(kind, m, n=None, **kw):
    return tm.generate_matrix(kind, m, n, device="cpu", **kw)


def _ulps(want: np.ndarray, got: np.ndarray) -> float:
    """Largest |want - got| in ulps of want, real and imaginary parts apart."""
    if np.iscomplexobj(want):
        return max(_ulps(want.real, got.real), _ulps(want.imag, got.imag))
    spacing = np.spacing(np.abs(want))
    return float(np.max(np.abs(want.astype(np.float64) - got) / spacing))


# ---------------------------------------------------------------------------
# parity with the JAX package

@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_deterministic_kinds_bit_for_bit(shape, dtype):
    m, n = shape
    for kind in jm._DETERMINISTIC + ["hilb_small", "ones_zerocol3", "pei_dominant"]:
        want = npa(jm.generate_matrix(kind, m, n, dtype=dtype, seed=3)[0])
        got = npa(gen(kind, m, n, dtype=dtype, seed=3)[0])
        assert got.dtype == want.dtype, kind
        np.testing.assert_array_equal(got, want, err_msg=kind)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_random_kinds_match_the_jax_streams(shape, dtype):
    m, n = shape
    for kind in ("rand", "rands", "randb", "randr", "rand_dominant",
                 "rands_zerocol0.5", "randn"):
        want = npa(jm.generate_matrix(kind, m, n, dtype=dtype, seed=11)[0])
        got = npa(gen(kind, m, n, dtype=dtype, seed=11)[0])
        assert got.dtype == want.dtype, kind
        if kind == "randn":
            assert _ulps(want, got) <= RANDN_ULP
        else:
            np.testing.assert_array_equal(got, want, err_msg=kind)


@pytest.mark.parametrize("kind", ["rand", "randb", "randn", "hilb", "gcdmat"])
def test_generate_tile_matches_jax(kind):
    for (i0, j0, mb, nb) in ((0, 0, 64, 64), (256, 256, 100, 100),
                             (300, 500, 200, 100)):
        want = npa(jm.generate_tile(kind, i0, j0, mb, nb, 600, 600, seed=5))
        got = npa(tm.generate_tile(kind, i0, j0, mb, nb, 600, 600, seed=5,
                                   device="cpu"))
        if kind == "randn":
            assert _ulps(want, got) <= RANDN_ULP
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["svd", "heev", "poev_geo", "diag_arith",
                                  "svd_cluster0", "heev_rgeo", "poev_rand",
                                  "svd_rands_dominant", "heev_randn"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128],
                         ids=lambda d: np.dtype(d).name)
def test_spectrum_kinds_match_jax(kind, dtype):
    want, ws = jm.generate_matrix(kind, 40, 40, dtype=dtype, seed=2, cond=30.0)
    got, gs = gen(kind, 40, 40, dtype=dtype, seed=2, cond=30.0)
    want, got = npa(want), npa(got)
    assert got.dtype == want.dtype
    assert np.linalg.norm(got - want) <= SPECTRUM_RTOL[dtype] * np.linalg.norm(want)
    assert _ulps(npa(ws), npa(gs)) <= 1


def test_sigma_distributions_match_jax():
    for dist in ("logrand", "arith", "geo", "cluster0", "cluster1", "rarith",
                 "rgeo", "rcluster0", "rcluster1", "rand", "rands", "randn"):
        for dtype in (np.float32, np.float64):
            want = npa(jm.generate_sigma(dist, 33, 50.0, seed=4, dtype=dtype,
                                         rand_sign=True, sigma_max=2.0))
            got = npa(tm.generate_sigma(dist, 33, 50.0, seed=4, dtype=dtype,
                                        rand_sign=True, sigma_max=2.0, device="cpu"))
            assert got.dtype == want.dtype
            assert _ulps(want, got) <= (RANDN_ULP if dist == "randn" else 1), dist


def test_kind_lists_and_usage_match_jax():
    assert tm.matrix_kinds() == jm.matrix_kinds()
    assert tm.generate_matrix_usage() == jm.generate_matrix_usage()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        A, _ = tm.generate_matrix("ones", 4)
        assert A.device.type == "cuda"
    else:
        with pytest.raises(SlateError, match="CUDA"):
            tm.generate_matrix("ones", 4)


# ---------------------------------------------------------------------------
# tests/test_matgen.py, on the port

class TestDeterministicKinds:
    def test_identity(self):
        A, S = gen("identity", 5, 7)
        assert S is None
        np.testing.assert_allclose(npa(A), np.eye(5, 7, dtype=np.float32))

    def test_zeros_ones(self):
        A, _ = gen("zeros", 4)
        assert not npa(A).any()
        A, _ = gen("ones", 4)
        assert (npa(A) == 1).all()

    def test_hilb(self):
        A, _ = gen("hilb", 4, dtype=torch.float64)
        expect = 1.0 / (np.arange(4)[:, None] + np.arange(4)[None, :] + 1)
        np.testing.assert_allclose(npa(A), expect, rtol=1e-6)

    def test_minij_moler_lehmer(self):
        n = 6
        I, J = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        A, _ = gen("minij", n)
        np.testing.assert_allclose(npa(A), np.minimum(I, J) + 1)
        A, _ = gen("lehmer", n)
        np.testing.assert_allclose(npa(A),
                                   (np.minimum(I, J) + 1) / (np.maximum(I, J) + 1),
                                   rtol=1e-6)
        A, _ = gen("moler", n)
        np.testing.assert_allclose(npa(A),
                                   np.where(I == J, I + 1, np.minimum(I, J) - 1))

    def test_jordan_tridiag_circulant(self):
        n = 5
        A, _ = gen("jordan", n)
        assert (np.diag(npa(A)) == 1).all() and (np.diag(npa(A), 1) == 1).all()
        A, _ = gen("tridiag", n)
        assert (np.diag(npa(A)) == 2).all() and (np.diag(npa(A), -1) == -1).all()
        A, _ = gen("circul", n)
        np.testing.assert_allclose(npa(A)[:, 0], [1, 5, 4, 3, 2])

    def test_orthog_is_orthogonal(self):
        A, _ = gen("orthog", 32)
        G = npa(A).T @ npa(A)
        np.testing.assert_allclose(G, np.eye(32), atol=1e-4)

    def test_gcdmat(self):
        A, _ = gen("gcdmat", 6)
        assert npa(A)[3, 5] == math.gcd(4, 6)

    def test_unknown_kind_raises(self):
        with pytest.raises(SlateError):
            gen("nosuchkind", 4)
        with pytest.raises(SlateError):
            gen("rand_nosuffix", 4)


class TestRandomKinds:
    def test_ranges(self):
        for kind, lo, hi in [("rand", 0, 1), ("rands", -1, 1)]:
            A, _ = gen(kind, 64, 48, seed=3)
            a = npa(A)
            assert a.min() >= lo and a.max() <= hi and a.std() > 0.1

    def test_randb_randr(self):
        A, _ = gen("randb", 64)
        assert set(np.unique(npa(A))) <= {0.0, 1.0}
        A, _ = gen("randr", 64)
        assert set(np.unique(npa(A))) <= {-1.0, 1.0}

    def test_deterministic_in_seed(self):
        A1, _ = gen("randn", 40, seed=7)
        A2, _ = gen("randn", 40, seed=7)
        A3, _ = gen("randn", 40, seed=8)
        np.testing.assert_array_equal(npa(A1), npa(A2))
        assert not np.array_equal(npa(A1), npa(A3))

    def test_tile_independence(self):
        """generate_tile of a sub-block equals the same region of the full
        matrix — the counter-based-RNG property."""
        m = n = 600   # spans multiple canonical 256-blocks
        A, _ = gen("randn", m, n, seed=5)
        for (i0, j0, mb, nb) in [(0, 0, 64, 64), (256, 256, 100, 100),
                                 (300, 500, 200, 100), (512, 0, 88, 300)]:
            tile = tm.generate_tile("randn", i0, j0, mb, nb, m, n, seed=5, device="cpu")
            np.testing.assert_array_equal(npa(A)[i0:i0 + mb, j0:j0 + nb], npa(tile))

    def test_tile_independence_small(self):
        A, _ = gen("randn", 100, 100, seed=5)
        tile = tm.generate_tile("randn", 0, 0, 50, 50, 100, 100, seed=5, device="cpu")
        np.testing.assert_array_equal(npa(A)[:50, :50], npa(tile))

    def test_tile_zerocol(self):
        A, _ = gen("randn_zerocol3", 16, seed=1)
        tile = tm.generate_tile("randn_zerocol3", 0, 0, 16, 16, 16, 16, seed=1,
                                device="cpu")
        np.testing.assert_array_equal(npa(A), npa(tile))

    def test_riemann(self):
        A, _ = gen("riemann", 6)
        np.testing.assert_allclose(npa(A)[0], [1, -1, 1, -1, 1, -1])
        np.testing.assert_allclose(npa(A)[2], [-1, -1, 3, -1, -1, -1])

    def test_tile_deterministic_kind(self):
        A, _ = gen("hilb", 300, 300)
        tile = tm.generate_tile("hilb", 100, 37, 50, 60, 300, 300, device="cpu")
        np.testing.assert_allclose(npa(A)[100:150, 37:97], npa(tile), rtol=1e-6)

    def test_dominant(self):
        A, _ = gen("rands_dominant", 32, seed=1)
        a = npa(A)
        off = np.abs(a) - np.diag(np.abs(np.diag(a)))
        assert (np.abs(np.diag(a)) > off.sum(axis=1)).all()

    def test_zerocol(self):
        A, _ = gen("randn_zerocol3", 16, seed=1)
        assert not npa(A)[:, 3].any()
        A, _ = gen("randn_zerocol0.5", 16, seed=1)
        assert not npa(A)[:, round(0.5 * 15)].any()


class TestSpectrumKinds:
    def test_diag(self):
        A, S = gen("diag_geo", 8, cond=100.0)
        np.testing.assert_allclose(np.diag(npa(A)), npa(S), rtol=1e-6)
        r = npa(S)
        np.testing.assert_allclose(r[0] / r[-1], 100.0, rtol=1e-4)

    def test_svd_cond_control(self):
        n, cond = 48, 1000.0
        A, S = gen("svd_geo", n, cond=cond, seed=2)
        sv = np.linalg.svd(npa(A), compute_uv=False)
        np.testing.assert_allclose(sv, np.sort(npa(S))[::-1], rtol=1e-3)
        np.testing.assert_allclose(sv[0] / sv[-1], cond, rtol=1e-2)

    def test_svd_rectangular(self):
        A, S = gen("svd_arith", 40, 24, cond=50.0, seed=3)
        assert A.shape == (40, 24) and S.shape == (24,)
        sv = np.linalg.svd(npa(A), compute_uv=False)
        np.testing.assert_allclose(sv, np.sort(npa(S))[::-1], rtol=1e-3)

    def test_poev_spd(self):
        n = 32
        A, S = gen("poev_cluster1", n, cond=10.0, seed=4)
        a = npa(A)
        np.testing.assert_allclose(a, a.T, atol=1e-5)
        w = np.linalg.eigvalsh(a)
        assert w.min() > 0
        np.testing.assert_allclose(np.sort(w), np.sort(npa(S)), rtol=1e-3, atol=1e-5)

    def test_spd_alias(self):
        A1, _ = gen("spd_geo", 16, cond=10.0, seed=5)
        A2, _ = gen("poev_geo", 16, cond=10.0, seed=5)
        np.testing.assert_array_equal(npa(A1), npa(A2))

    def test_heev_mixed_signs(self):
        A, S = gen("heev_logrand", 48, cond=100.0, seed=6)
        s = npa(S)
        assert (s > 0).any() and (s < 0).any()
        w = np.linalg.eigvalsh(npa(A))
        np.testing.assert_allclose(np.sort(w), np.sort(s), rtol=1e-3, atol=1e-5)

    def test_sigma_specified(self):
        sig = torch.tensor([4.0, 3.0, 2.0, 1.0])
        A, S = gen("svd_specified", 4, sigma=sig, seed=1)
        sv = np.linalg.svd(npa(A), compute_uv=False)
        np.testing.assert_allclose(sv, [4, 3, 2, 1], rtol=1e-4)

    def test_condD_scaling(self):
        A, _ = gen("svd_geo", 32, cond=10.0, condD=100.0, seed=7)
        norms = np.linalg.norm(npa(A), axis=0)
        assert norms.max() / norms.min() > 5.0

    def test_heev_requires_square(self):
        with pytest.raises(SlateError):
            gen("heev", 8, 12)

    def test_sigma_distributions(self):
        n, cond = 16, 64.0
        sig = lambda dist, **kw: npa(tm.generate_sigma(dist, n, cond, device="cpu", **kw))
        arith = sig("arith")
        np.testing.assert_allclose(np.diff(arith), np.diff(arith)[0] * np.ones(n - 1),
                                   rtol=1e-4)
        geo = sig("geo")
        ratios = geo[1:] / geo[:-1]
        np.testing.assert_allclose(ratios, ratios[0] * np.ones(n - 1), rtol=1e-3)
        c0 = sig("cluster0")
        assert c0[0] == 1 and np.allclose(c0[1:], 1 / cond)
        np.testing.assert_allclose(sig("rcluster0"), c0[::-1])
        lr = sig("logrand", seed=3)
        assert (lr >= 1 / cond - 1e-6).all() and (lr <= 1.0 + 1e-6).all()


class TestScaling:
    def test_small_large(self):
        A, _ = gen("rand_small", 16, seed=1)
        assert 0 < np.abs(npa(A)).max() < 1e-15
        A, _ = gen("rand_large", 16, seed=1)
        assert np.abs(npa(A)).max() > 1e15

    def test_kinds_all_generate(self):
        for kind in tm.matrix_kinds():
            A, _ = gen(kind, 12, 12, seed=1)
            assert A.shape == (12, 12)
            assert bool(torch.isfinite(A).all()), kind

    def test_complex_dtype(self):
        A, _ = gen("randn", 24, dtype=torch.complex64, seed=2)
        assert A.dtype == torch.complex64
        assert np.abs(npa(A).imag).max() > 0
        A, S = gen("heev_geo", 24, dtype=torch.complex64, seed=2)
        a = npa(A)
        np.testing.assert_allclose(a, a.conj().T, atol=1e-5)
        w = np.linalg.eigvalsh(a)
        np.testing.assert_allclose(np.sort(w), np.sort(npa(S)), rtol=1e-3, atol=1e-4)
