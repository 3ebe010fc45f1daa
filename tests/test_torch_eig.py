"""Hermitian eigensolvers of the PyTorch port (slate_tpu_torch.linalg.eig)
against the JAX package's: fused and two-stage ``heev`` with every
``MethodEig`` branch, the stages ``he2hb``/``hb2st`` (both chases, every band
storage form, kd = 1, one batched input), the back-transforms, ``heev_range``,
``eig_count``, ``hegst``/``hegv``/``hegv_range``.

Inputs come from a numpy seed and go through both packages on the CPU, at
n = 45 with nb = 8 (a ragged last panel), n = 20 complex128 and a (2, 24, 24)
batch.  Tolerances:
* f64, deterministic stages: the band, V, T of ``he2hb`` and (d, e, Q2) of
  ``hb2st`` agree within 1e-12 relative to ‖A‖ (both chases too, with each
  other); eigenvalues within 1e-12·‖A‖₂; counts equal;
* vectors: |diag(Z_jaxᴴ Z_port)| >= 1 − 1e-10 (the test spectra have gaps
  above 1e-6·‖A‖), and the tester's gate ‖AZ − ZΛ‖/‖A‖ + ‖I − ZᴴZ‖/n <=
  50·eps·√n;
* f32: 1e-5 relative; errors: the same exception types.
"""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu.linalg import eig as je
from slate_tpu_torch.linalg import eig as te

N, NB = 45, 8
OPTS = {"block_size": NB}
METHODS = ("auto", "dc", "qr", "bisection", "mrrr")


def _herm(n, seed, cplx=False, dtype=np.float64):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    if cplx:
        M = M + 1j * rng.standard_normal((n, n))
    return ((M + M.conj().T) / 2).astype(dtype)


def _spd(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return M @ M.T / n + 2 * np.eye(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want, scale):
    return np.abs(_np(got) - _np(want)).max() / scale


def _sign_free(Zj, Zt, tol=1e-10):
    dots = np.abs(np.sum(_np(Zj).conj() * _np(Zt), axis=0))
    assert dots.min() >= 1 - tol, dots.min()


def _gate(A, lam, Z, B=None):
    A, lam, Z = _np(A), _np(lam), _np(Z)
    n = A.shape[0]
    BZ = Z if B is None else B @ Z
    res = (np.linalg.norm(A @ Z - BZ * lam) / np.linalg.norm(A)
           + (np.linalg.norm(np.eye(Z.shape[1]) - Z.conj().T @ Z) / n if B is None else 0))
    assert res <= 50 * np.finfo(np.float64).eps * np.sqrt(n), res


@pytest.fixture(scope="module")
def jx():
    """The JAX package's results, computed once for the module."""
    A = _herm(N, 1)
    out = {"A": A, "norm2": np.abs(np.linalg.eigvalsh(A)).max()}
    for m in METHODS:
        out["two_stage", m] = je.heev(A, {**OPTS, "method_eig": m}, method="two_stage")
    out["timers"] = set(je.heev.timers)
    out["fused"] = je.heev(A, OPTS)
    out["vals_dc"] = je.heev(A, {**OPTS, "method_eig": "dc"}, method="two_stage",
                             want_vectors=False)
    band, Vs, Ts = je.he2hb(A, nb=NB)
    out["he2hb"] = band, Vs, Ts
    out["hb2st"] = je.hb2st(band, kd=NB, want_vectors=True)
    out["range"] = je.heev_range(A, OPTS, il=5, iu=17)
    out["range_vals"] = je.heev_range(A, OPTS, il=5, iu=17, want_vectors=False,
                                      chase_pipeline=True)
    return {k: (tuple(None if x is None else np.asarray(x) for x in v)
                if isinstance(v, tuple) else v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# heev
# ---------------------------------------------------------------------------


def test_heev_fused_matches_jax(jx):
    A = jx["A"]
    lam, Z = st.heev(_t(A), OPTS)
    lam_j, Z_j = jx["fused"]
    assert _rel(lam, lam_j, jx["norm2"]) <= 1e-12
    _sign_free(Z_j, Z)
    _gate(A, lam, Z)
    vals, none = st.heev(_t(A), OPTS, want_vectors=False)
    assert none is None and _rel(vals, lam_j, jx["norm2"]) <= 1e-12


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
@pytest.mark.parametrize("method", METHODS)
def test_heev_two_stage_matches_jax(jx, method, pipeline):
    """Every MethodEig branch of the two-stage pipeline (MRRR routes to
    D&C, as in the JAX package), through either chase."""
    A = jx["A"]
    lam, Z = st.heev(_t(A), {**OPTS, "method_eig": method}, method="two_stage",
                     chase_pipeline=pipeline)
    lam_j, Z_j = jx["two_stage", method]
    assert _rel(lam, lam_j, jx["norm2"]) <= 1e-12
    _sign_free(Z_j, Z)
    _gate(A, lam, Z)
    assert set(st.heev.timers) == jx["timers"]


@pytest.mark.parametrize("method", ["auto", "dc"])
def test_heev_two_stage_values(jx, method):
    """Values only: DC takes stedc, every other method sterf."""
    lam, z = st.heev(_t(jx["A"]), {**OPTS, "method_eig": method}, method="two_stage",
                     want_vectors=False, chase_pipeline=True)
    assert z is None
    assert _rel(lam, jx["vals_dc"][0], jx["norm2"]) <= 1e-12


def test_heev_f32_and_wrappers():
    """f32 within 1e-5 of the JAX package (its fused f32 values); a
    HermitianMatrix wrapper reads its stored triangle only; a tiny n falls
    back to the fused solve."""
    A = _herm(24, 2, dtype=np.float32)
    Aw = st.HermitianMatrix.from_array("upper", np.triu(A), nb=8, device="cpu")
    lam_j, _ = sj.heev(sj.HermitianMatrix.from_array("upper", np.triu(A), nb=8), OPTS,
                       want_vectors=False)
    for method in ("fused", "two_stage"):
        lam, Z = st.heev(Aw, OPTS, method=method)
        assert lam.dtype == torch.float32
        assert _rel(lam, lam_j, np.abs(lam_j).max()) <= 1e-5
    small = _herm(5, 3)
    np.testing.assert_allclose(st.heev(_t(small), method="two_stage")[0].numpy(),
                               np.linalg.eigvalsh(small), atol=1e-13)


def test_heev_complex128_two_stage_and_fused():
    """n = 20, nb = 5 (the band size the stage test below reuses)."""
    A = _herm(20, 4, cplx=True)
    scale = np.abs(np.linalg.eigvalsh(A)).max()
    for method in ("fused", "two_stage"):
        lam, Z = st.heev(_t(A), OPTS, method=method)
        lam_j, Z_j = sj.heev(A, OPTS, method=method)
        assert _rel(lam, lam_j, scale) <= 1e-12
        _sign_free(Z_j, Z)
        _gate(A, lam, Z)


def test_heev_scales_extreme_norms():
    """heev.cc's safe-range scaling: a matrix near overflow solves."""
    A = _herm(16, 5) * 1e300
    lam, _ = st.heev(_t(A), want_vectors=False)
    want = np.asarray(sj.heev(A, want_vectors=False)[0])
    assert np.isfinite(lam.numpy()).all()
    assert _rel(lam, want, np.abs(want).max()) <= 1e-12


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def test_he2hb_matches_jax_and_back_transforms(jx):
    A = jx["A"]
    band, Vs, Ts = st.he2hb(_t(A), nb=NB)
    for got, want in zip((band, Vs, Ts), jx["he2hb"]):
        assert _rel(got, want, jx["norm2"]) <= 1e-12
    Q = st.he2hb_q(Vs, Ts)
    assert _rel(Q, je.he2hb_q(*jx["he2hb"][1:]), 1.0) <= 1e-12
    np.testing.assert_allclose(_np(Q) @ _np(band) @ _np(Q).T, A, atol=1e-12)
    C = np.random.default_rng(6).standard_normal((N, 7))
    for side, op, M in (("left", "n", C), ("left", "c", C), ("left", "t", C),
                        ("right", "n", C.T.copy()), ("right", "c", C.T.copy())):
        got = st.unmtr_he2hb(side, op, Vs, Ts, _t(M))
        want = je.unmtr_he2hb(side, op, jx["he2hb"][1], jx["he2hb"][2], M)
        assert _rel(got, want, 1.0) <= 1e-12, (side, op)
    with pytest.raises(ValueError, match="no Op"):
        st.unmtr_he2hb("left", "x", Vs, Ts, _t(C))
    with pytest.raises(ValueError, match="no Op"):
        je.unmtr_he2hb("left", "x", jx["he2hb"][1], jx["he2hb"][2], C)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
@pytest.mark.parametrize("storage", ["full", "lower", "upper"])
def test_hb2st_matches_jax(jx, storage, pipeline):
    """(d, e, Q2) of both chases from every band storage form against the
    JAX package's sequential chase; band = Q2 T Q2^H."""
    band = jx["he2hb"][0]
    b = {"full": band, "lower": np.tril(band), "upper": np.triu(band)}[storage]
    d, e, Q2 = st.hb2st(_t(b), kd=NB, want_vectors=True, pipeline=pipeline)
    dj, ej, Qj = jx["hb2st"]
    assert _rel(d, dj, jx["norm2"]) <= 1e-12 and _rel(e, ej, jx["norm2"]) <= 1e-12
    assert _rel(Q2, Qj, 1.0) <= 1e-12
    T = np.diag(_np(d)) + np.diag(_np(e), 1) + np.diag(_np(e), -1)
    np.testing.assert_allclose(_np(Q2) @ T @ _np(Q2).T, band, atol=1e-12)
    got = st.unmtr_hb2st("left", "n", Q2, _t(np.eye(N)))
    np.testing.assert_allclose(_np(got), _np(Q2), atol=0)


def test_chases_agree_and_store_the_same_reflectors(jx):
    """The pipelined chase reproduces the sequential one: (d, e_c) and every
    reflector with tau != 0 (dead steps store e_0 / zeros, both H = I)."""
    band = _t(jx["he2hb"][0])
    seq = te.hb2st_reflectors(band, kd=NB)
    pipe = te.hb2st_reflectors(band, kd=NB, pipeline=True)
    for a, b in zip(seq[:2], pipe[:2]):
        assert _rel(a, b, jx["norm2"]) <= 1e-12
    live = _np(seq[3]) != 0
    assert ((_np(pipe[3]) != 0) == live).all()
    assert np.abs(_np(seq[2])[live] - _np(pipe[2])[live]).max() <= 1e-12
    assert te._infer_bandwidth(band) == NB


def test_chase_switch_defaults_by_device(jx):
    """Every chase switch defaults (None) to the pipelined chase for a CUDA
    tensor and to the sequential one elsewhere, as the JAX package's default
    is; a bool forces either."""
    band = _t(jx["he2hb"][0])
    dflt = te.hb2st_reflectors(band, kd=NB)
    seq = te.hb2st_reflectors(band, kd=NB, pipeline=False)
    assert all(torch.equal(a, b) for a, b in zip(dflt, seq))

    class Card:
        is_cuda = True

    class Host:
        is_cuda = False

    assert te._pipelined(None, Card()) and not te._pipelined(None, Host())
    assert te._pipelined(True, Host()) and not te._pipelined(False, Card())


def test_hb2st_kd1_complex_and_tiny():
    """kd = 1: extraction and the phase rotation of a complex tridiagonal."""
    rng = np.random.default_rng(7)
    n = 9
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
    T = np.diag(d).astype(complex) + np.diag(e, -1) + np.diag(e.conj(), 1)
    for src in (T, np.tril(T)):
        out = st.hb2st(_t(src), kd=1, want_vectors=True)
        want = je.hb2st(src, kd=1, want_vectors=True)
        for a, b in zip(out, want):
            assert _rel(a, b, 1.0) <= 1e-14
    d2, e2 = st.hb2st(_t(np.array([[2.0, 1.0], [1.0, 3.0]])), kd=1)
    assert d2.tolist() == [2.0, 3.0] and e2.tolist() == [1.0]


def test_he2hb_hb2st_complex_and_batched():
    """complex128 at n = 20 (nb = 5) and a batched (2, 16, 16) input."""
    A = _herm(20, 8, cplx=True)
    out, want = st.he2hb(_t(A), nb=5), je.he2hb(A, nb=5)
    for a, b in zip(out, want):
        assert _rel(a, b, 1.0) <= 1e-12
    for pipeline in (False, True):
        got = st.hb2st(out[0], kd=5, want_vectors=True, pipeline=pipeline)
        for a, b in zip(got, je.hb2st(want[0], kd=5, want_vectors=True)):
            assert _rel(a, b, 1.0) <= 1e-12
    Ab = np.stack([_herm(16, 9), _herm(16, 10)])
    band_b, Vs_b, Ts_b = st.he2hb(_t(Ab), nb=4)
    band_j, Vs_j, Ts_j = je.he2hb(Ab, nb=4)
    for a, b in ((band_b, band_j), (Vs_b, Vs_j), (Ts_b, Ts_j)):
        assert a.shape == np.asarray(b).shape and _rel(a, b, 1.0) <= 1e-12
    d_b, e_b = st.hb2st(band_b, kd=4)
    d_j, e_j = je.hb2st(band_j, kd=4)
    assert d_b.shape == (2, 16) and _rel(d_b, d_j, 1.0) <= 1e-12 and _rel(e_b, e_j, 1.0) <= 1e-12


def test_tridiagonal_front_ends():
    """sterf (dense below 512, bisection above), steqr/steqr2, stedc: thin
    front ends of the solvers test_torch_tridiag.py holds against the JAX
    package, checked here against numpy (values within 1e-12·‖T‖, the
    tester's gate on vectors)."""
    rng = np.random.default_rng(11)
    for n in (40, 600):
        d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        want = np.linalg.eigvalsh(T)
        np.testing.assert_allclose(st.sterf(_t(d), _t(e)).numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    d, e = rng.standard_normal(40), rng.standard_normal(39)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    for fn in (st.steqr, st.steqr2, st.stedc):
        lam, Z = fn(_t(d), _t(e))
        np.testing.assert_allclose(lam.numpy(), np.linalg.eigvalsh(T), rtol=0, atol=4e-12)
        _gate(T, lam, Z)
    assert st.steqr2 is st.steqr


# ---------------------------------------------------------------------------
# subsets and counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
def test_heev_range_matches_jax(jx, pipeline):
    A = jx["A"]
    lam, Z = st.heev_range(_t(A), OPTS, il=5, iu=17, chase_pipeline=pipeline)
    lam_j, Z_j = jx["range"]
    assert lam.shape == (12,) and Z.shape == (N, 12)
    assert _rel(lam, lam_j, jx["norm2"]) <= 1e-12
    _sign_free(Z_j, Z)
    _gate(A, lam, Z)
    vals, none = st.heev_range(_t(A), OPTS, il=5, iu=17, want_vectors=False,
                               chase_pipeline=pipeline)
    assert none is None and _rel(vals, jx["range_vals"][0], jx["norm2"]) <= 1e-12


def test_heev_range_edges():
    small = _herm(6, 12)
    lam, Z = st.heev_range(_t(small), il=1, iu=4)
    np.testing.assert_allclose(lam.numpy(), np.linalg.eigvalsh(small)[1:4], atol=1e-13)
    for il, iu in ((4, 4), (-1, 3), (0, 7)):
        with pytest.raises(st.SlateError):
            st.heev_range(_t(small), il=il, iu=iu)
        with pytest.raises(sj.SlateError):
            sj.heev_range(small, il=il, iu=iu)


@pytest.mark.parametrize("interval", [(-1.0, 1.0), (-100.0, 100.0), (2.0, -2.0)])
def test_eig_count_equals_jax(jx, interval):
    A = jx["A"]
    got = st.eig_count(_t(A), *interval, OPTS)
    assert got.dtype == torch.int32
    assert int(got) == int(je.eig_count(A, *interval, OPTS))
    lam = np.linalg.eigvalsh(A)
    assert int(got) == int(((lam >= interval[0]) & (lam < interval[1])).sum())
    assert int(st.eig_count(_t(_herm(5, 13)), -100.0, 100.0)) == 5


# ---------------------------------------------------------------------------
# generalized
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegst_and_hegv_match_jax(itype):
    """n = 45: the standard-form solves reuse the fixture's compiled shapes."""
    A, B = _herm(N, 14), _spd(N, 15)
    L = np.linalg.cholesky(B)
    C = st.hegst(itype, _t(A), _t(L))
    Cj = je.hegst(itype, A, L)
    assert _rel(C, Cj, 1.0) <= 1e-12
    lam, Z = st.hegv(itype, _t(A), _t(B), OPTS)
    lam_j, Z_j = sj.hegv(itype, A, B, OPTS)
    scale = np.abs(np.asarray(lam_j)).max()
    assert _rel(lam, lam_j, scale) <= 1e-12
    _sign_free(Z_j / np.linalg.norm(Z_j, axis=0), _np(Z) / np.linalg.norm(_np(Z), axis=0))
    if itype == 1:
        _gate(A, lam, Z, B=B)


def test_hegv_range_and_errors():
    A, B = _herm(N, 16), _spd(N, 17)
    lam, Z = st.hegv_range(1, _t(A), _t(B), OPTS, il=5, iu=17)
    lam_j, Z_j = sj.hegv_range(1, A, B, OPTS, il=5, iu=17)
    assert _rel(lam, lam_j, np.abs(np.asarray(lam_j)).max()) <= 1e-12
    _gate(A, lam, Z, B=B)
    bad = -np.eye(N)
    with pytest.raises(st.NumericalError, match="not positive definite"):
        st.hegv(1, _t(A), _t(bad))
    with pytest.raises(sj.NumericalError, match="not positive definite"):
        sj.hegv(1, A, bad)
    with pytest.raises(st.SlateError):
        st.hegst(4, _t(A), _t(np.eye(N)))
    with pytest.raises(st.SlateError, match="chase_distributed"):
        st.heev(_t(A), chase_distributed=True)
    assert st.syev is st.heev and st.sygv is st.hegv and st.sygst is st.hegst
