"""SVD drivers of the PyTorch port (slate_tpu_torch.linalg.svd) against the JAX
package's: fused ``svd`` with the QR/LQ pre-steps, two-stage ``svd`` through
both chases and every ``MethodSVD`` branch, ``svd_vals``, ``svd_range``, and
the stages ``ge2tb``/``ge2tb_band``/``tb2bd``/``bdsqr`` and back-transforms.

Inputs come from a numpy seed and go through both packages on the CPU, at
45 x 40 with nb = 8 (a ragged last panel) and 20 x 16 complex128.
Tolerances:
* f64, deterministic stages: the band and reflectors of ``ge2tb_band`` and
  the (d, e) of ``ge2tb``/``tb2bd`` within 1e-12 relative to ‖A‖₂, both chases
  with each other too; singular values within 1e-12·‖A‖₂;
* vectors (free signs): |diag(U_jaxᴴ U_port)| >= 1 − 1e-10 on the test
  spectra (gaps above 1e-6·‖A‖), and ‖A − U S Vᴴ‖/‖A‖ + ‖I − UᴴU‖/n <=
  50·eps·√n;
* f32: 1e-5 relative.
"""

import importlib

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
# the modules (the packages bind the name "svd" to the driver function)
jsv = importlib.import_module("slate_tpu.linalg.svd")
tsv = importlib.import_module("slate_tpu_torch.linalg.svd")

M, N, NB = 45, 40, 8
OPTS = {"block_size": NB}


def _gen(m, n, seed, cplx=False, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if cplx:
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want, scale):
    return np.abs(_np(got) - _np(want)).max() / scale


def _sign_free(Xj, Xt, tol=1e-10, axis=0):
    dots = np.abs(np.sum(_np(Xj).conj() * _np(Xt), axis=axis))
    assert dots.min() >= 1 - tol, dots.min()


def _gate(A, S, U, VT):
    A, S, U, VT = _np(A), _np(S), _np(U), _np(VT)
    k = S.shape[0]
    res = (np.linalg.norm(A - (U * S) @ VT) / np.linalg.norm(A)
           + np.linalg.norm(np.eye(k) - U.conj().T @ U) / k
           + np.linalg.norm(np.eye(k) - VT @ VT.conj().T) / k)
    assert res <= 50 * np.finfo(np.float64).eps * np.sqrt(max(A.shape)), res


@pytest.fixture(scope="module")
def jx():
    """The JAX package's results, computed once for the module."""
    A = _gen(M, N, 1)
    out = {"A": A, "norm2": np.linalg.svd(A, compute_uv=False)[0]}
    out["fused"] = jsv.svd(A, OPTS)
    for m in ("auto", "qr", "dc", "bisection"):
        out["two_stage", m] = jsv.svd(A, {**OPTS, "method_svd": m}, method="two_stage")
    out["ge2tb_band"] = jsv.ge2tb_band(A, nb=NB)
    out["ge2tb"] = jsv.ge2tb(A, nb=NB)
    out["range"] = jsv.svd_range(A, OPTS, il=2, iu=11)
    return out


def test_svd_fused_matches_jax(jx):
    A = jx["A"]
    S, U, VT = st.svd(_t(A), OPTS)
    Sj, Uj, VTj = (np.asarray(x) for x in jx["fused"])
    assert _rel(S, Sj, jx["norm2"]) <= 1e-12
    _sign_free(Uj, U)
    _sign_free(VTj, VT, axis=1)
    _gate(A, S, U, VT)
    assert _rel(st.svd_vals(_t(A), OPTS), Sj, jx["norm2"]) <= 1e-12
    S2, none_u, VT2 = st.svd(_t(A), OPTS, want_u=False)
    assert none_u is None and VT2 is not None


@pytest.mark.parametrize("shape", [(60, 12), (12, 60)], ids=["tall-qr", "wide-lq"])
def test_svd_fused_pre_steps_match_jax(shape):
    """m >= 2n takes the QR pre-step, n >= 2m the LQ pre-step."""
    A = _gen(*shape, 2)
    S, U, VT = st.svd(_t(A))
    Sj, Uj, VTj = (np.asarray(x) for x in sj.svd(A))
    scale = Sj[0]
    assert _rel(S, Sj, scale) <= 1e-12
    _sign_free(Uj, U)
    _sign_free(VTj, VT, axis=1)
    _gate(A, S, U, VT)
    assert set(st.svd.timers) == set(sj.svd.timers)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
@pytest.mark.parametrize("method", ["auto", "qr", "dc", "bisection"])
def test_svd_two_stage_matches_jax(jx, method, pipeline):
    """MethodSVD.Bisection runs GK bisection + stein, DC the dense solve of
    B, Auto/QR the dense solve with vectors."""
    A = jx["A"]
    S, U, VT = st.svd(_t(A), {**OPTS, "method_svd": method}, method="two_stage",
                      chase_pipeline=pipeline)
    Sj, Uj, VTj = (np.asarray(x) for x in jx["two_stage", method])
    assert _rel(S, Sj, jx["norm2"]) <= 1e-12
    _sign_free(Uj, U)
    _sign_free(VTj, VT, axis=1)
    _gate(A, S, U, VT)


def test_svd_bisection_option_takes_two_stage(jx):
    """MethodSVD.Bisection on the default method runs the two-stage path."""
    A = jx["A"]
    S, U, VT = st.svd(_t(A), {**OPTS, "method_svd": "bisection"})
    assert "svd::ge2tb" in st.svd.timers
    assert _rel(S, jx["two_stage", "bisection"][0], jx["norm2"]) <= 1e-12


def test_svd_f32_and_complex128():
    A = _gen(30, 24, 3, dtype=np.float32)
    S = st.svd_vals(_t(A))
    assert S.dtype == torch.float32
    assert _rel(S, sj.svd_vals(A), float(np.asarray(sj.svd_vals(A))[0])) <= 1e-5
    C = _gen(16, 12, 4, cplx=True)
    scale = np.linalg.svd(C, compute_uv=False)[0]
    for method in ("fused", "two_stage"):
        S, U, VT = st.svd(_t(C), {"block_size": 4}, method=method)
        Sj, Uj, VTj = (np.asarray(x) for x in sj.svd(C, {"block_size": 4}, method=method))
        assert _rel(S, Sj, scale) <= 1e-12
        _sign_free(Uj, U)
        _sign_free(VTj, VT, axis=1)
        _gate(C, S, U, VT)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def test_ge2tb_band_and_ge2tb_match_jax(jx):
    A = jx["A"]
    band, (Vu, Tu), (Vv, Tv) = st.ge2tb_band(_t(A), nb=NB)
    bj, (Vuj, Tuj), (Vvj, Tvj) = jx["ge2tb_band"]
    for got, want in ((band, bj), (Vu, Vuj), (Tu, Tuj), (Vv, Vvj), (Tv, Tvj)):
        assert _rel(got, want, jx["norm2"]) <= 1e-12
    d, e, U, VT = st.ge2tb(_t(A), nb=NB)
    dj, ej, Uj, VTj = (np.asarray(x) for x in jx["ge2tb"])
    assert _rel(d, dj, jx["norm2"]) <= 1e-12 and _rel(e, ej, jx["norm2"]) <= 1e-12
    assert _rel(U, Uj, 1.0) <= 1e-12 and _rel(VT, VTj, 1.0) <= 1e-12
    B = np.diag(_np(d)) + np.diag(_np(e), 1)
    np.testing.assert_allclose(_np(U) @ B @ _np(VT), A, atol=1e-12)
    with pytest.raises(ValueError, match="m >= n"):
        st.ge2tb_band(_t(A.T.copy()), nb=NB)
    # the stage-1 factors applied without forming Q, against the formed U
    C = np.eye(M)[:, :N]
    got = st.linalg.unmbr_ge2tb_factors("left", "n", (Vu, Tu), _t(C))
    want = jsv.unmbr_ge2tb_factors("left", "n", (Vuj, Tuj), C)
    assert _rel(got, want, 1.0) <= 1e-12


def test_ge2tb_wide_and_tiny():
    """A wide input takes the LQ pre-step; k <= 2 needs no chase.  The
    bidiagonal reproduces A and its singular values (the JAX package's
    ge2tb is held to the port's in the test above)."""
    for shape in ((12, 20), (6, 2)):
        A = _gen(*shape, 5)
        d, e, U, VT = st.ge2tb(_t(A), nb=4)
        B = np.diag(_np(d)) + np.diag(_np(e), 1)
        np.testing.assert_allclose(_np(U) @ B @ _np(VT), A, atol=1e-12)
        np.testing.assert_allclose(np.linalg.svd(B, compute_uv=False),
                                   np.linalg.svd(A, compute_uv=False), atol=1e-12)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
def test_tb2bd_matches_jax_and_chases_agree(jx, pipeline):
    band = jx["ge2tb_band"][0][:N, :N]
    d, e, U2, VT2 = st.tb2bd(_t(band), NB, want_vectors=True, pipeline=pipeline)
    dj, ej, U2j, VT2j = (np.asarray(x) for x in jsv.tb2bd(band, NB, want_vectors=True))
    assert _rel(d, dj, jx["norm2"]) <= 1e-12 and _rel(e, ej, jx["norm2"]) <= 1e-12
    assert _rel(U2, U2j, 1.0) <= 1e-12 and _rel(VT2, VT2j, 1.0) <= 1e-12
    seq = tsv.tb2bd_reflectors(_t(band), NB)
    pipe = tsv.tb2bd_reflectors(_t(band), NB, pipeline=True)
    for a, b in zip(seq[:2], pipe[:2]):
        assert _rel(a, b, jx["norm2"]) <= 1e-12
    for V, tau, Vp, taup in ((seq[2], seq[3], pipe[2], pipe[3]),
                             (seq[4], seq[5], pipe[4], pipe[5])):
        live = _np(tau) != 0
        assert ((_np(taup) != 0) == live).all()
        assert np.abs(_np(V)[live] - _np(Vp)[live]).max() <= 1e-12
    x = np.random.default_rng(6).standard_normal((N, 3))
    assert _rel(st.unmbr_tb2bd("left", "n", U2, _t(x)), U2j @ x, 1.0) <= 1e-12
    assert _rel(st.unmbr_ge2tb("right", "c", U2, _t(x.T.copy())), x.T @ U2j.T, 1.0) <= 1e-12


@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
def test_tb2bd_kd1(cplx):
    """kd = 1: extraction, with the phases absorbed for complex input."""
    rng = np.random.default_rng(7)
    d = rng.standard_normal(7) + (1j * rng.standard_normal(7) if cplx else 0)
    e = rng.standard_normal(6) + (1j * rng.standard_normal(6) if cplx else 0)
    B = np.diag(d) + np.diag(e, 1)
    out = st.tb2bd(_t(B), 1, want_vectors=True)
    want = jsv.tb2bd(B, 1, want_vectors=True)
    for a, b in zip(out, want):
        assert _rel(a, b, 1.0) <= 1e-14
    assert len(st.tb2bd(_t(B), 1)) == 2


@pytest.mark.parametrize("method", ["auto", "dense", "bisect"])
def test_bdsqr_matches_jax(method):
    rng = np.random.default_rng(8)
    d, e = np.abs(rng.standard_normal(30)) + 0.1, rng.standard_normal(29)
    S, U, VT = st.bdsqr(_t(d), _t(e), want_vectors=True, method=method)
    Sj, Uj, VTj = (np.asarray(x) for x in jsv.bdsqr(d, e, want_vectors=True, method=method))
    B = np.diag(d) + np.diag(e, 1)
    assert _rel(S, Sj, Sj[0]) <= 1e-12
    _sign_free(Uj, U)
    _gate(B, S, U, VT)
    vals, nu, nv = st.bdsqr(_t(d), _t(e), method=method)
    assert nu is None and nv is None and _rel(vals, Sj, Sj[0]) <= 1e-12
    with pytest.raises(st.SlateError, match="unknown method"):
        st.bdsqr(_t(d), _t(e), method="nope")


def test_bdsqr_auto_bisects_above_512():
    rng = np.random.default_rng(9)
    d, e = rng.standard_normal(600), rng.standard_normal(599)
    S = st.bdsqr(_t(d), _t(e))[0]
    Sj = np.asarray(jsv.bdsqr(d, e)[0])
    assert _rel(S, Sj, Sj[0]) <= 1e-12


# ---------------------------------------------------------------------------
# subsets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipeline", [False, True], ids=["sequential", "pipelined"])
def test_svd_range_matches_jax(jx, pipeline):
    A = jx["A"]
    S, U, VT = st.svd_range(_t(A), OPTS, il=2, iu=11, chase_pipeline=pipeline)
    Sj, Uj, VTj = (np.asarray(x) for x in jx["range"])
    assert S.shape == (9,) and U.shape == (M, 9) and VT.shape == (9, N)
    assert _rel(S, Sj, jx["norm2"]) <= 1e-12
    _sign_free(Uj, U)
    _sign_free(VTj, VT, axis=1)
    np.testing.assert_allclose(A @ _np(VT).T, _np(U) * _np(S), atol=1e-11)
    vals, nu, nv = st.svd_range(_t(A), OPTS, il=2, iu=11, want_vectors=False,
                                chase_pipeline=pipeline)
    assert nu is None and _rel(vals, Sj, jx["norm2"]) <= 1e-12


def test_svd_range_wide_tiny_and_errors(jx):
    """A wide input (the fixture's transposed: the JAX package reuses the
    shapes it compiled) swaps U and V."""
    A = jx["A"].T.copy()
    S, U, VT = st.svd_range(_t(A), OPTS, il=2, iu=11)
    Sj, Uj, VTj = (np.asarray(x) for x in sj.svd_range(A, OPTS, il=2, iu=11))
    assert U.shape == (N, 9) and VT.shape == (9, M)
    assert _rel(S, Sj, Sj[0]) <= 1e-12
    _sign_free(Uj, U)
    _sign_free(VTj, VT, axis=1)
    small = _gen(6, 5, 11)
    S, U, VT = st.svd_range(_t(small), il=1, iu=3)
    np.testing.assert_allclose(S.numpy(), np.linalg.svd(small, compute_uv=False)[1:3],
                               atol=1e-13)
    with pytest.raises(st.SlateError, match="index range"):
        st.svd_range(_t(A), il=3, iu=3)
    with pytest.raises(st.SlateError, match="chase_distributed"):
        st.svd(_t(A), chase_distributed=True)
