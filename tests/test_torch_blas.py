"""BLAS-3 and auxiliary drivers of the PyTorch port (slate_tpu_torch.blas over
ops/blas3 and ops/elementwise) against the JAX package, in f64 and c128 on
the CPU.  Tolerance 1e-13 relative: the same products through two libraries."""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu.ops import blas3 as jblas3
from slate_tpu_torch.ops import blas3 as tblas3


def _rand(rng, shape, cplx):
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if cplx else x


def _close(got, want, rtol=1e-13):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
def test_level3_drivers_match_jax(cplx):
    rng = np.random.default_rng(50 + cplx)
    n, k = 9, 5
    a, b, c = _rand(rng, (n, k), cplx), _rand(rng, (n, k), cplx), _rand(rng, (n, n), cplx)
    s, g = _rand(rng, (n, n), cplx), _rand(rng, (n, k), cplx)
    t = lambda x: torch.from_numpy(x.copy())
    _close(st.gemm(2.0, t(a), t(b.T), 0.5, st.Matrix.from_array(t(c))),
           sj.gemm(2.0, a, b.T, 0.5, sj.Matrix.from_array(c)))
    for uplo in ("lower", "upper"):
        for side, bb, cc in (("left", g, _rand(rng, (n, k), cplx)),
                             ("right", g.T.copy(), _rand(rng, (k, n), cplx))):
            for name in ("symm", "hemm"):
                _close(getattr(st, name)(side, 1.5, t(s), t(bb), 0.25, t(cc), uplo=uplo),
                       getattr(sj, name)(side, 1.5, s, bb, 0.25, cc, uplo=uplo))
            for diag in ("nonunit", "unit"):
                _close(st.trmm(side, 2.0, t(s), t(bb), uplo=uplo, diag=diag),
                       sj.trmm(side, 2.0, s, bb, uplo=uplo, diag=diag))
        for name in ("syrk", "herk"):
            _close(getattr(st, name)(0.5, t(a), 2.0, t(c), uplo=uplo),
                   getattr(sj, name)(0.5, a, 2.0, c, uplo=uplo))
        for name in ("syr2k", "her2k"):
            _close(getattr(st, name)(0.5, t(a), t(b), 2.0, t(c), uplo=uplo),
                   getattr(sj, name)(0.5, a, b, 2.0, c, uplo=uplo))


def test_gram_matches_jax():
    x = np.random.default_rng(52).standard_normal((40, 300))
    _close(tblas3.gram(torch.from_numpy(x)), jblas3.gram(x))


def test_wrapper_outputs_and_aux_drivers_match_jax():
    rng = np.random.default_rng(53)
    a, b = rng.standard_normal((6, 6)), rng.standard_normal((6, 6))
    for uplo in ("lower", "upper"):
        Bj = sj.TrapezoidMatrix.from_array(uplo, b.copy())
        Bt = st.TrapezoidMatrix.from_array(uplo, b.copy(), device="cpu")
        _close(st.add(2.0, torch.from_numpy(a), 3.0, Bt), sj.add(2.0, a, 3.0, Bj))
        _close(Bt.array, Bj.array)
        _close(st.scale(2.0, 4.0, Bt), sj.scale(2.0, 4.0, Bj))
        _close(st.set(7.0, 1.0, Bt), sj.set(7.0, 1.0, Bj))
        _close(st.copy(torch.from_numpy(a), Bt), sj.copy(a, Bj))
    Gj, Gt = sj.Matrix.from_array(b.copy()), st.Matrix.from_array(b.copy(), device="cpu")
    _close(st.add(1.0, torch.from_numpy(a), -1.0, Gt), sj.add(1.0, a, -1.0, Gj))
    r, c = np.arange(1.0, 7.0), np.arange(2.0, 8.0)
    _close(st.scale_row_col(r, c, Gt), sj.scale_row_col(r, c, Gj))
    f = lambda i, j: i * 10 + j
    _close(st.set_from_function(f, Gt), sj.set_from_function(f, Gj))
    # trsm over wrappers writes its output wrapper, as the JAX package does
    T = np.tril(a) + 6 * np.eye(6)
    Xj = sj.trsm("left", 1.0, sj.TriangularMatrix.from_array("lower", T), Gj)
    Xt = st.trsm("left", 1.0, st.TriangularMatrix.from_array("lower", T, device="cpu"), Gt)
    _close(Xt, Xj)
    _close(Gt.array, Gj.array)
    with pytest.raises(st.SlateError):
        st.syrk(1.0, torch.from_numpy(a), 0.0, torch.from_numpy(b))   # no uplo
