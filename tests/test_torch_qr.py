"""QR / least-squares family of the PyTorch port (slate_tpu_torch.linalg.qr)
against the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU.
Tolerances: factors (packed R/V, tau, T, Q) and solutions within 1e-12
relative Frobenius in f64 and 1e-5 in f32 (the same Householder and Cholesky
library routines over different LAPACK builds); reconstruction and
orthogonality gates as in ``tests/test_qr.py``; exception types identical.
"""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu.linalg import qr as jqr
from slate_tpu_torch.core.matrix import from_reference_factors
from slate_tpu_torch.linalg import qr as tqr


def _gen(seed, m, n, cplx=False, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if cplx:
        a = a + 1j * rng.standard_normal((m, n))
    return a if cplx else a.astype(dtype)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got).astype(np.complex128), _np(want).astype(np.complex128)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cplx", [False, True])
def test_geqrf_reconstruct(cplx):
    m, n = 23, 11
    a = _gen(1, m, n, cplx)
    fj = sj.geqrf(sj.Matrix.from_array(a.copy(), nb=8))
    At = st.Matrix.from_array(_t(a), nb=8)
    ft = st.geqrf(At)
    for name in ("packed", "tau", "T"):
        assert _rel(getattr(ft, name), getattr(fj, name)) <= 1e-12, name
    Q, R = ft.Q().numpy(), ft.R().numpy()
    assert _rel(Q, fj.Q()) <= 1e-12 and _rel(R, fj.R()) <= 1e-12
    assert np.linalg.norm(Q @ R - a) / np.linalg.norm(a) < 1e-13
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(n)) < 1e-13
    # packed form written back: R in the upper triangle
    np.testing.assert_allclose(np.triu(At.array.numpy()[:n, :]), R, rtol=1e-12)
    assert _rel(ft.Q(full=True), fj.Q(full=True)) <= 1e-12


def test_geqrf_f32():
    a = _gen(2, 40, 12, dtype=np.float32)
    fj, ft = sj.geqrf(a), st.geqrf(_t(a))
    assert ft.packed.dtype == torch.float32
    assert _rel(ft.packed, fj.packed) <= 1e-5 and _rel(ft.T, fj.T) <= 1e-5


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("op", ["n", "c", "t"])
def test_unmqr_matches_explicit_q(op, side, cplx, source):
    """op(Q) C from the port's own factors and from the JAX package's factors
    carried across (TriangularFactors.from_reference); a plain transpose of a
    complex Q raises in both packages."""
    m, n = 17, 7
    a = _gen(3, m, n, cplx)
    fj = sj.geqrf(a)
    if source == "jax":
        ft = from_reference_factors({"packed": np.asarray(fj.packed),
                                     "tau": np.asarray(fj.tau), "T": np.asarray(fj.T)},
                                    device="cpu")
    else:
        ft = st.geqrf(_t(a))
    c = _gen(4, m, 5, cplx) if side == "left" else _gen(4, 5, m, cplx)
    if op == "t" and cplx:
        with pytest.raises(sj.SlateError):
            sj.linalg.unmqr(side, op, fj, c.copy())
        with pytest.raises(st.SlateError):
            st.unmqr(side, op, ft, _t(c))
        return
    got = st.unmqr(side, op, ft, _t(c)).numpy()
    assert _rel(got, sj.linalg.unmqr(side, op, fj, c.copy())) <= 1e-12
    Qf = np.asarray(fj.Q(full=True))
    Qop = {"n": Qf, "c": Qf.conj().T, "t": Qf.T}[op]
    np.testing.assert_allclose(got, Qop @ c if side == "left" else c @ Qop,
                               rtol=1e-10, atol=1e-10)


def test_triangular_factors_from_reference_rebuilds_T():
    a = _gen(5, 20, 6)
    fj = sj.geqrf(a)
    ft = tqr.TriangularFactors.from_reference(fj, device="cpu")   # the object itself
    assert _rel(ft.T, fj.T) <= 1e-14
    no_t = tqr.TriangularFactors.from_reference(
        {"packed": np.asarray(fj.packed), "tau": np.asarray(fj.tau)}, device="cpu")
    assert _rel(no_t.T, fj.T) <= 1e-12
    with pytest.raises(st.SlateError):
        from_reference_factors({"R": a}, device="cpu")


def test_gelqf_unmlq():
    m, n = 9, 21
    a = _gen(6, m, n, cplx=True)
    fj = sj.gelqf(a.copy())
    At = st.Matrix.from_array(_t(a), nb=4)
    ft = st.gelqf(At)
    assert _rel(ft.packed, fj.packed) <= 1e-12
    L = ft.R().numpy().conj().T                # m x m lower
    Q1 = ft.Q().numpy()                        # n x m
    np.testing.assert_allclose(L @ Q1.conj().T, a, rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(np.tril(At.array.numpy())[:, :m], L, atol=1e-12)
    c = _gen(7, n, 3, cplx=True)
    for op in ("n", "c"):
        got = st.unmlq("left", op, ft, _t(c))
        assert _rel(got, sj.linalg.unmlq("left", op, fj, c.copy())) <= 1e-12
    with pytest.raises(st.SlateError):
        st.unmlq("left", "t", ft, _t(c))


@pytest.mark.parametrize("m,blocks", [(64, 4), (100, 3), (37, 0), (300, 5)])
def test_tsqr_tree(m, blocks):
    """Leaf QRs as one batched QR and a binary tree of stacked-R QRs (an odd
    level pads with a zero R at 3 and 5 blocks)."""
    n = 5
    a = _gen(m, m, n)
    Qj, Rj = jqr.tsqr(a, row_blocks=blocks)
    Q, R = st.linalg.tsqr(_t(a), row_blocks=blocks)
    assert _rel(Q, Qj) <= 1e-12 and _rel(R, Rj) <= 1e-12
    Q, R = Q.numpy(), R.numpy()
    assert np.linalg.norm(Q @ R - a) / np.linalg.norm(a) < 1e-13
    assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-12
    np.testing.assert_allclose(np.tril(R, -1), 0, atol=1e-13)


@pytest.mark.parametrize("case", ["plain", "shifted", "householder"])
def test_cholqr(case):
    """CholeskyQR2 and its two escalations: a Gram matrix whose Cholesky fails
    (cond ~1e9 squares past 1/eps) takes the shifted pass, a zero column (an
    exactly zero Gram pivot) the Householder QR.  Both packages take the same
    branch.  (A duplicate column is no test of the branch: its Gram pivot is
    rounding noise, and the two packages' Gram products round differently.)"""
    m, n = 200, 8
    a = _gen(8, m, n)
    if case == "shifted":
        a[:, 3] = a[:, 2] + 1e-9 * a[:, 3]
    elif case == "householder":
        a[:, 3] = 0.0
    Qj, Rj = sj.cholqr(a)
    Q, R = st.cholqr(_t(a))
    Q, R = Q.numpy(), R.numpy()
    assert np.linalg.norm(Q @ R - a) / np.linalg.norm(a) < 1e-12
    np.testing.assert_allclose(np.tril(R, -1), 0, atol=1e-12)
    if case == "plain":
        assert _rel(Q, Qj) <= 1e-12 and _rel(R, Rj) <= 1e-12
        assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-13
    elif case == "householder":
        # the fallback is the library QR itself, in both packages
        assert _rel(Q, Qj) <= 1e-12 and _rel(R, Rj) <= 1e-12
        assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-13
    else:
        # the shifted pass on cond ~1e9: the factor agrees to what the
        # conditioning leaves, and Q is orthogonal after the second pass
        assert _rel(R, Rj) <= 1e-6
        assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-12


@pytest.mark.parametrize("method", ["qr", "cholqr", "auto"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_gels_overdetermined(method, dtype):
    m, n, nrhs = 60, 10, 2
    a, b = _gen(9, m, n, dtype=dtype), _gen(10, m, nrhs, dtype=dtype)
    opts = {"method_gels": method}
    xj = np.asarray(sj.gels(a, b, opts))
    Bt = st.Matrix.from_array(_t(b), nb=8)
    x = st.gels(_t(a), Bt, opts)
    assert x.shape == (n, nrhs) and x.dtype == torch.from_numpy(a).dtype
    assert _rel(x, xj) <= (1e-12 if dtype == np.float64 else 1e-5)
    ref, *_ = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64), rcond=None)
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-9 if dtype == np.float64 else 1e-3,
                               atol=1e-9 if dtype == np.float64 else 1e-4)
    # x is n x nrhs, B is m x nrhs: the wrapper keeps B
    assert torch.equal(Bt.array, _t(b))
    xq = st.gels_qr(_t(a), _t(b)) if method == "qr" else st.gels_cholqr(_t(a), _t(b))
    if method != "auto":
        assert torch.equal(xq, x)


@pytest.mark.parametrize("defect", ["duplicate", "zero"])
def test_gels_cholqr_rank_deficient_fallback(defect):
    """Rank-deficient input.  A zero column makes the Gram Cholesky fail in
    both packages, and the Householder fallback (with clamped R diagonal)
    gives the same x.  A duplicate column leaves the Gram pivot at rounding
    noise: the JAX package's Cholesky passes and returns the CSNE solution
    (entries ~1e6 that cancel), the port's fails and returns the clamped
    Householder one; both reach the minimal residual, so only that is
    compared."""
    m, n = 60, 10
    a = _gen(11, m, n)
    if defect == "duplicate":
        a = np.column_stack([a[:, :n - 1], a[:, 0]])
    else:
        a[:, 4] = 0.0
    b = _gen(12, m, 2)
    xj = np.asarray(sj.gels(a, b, {"method_gels": "cholqr"}))
    x = st.gels_cholqr(_t(a), _t(b)).numpy()
    assert np.all(np.isfinite(x))
    if defect == "zero":
        assert _rel(x, xj) <= 1e-12
        return
    ref = np.linalg.norm(a @ np.linalg.lstsq(a, b, rcond=None)[0] - b)
    for got in (x, xj):
        assert np.linalg.norm(a @ got - b) <= ref * (1 + 1e-9)


@pytest.mark.parametrize("cplx", [False, True])
def test_gels_underdetermined_minimum_norm(cplx):
    m, n = 8, 20
    a, b = _gen(13, m, n, cplx), _gen(14, m, 2, cplx)
    xj = np.asarray(sj.gels(a, b))
    x = st.gels(_t(a), _t(b)).numpy()
    assert _rel(x, xj) <= 1e-12
    ref, *_ = np.linalg.lstsq(a, b, rcond=None)  # lstsq gives min-norm
    np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(a @ x, b, rtol=1e-9, atol=1e-9)


def test_gels_underdetermined_vector_rhs():
    """A 1-D right-hand side of a wide system gives a 1-D minimum-norm x, as
    the JAX package's gels does (examples/ex09 calls it so)."""
    m, n = 8, 20
    a, b = _gen(15, m, n), _gen(16, m, 1)[:, 0]
    xj = np.asarray(sj.gels(a, b))
    x = st.gels(_t(a), _t(b)).numpy()
    assert x.shape == xj.shape == (n,)
    assert _rel(x, xj) <= 1e-12


@pytest.mark.parametrize("m,n,zero_column", [(60, 10, False), (8, 20, False),
                                             (60, 10, True)],
                         ids=["tall", "wide", "zero-column"])
def test_gels_core(m, n, zero_column):
    """The raw core: CSNE for tall input, LQ minimum norm for wide, with the
    info code the JAX package gives (nonzero when the Gram Cholesky fails on a
    zero column, with no escape to Householder), and one info per matrix of a
    batch."""
    a, b = _gen(15, m, n), _gen(16, m, 3)
    if zero_column:
        a[:, 4] = 0.0
    xj, ij = sj.linalg.gels_core(a, b)
    xt, it = st.linalg.gels_core(_t(a), _t(b))
    assert int(it) == int(ij)
    if int(ij) == 0:
        assert _rel(xt, xj) <= 1e-12
    if m >= n:
        xb, ib = st.linalg.gels_core(_t(np.stack([a, a])), _t(np.stack([b, b])))
        assert ib.tolist() == [int(ij)] * 2
