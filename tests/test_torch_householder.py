"""Householder kernels of the PyTorch port (slate_tpu_torch.linalg.householder)
against the JAX package's (slate_tpu.linalg.householder).

Inputs come from a numpy seed and go through both packages on the CPU.
Tolerances: the reflectors (v, tau, beta), panel factors (R, V, taus), T
factors and accumulated Q agree within 1e-12 (max abs, on O(1) data) in
float64 and complex128 — the same operations in the same order, rounded by
different libraries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from slate_tpu.linalg import householder as jh
from slate_tpu_torch.linalg import householder as th

TOL = 1e-12


def _data(shape, seed, cplx=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return x


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
@pytest.mark.parametrize("case", ["random", "zero_tail", "zero", "batched"])
def test_larfg_matches_jax(case, cplx):
    """sign(0) = 1 convention, the zero-tail no-op, and a batch of windows."""
    x = _data((5, 9) if case == "batched" else (9,), 1, cplx)
    if case == "zero_tail":
        x[..., 1:] = 0
        x[..., 0] = -0.0 if not cplx else 0.0
    if case == "zero":
        x[...] = 0
    for a, b in zip(jh.larfg(jnp.asarray(x)), th.larfg(torch.from_numpy(x))):
        _close(b, a)
    v, tau, beta = th.larfg(torch.from_numpy(x))
    if case in ("zero_tail", "zero"):
        assert (tau == 0).all()


@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
@pytest.mark.parametrize("pivot", [0, 5, 11, 13], ids=["p0", "p5", "last", "past-end"])
def test_larfg_masked_matches_jax(pivot, cplx):
    """A pivot past the end reads the last element, as the clamped gather
    of the JAX package does (a zero v; tau nonzero for complex data)."""
    x = _data((12,), 2, cplx)
    for a, b in zip(jh.larfg_masked(jnp.asarray(x), pivot),
                    th.larfg_masked(torch.from_numpy(x), pivot)):
        _close(b, a)


@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
def test_apply_left_right_match_jax(cplx):
    A = _data((7, 5), 3, cplx)
    v, tau, _ = jh.larfg(jnp.asarray(_data((7,), 4, cplx)))
    vt, taut = torch.from_numpy(np.asarray(v)), torch.from_numpy(np.asarray(tau))
    _close(th.apply_left(taut, vt, torch.from_numpy(A)), jh.apply_left(tau, v, A))
    v5, tau5, _ = jh.larfg(jnp.asarray(_data((5,), 5, cplx)))
    _close(th.apply_right(torch.from_numpy(np.asarray(tau5)), torch.from_numpy(np.asarray(v5)),
                          torch.from_numpy(A)), jh.apply_right(tau5, v5, A))


@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
@pytest.mark.parametrize("off", [0, 3, 17], ids=["off0", "off3", "ragged"])
def test_panel_qr_lq_and_build_T_match_jax(off, cplx):
    """off=17 on a 21-row panel of 8 columns runs pivots past the end (the
    ragged last panel of he2hb / ge2tb)."""
    P = _data((21, 8), 6, cplx)
    Rj, Vj, tj = jh.panel_qr_masked(jnp.asarray(P), off, 8)
    Rt, Vt, tt = th.panel_qr_masked(torch.from_numpy(P), off, 8)
    for a, b in ((Rj, Rt), (Vj, Vt), (tj, tt)):
        _close(b, a)
    _close(th.build_T(Vt, tt), jh.build_T(Vj, tj))
    Lj, VLj, tLj = jh.panel_lq_masked(jnp.asarray(P.T.copy()), off, 8)
    Lt, VLt, tLt = th.panel_lq_masked(torch.from_numpy(P.T.copy()), off, 8)
    for a, b in ((Lj, Lt), (VLj, VLt), (tLj, tLt)):
        _close(b, a)


@pytest.mark.parametrize("conj_q", [False, True])
@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
def test_block_apply_matches_jax(cplx, conj_q):
    P = _data((12, 4), 7, cplx)
    _, V, taus = jh.panel_qr_masked(jnp.asarray(P), 2, 4)
    T = jh.build_T(V, taus)
    Vt, Tt = torch.from_numpy(np.asarray(V)), torch.from_numpy(np.asarray(T))
    C = _data((12, 12), 8, cplx)
    _close(th.block_apply_left(Vt, Tt, torch.from_numpy(C), conj_q),
           jh.block_apply_left(V, T, jnp.asarray(C), conj_q))
    _close(th.block_apply_right(Vt, Tt, torch.from_numpy(C), conj_q),
           jh.block_apply_right(V, T, jnp.asarray(C), conj_q))


def _sweep_reflectors(n, b, seed, cplx):
    """Chase-shaped reflectors: per sweep s and block r a unit-pivot v on
    rows s+1+r*b.., zero past row n-1, with the unitary tau = 2/|v|^2 (tau 0
    for blocks wholly past the end)."""
    n_sweeps, m_max = n - 2, -(-(n - 1) // b)
    Vs = _data((n_sweeps, m_max, b), seed, cplx)
    Vs[..., 0] = 1.0
    s, r, i = np.ogrid[:n_sweeps, :m_max, :b]
    Vs[np.broadcast_to(s + 1 + r * b + i >= n, Vs.shape)] = 0
    nrm2 = np.sum(np.abs(Vs) ** 2, axis=-1)
    taus = np.where(nrm2 > 0, 2.0 / np.where(nrm2 > 0, nrm2, 1), 0)
    return Vs, taus.astype(Vs.dtype)


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("cplx", [False, True], ids=["f64", "c128"])
def test_sweep_accumulate_matches_jax(cplx, group):
    """The dense Q, the Q0 row-block form and the reverse (Q^H) form; the
    JAX package's group size changes nothing in the port."""
    n, b = 19, 4
    Vs, taus = _sweep_reflectors(n, b, 9, cplx)
    Vt, tt = torch.from_numpy(Vs), torch.from_numpy(taus)
    Qj = jh.sweep_accumulate(jnp.asarray(Vs), jnp.asarray(taus), n, b, group)
    Qt = th.sweep_accumulate(Vt, tt, n, b, group)
    _close(Qt, Qj)
    eye = np.eye(n)
    assert np.abs(Qt.numpy().conj().T @ Qt.numpy() - eye).max() < 1e-13
    X = _data((5, n), 10, cplx)
    for reverse in (False, True):
        _close(th.sweep_accumulate(Vt, tt, n, b, group, Q0=torch.from_numpy(X),
                                   reverse=reverse),
               jh.sweep_accumulate(jnp.asarray(Vs), jnp.asarray(taus), n, b, group,
                                   Q0=jnp.asarray(X), reverse=reverse))
    # reverse with Q0 = X^H gives (Q X)^H without forming Q
    Y = _data((n, 3), 11, cplx)
    QY = th.sweep_accumulate(Vt, tt, n, b, group, Q0=torch.from_numpy(Y.conj().T.copy()),
                             reverse=True).numpy().conj().T
    np.testing.assert_allclose(QY, Qt.numpy() @ Y, rtol=0, atol=1e-12)
