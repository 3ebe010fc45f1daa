"""The verb-style aliases of the PyTorch port (slate_tpu_torch.simplified)
against the JAX package's (slate_tpu.simplified).

Every name of the JAX module exists in the port and points at the port's
routine of the same name; a few verbs are driven through both packages on
numpy-seeded inputs.  Tolerances: 1e-12 relative in f64.
"""

import numpy as np
import pytest
import torch

import slate_tpu as sj
from slate_tpu import simplified as js
from slate_tpu_torch import simplified as ts

VERBS = sorted(js.__all__)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.linalg.norm(got - np.asarray(want)) / np.linalg.norm(np.asarray(want))


@pytest.mark.parametrize("verb", VERBS)
def test_every_verb_aliases_the_same_routine(verb):
    """Same names as the JAX module, each bound to the port's routine that the
    JAX verb binds to (eig_vals is a wrapper in both)."""
    assert verb in ts.__all__
    jfn, tfn = getattr(js, verb), getattr(ts, verb)
    if verb == "eig_vals":
        return
    assert tfn.__name__ == jfn.__name__
    home = tfn.__module__.replace("slate_tpu_torch", "slate_tpu")
    assert home == jfn.__module__ or tfn.__name__ in ("submit", "solve_many")


def test_eig_and_svd_verbs_match_jax():
    M = _rng(1).standard_normal((24, 24))
    a = (M + M.T) / 2
    lam = ts.eig_vals(_t(a))
    assert _rel(lam, js.eig_vals(a)) <= 1e-12
    lam2, Z = ts.eig(_t(a))
    assert _rel(lam2, np.linalg.eigvalsh(a)) <= 1e-12
    g = _rng(2).standard_normal((30, 20))
    assert _rel(ts.svd_vals(_t(g)), js.svd_vals(g)) <= 1e-12
    S, U, VT = ts.svd(_t(g))
    np.testing.assert_allclose((U.numpy() * S.numpy()) @ VT.numpy(), g, atol=1e-12)


def test_band_and_indefinite_verbs_match_jax():
    n, kd = 30, 3
    r, c = np.indices((n, n))
    a = np.where(np.abs(r - c) <= kd, _rng(3).standard_normal((n, n)), 0.0)
    a = (a + a.T) / 2 + np.diag(np.full(n, 10.0))
    b = _rng(4).standard_normal((n, 2))
    x, info = ts.band_chol_solve(_t(np.tril(a)), _t(b), kd=kd)
    xj, infoj = js.band_chol_solve(np.tril(a), b, kd=kd)
    assert int(info) == int(infoj) == 0 and _rel(x, xj) <= 1e-12
    x, info = ts.band_lu_solve(_t(a), _t(b), kl=kd, ku=kd)
    assert int(info) == 0 and _rel(a @ x.numpy(), b) <= 1e-12
    s = (a - 10.5 * np.eye(n))
    x, info = ts.indefinite_solve(_t(s), _t(b), {"block_size": 8})
    xj, infoj = js.indefinite_solve(s, b, {"block_size": 8})
    assert int(info) == int(infoj) == 0 and _rel(x, xj) <= 1e-12


def test_solver_verbs_match_jax():
    n = 20
    M = _rng(5).standard_normal((n, n))
    spd = M @ M.T + n * np.eye(n)
    b = _rng(6).standard_normal((n, 2))
    X, info = ts.chol_solve(_t(spd), _t(b))
    assert int(info) == 0 and _rel(spd @ X.numpy(), b) <= 1e-12
    X = ts.lu_solve(_t(M + n * np.eye(n)), _t(b))[0]
    assert _rel(X, sj.gesv(M + n * np.eye(n), b)[0]) <= 1e-12
    tall = _rng(7).standard_normal((40, 8))
    y = _rng(8).standard_normal((40, 2))
    x = ts.least_squares_solve(_t(tall), _t(y))
    assert _rel(x, np.linalg.lstsq(tall, y, rcond=None)[0]) <= 1e-10
