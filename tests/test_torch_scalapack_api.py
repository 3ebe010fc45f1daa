"""The port's ScaLAPACK-style API (``slate_tpu_torch.scalapack_api``) against the
JAX package's: mirrors the ScaLAPACK half of ``tests/test_compat_api.py``.

A grid is multi-controller: four gloo ranks (one pool for the module) each
call ``gridinit(2, 2, device="cpu")`` and the same p* routine on the same
numpy inputs; every rank's answer must be the same, and
``torch_rank_jobs.counted_call`` counts the collectives each call made, so a
call is shown to take its distributed body (or the single-device skin).  The
JAX package runs the same calls on a 2x2 grid of its virtual mesh, imported
lazily (the ranks import this module, torch only).  Last, the CPU rehearsal
of ``chip_smoke.py``'s phase 14 on a world of one."""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slate_tpu_torch import scalapack_api as sapi
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.parallel.launch import RankPool
from torch_rank_jobs import counted_call

G22 = (2, 2, "col")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    from slate_tpu import lapack_api as jlapi
    from slate_tpu import scalapack_api as jsapi

    return SimpleNamespace(lapi=jlapi, sapi=jsapi)


def rng(seed=0):
    return np.random.default_rng(seed)


def spd(n, seed=0, dtype=np.float32):
    a = rng(seed).standard_normal((n, n)).astype(dtype)
    return a @ a.T + n * np.eye(n, dtype=dtype)


def _p_calls(calls, spec):
    """On each rank: select a p x q grid, run each (routine, args) and return
    [(result, collectives made)] — the multi-controller ScaLAPACK call."""
    sapi.gridinit(spec[0], spec[1], device="cpu")
    try:
        return [counted_call(f"slate_tpu_torch.scalapack_api.{name}", args, {}, spec)
                for name, args in calls]
    finally:
        sapi.gridexit()


def _run(pool, calls):
    """Rank 0's [(result, collectives)]; every rank's results are the same bits."""
    res = pool.run(_p_calls, calls, G22)
    for other in res[1:]:
        for (r0, _), (r, _) in zip(res[0], other):
            for a, b in zip(r0 if isinstance(r0, tuple) else (r0,),
                            r if isinstance(r, tuple) else (r,)):
                np.testing.assert_array_equal(a, b)
    return res[0]


def _jax_grid(jx, calls):
    jx.sapi.gridinit(2, 2)
    try:
        return [getattr(jx.sapi, name)(*args) for name, args in calls]
    finally:
        jx.sapi.gridexit()


def test_generated_names_match_the_jax_package(jx):
    assert sapi.__all__ == jx.sapi.__all__
    assert all(callable(getattr(sapi, n)) for n in sapi.__all__)
    assert sapi.pdgemm.__name__ == "pdgemm" and sapi.pzcgesv.__name__ == "pzcgesv"


class TestEnvTuning:
    def test_nb_env(self, monkeypatch, jx):
        monkeypatch.setenv("SLATE_LAPACK_NB", "8")
        monkeypatch.setenv("SLATE_SCALAPACK_NB", "16")
        assert sapi._nb() == 16
        a = rng(1).standard_normal((16, 16)).astype(np.float32)
        b = rng(2).standard_normal((16, 16)).astype(np.float32)
        out = sapi.psgemm("n", "n", 1.0, a, b, 0.0, np.zeros_like(a), device="cpu")
        np.testing.assert_allclose(out, a @ b, rtol=1e-5)
        np.testing.assert_allclose(
            out, jx.sapi.psgemm("n", "n", 1.0, a, b, 0.0, np.zeros_like(a)), rtol=1e-5)


class TestScalapack:
    def test_without_grid_falls_through(self, jx):
        sapi.gridexit()
        assert sapi.current_grid() is None
        a = rng(1).standard_normal((8, 8)).astype(np.float32)
        out = sapi.psgemm("n", "n", 1.0, a, a, 0.0, np.zeros_like(a), device="cpu")
        np.testing.assert_allclose(out, a @ a, rtol=1e-5)
        jx.sapi.gridexit()
        np.testing.assert_allclose(
            out, jx.sapi.psgemm("n", "n", 1.0, a, a, 0.0, np.zeros_like(a)), rtol=1e-5)
        with pytest.raises(SlateError, match="CUDA"):     # cuda unless asked
            sapi.psgemm("n", "n", 1.0, a, a, 0.0, np.zeros_like(a))
        with pytest.raises(SlateError, match="CUDA"):
            sapi.gridinit(1, 1)

    def test_grid_gemm_distributed(self, pool, jx):
        """psgemm over a 2x2 grid of four ranks (the mpirun -np 4 analogue):
        the shapes do not divide the grid, so the operands are padded."""
        a = rng(2).standard_normal((24, 20)).astype(np.float32)
        b = rng(3).standard_normal((20, 28)).astype(np.float32)
        c = rng(4).standard_normal((24, 28)).astype(np.float32)
        calls = [("psgemm", ("n", "n", 1.5, a, b, 0.5, c)),
                 ("pdgemm", ("t", "n", -1.0, b.astype(np.float64), b, 0.0,
                             np.zeros((28, 28))))]
        (out, n1), (out2, n2) = _run(pool, calls)
        assert n1 > 0 and n2 > 0
        np.testing.assert_allclose(out, 1.5 * a @ b + 0.5 * c, rtol=1e-4, atol=1e-4)
        b64 = b.astype(np.float64)
        np.testing.assert_allclose(out2, -b64.T @ b64, rtol=1e-12, atol=1e-12)
        jout = _jax_grid(jx, calls[:1])[0]
        np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)

    def test_grid_posv(self, pool, jx):
        n = 16
        a = spd(n, 5)
        b = rng(6).standard_normal((n, 2)).astype(np.float32)
        calls = [("psposv", ("lower", a, b)), ("psposv", ("upper", a, b[:, 0]))]
        (res, count), (res1, _) = _run(pool, calls)
        x, info = res
        assert count > 0 and info == 0
        np.testing.assert_allclose(a @ x, b, rtol=1e-2, atol=1e-3)
        np.testing.assert_allclose(res1[0], x[:, 0], rtol=1e-5, atol=1e-6)
        jx_, jinfo = _jax_grid(jx, calls[:1])[0]
        assert jinfo == info
        np.testing.assert_allclose(x, jx_, rtol=1e-4, atol=1e-5)

    def test_grid_too_big_raises(self, pool, jx):
        with pytest.raises(ValueError):
            sapi.gridinit(5, 2, device="cpu")       # no launcher: a world of one
        assert sapi.current_grid() is None
        assert all(pool.run(_too_big))
        import jax
        with pytest.raises(ValueError):
            jx.sapi.gridinit(len(jax.devices()) + 1, 2)
        jx.sapi.gridexit()


def _too_big():
    try:
        sapi.gridinit(3, 2, device="cpu")           # a world of four ranks
    except ValueError:
        return sapi.current_grid() is None
    return False


class TestDistributedFamilies:
    """laset and the distributed p-routings (potrf/potri/pocon, getrf/getri/
    gecon, lantr, trcon) on an active 2x2 grid, against the JAX package's on
    the same inputs."""

    def test_dlaset(self, jx):
        out = sapi.pdlaset("g", 5, 7, 2.0, 9.0, device="cpu")
        assert out.shape == (5, 7) and out[0, 0] == 9.0 and out[0, 1] == 2.0
        base = np.arange(16.0).reshape(4, 4)
        lo = sapi.pdlaset("l", 4, 4, 0.0, 1.0, base.copy(), device="cpu")
        assert lo[2, 0] == 0.0 and lo[2, 2] == 1.0 and lo[0, 3] == 3.0
        np.testing.assert_array_equal(lo, jx.lapi.dlaset("l", 4, 4, 0.0, 1.0, base.copy()))

    def test_distributed_p_families(self, pool, jx):
        n = 32
        M = rng(5).standard_normal((n, n)).astype(np.float32)
        S = (M @ M.T + n * np.eye(n)).astype(np.float32)
        A = (M + n * np.eye(n)).astype(np.float32)
        T2 = np.triu(M) + n * np.eye(n, dtype=np.float32)
        anorm_s, anorm_a = np.abs(S).sum(0).max(), np.abs(A).sum(0).max()
        first = [("pspotrf", ("l", S.copy())), ("psgetrf", (A.copy(),))]
        (fac, c1), (lu_out, c2) = _run(pool, first)
        Lf, info = fac
        lu_, ipiv, info2 = lu_out
        assert info == 0 and info2 == 0 and c1 > 0 and c2 > 0
        calls = [("pspotri", ("l", Lf)), ("pspocon", ("l", Lf, anorm_s)),
                 ("psgetri", (lu_, ipiv)), ("psgecon", ("1", lu_, ipiv, anorm_a)),
                 ("pslantr", ("1", "u", "n", np.triu(M))),
                 ("pslantr", ("m", "u", "u", np.triu(np.full((8, 8), 3.0, np.float32)))),
                 ("pslaset", ("g", 8, 8, 2.0, 5.0)),
                 ("pstrcon", ("1", "u", "n", T2)), ("pstrcon", ("i", "u", "u", T2))]
        res = _run(pool, calls)
        out = [r for r, _ in res]
        counts = {name: c for (name, _), (_, c) in zip(calls, res)}
        assert counts["pslaset"] == 0                    # no distributed body
        assert all(c > 0 for name, c in counts.items() if name != "pslaset")
        inv, rc, invA, rc2, v, vu, Z, rc3, rci = out
        ref = np.linalg.inv(S.astype(np.float64))
        assert np.abs(np.tril(inv) - np.tril(ref)).max() / np.abs(ref).max() < 1e-4
        ref_rc = 1.0 / (anorm_s * np.abs(ref).sum(axis=0).max())
        assert 0.2 * ref_rc < rc < 5 * ref_rc
        assert np.abs(invA - np.linalg.inv(A.astype(np.float64))).max() < 1e-4
        assert 0.0 < rc2 <= 1.0
        assert abs(v - np.abs(np.triu(M)).sum(axis=0).max()) < 1e-2
        assert vu == 3.0   # unit diag replaces the stored 3s with 1s
        assert Z[0, 0] == 5.0 and Z[0, 1] == 2.0
        Tinv = np.linalg.inv(T2.astype(np.float64))
        ref3 = 1.0 / (np.abs(T2).sum(axis=0).max() * np.abs(Tinv).sum(axis=0).max())
        assert 0.2 * ref3 < rc3 < 5 * ref3 and 0.0 < rci <= 1.0
        # the JAX package's p* on its 2x2 grid, on the same inputs
        jfac, jlu = _jax_grid(jx, first)
        np.testing.assert_allclose(Lf, jfac[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ipiv, jlu[1])
        np.testing.assert_allclose(lu_, jlu[0], rtol=1e-4, atol=1e-4)
        jout = _jax_grid(jx, calls)
        for name, got, want in zip([c[0] for c in calls], out, jout):
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4, err_msg=name)

    def test_solver_and_eig_bodies(self, pool, jx):
        """Every other distributed body on the 2x2 grid against the JAX
        package's p* on its 2x2 grid and against the single-device skin (no
        grid), all on the same inputs."""
        n = 24
        M = rng(7).standard_normal((n, n))
        S = M @ M.T + n * np.eye(n)
        B = rng(8).standard_normal((n, 3))
        C = rng(9).standard_normal((n, n))
        Z = (M + 1j * rng(10).standard_normal((n, n))).astype(np.complex128)
        H = Z @ Z.conj().T + n * np.eye(n)
        tall = rng(11).standard_normal((40, n))
        lu_, ipiv, _ = sapi.pdgetrf(M, device="cpu")
        uf, _ = sapi.pdpotrf("u", S, device="cpu")
        calls = [("pdgesv", (M, B)), ("pdgesv_mixed", (M, B)),
                 ("pdgetrs", ("n", lu_, ipiv, B)), ("pdgels", ("n", tall, tall[:, :2])),
                 ("pdtrsm", ("l", "u", "t", "n", 2.0, S, B)),
                 ("pdtrsm", ("l", "l", "n", "u", -1.5, S, B)),
                 ("pdtrmm", ("l", "l", "n", "u", 0.5, S, B)),
                 ("pzhemm", ("l", "u", 1.0, H, Z, 0.5, Z)),
                 ("pdsymm", ("r", "l", 2.0, S, C, 0.0, C)),
                 ("pzherk", ("l", "c", 1.0, Z, 0.5, H)), ("pdsyrk", ("u", "n", 1.0, M, 0.0, S)),
                 ("pzher2k", ("u", "n", 1.0, Z, Z, 0.5, H)),
                 ("pdsyr2k", ("l", "t", 1.0, M, C, 0.5, S)),
                 ("pdsyev", ("v", "l", S)), ("pzheevd", ("n", "u", H)),
                 ("pdsyevx", ("v", "l", S, 2, 5)), ("pdgesvd", ("s", "s", tall)),
                 ("pdgesvdx", ("v", "v", M, 1, 3)), ("pdlange", ("f", M)),
                 ("pzlanhe", ("i", "l", H)), ("pdlansy", ("m", "u", S)),
                 ("pdpotri", ("u", uf)),
                 ("pdtrsm", ("r", "l", "n", "n", 1.0, S, B.T))]
        with ThreadPoolExecutor(1) as ex:     # the JAX calls compile meanwhile
            jres = ex.submit(_jax_grid, jx, calls)
            res = _run(pool, calls)
            jres = jres.result()
        for (name, args), (got, count), jgot in zip(calls, res, jres):
            if name == "pdtrsm" and args[0] == "r":
                assert count == 0, name          # right side: the single-device skin
            else:
                assert count > 0, name
            want = getattr(sapi, name)(*args, device="cpu")
            got, want, jgot = ((got, want, jgot) if isinstance(got, tuple)
                               else ((got,), (want,), (jgot,)))
            assert len(got) == len(want) == len(jgot), name
            if name in ("pdgesv", "pdgesv_mixed"):
                # tournament against partial pivoting: the pivots may differ,
                # so the solution and info are held
                assert got[2] == want[2] == jgot[2] == 0, name
                got, want, jgot = got[:1], want[:1], jgot[:1]
            for g, w, j in zip(got, want, jgot):
                if g is None:
                    assert w is None and j is None, name
                    continue
                if name in ("pdsyev", "pdsyevx", "pdgesvd", "pdgesvdx"):
                    g, w, j = np.abs(g), np.abs(w), np.abs(j)   # vectors up to sign
                np.testing.assert_allclose(g, j, rtol=1e-8, atol=1e-8,
                                           err_msg=f"{name} against the JAX package")
                np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-8, err_msg=name)


def test_device_keyword_must_match_the_grid(one_rank_world):
    from slate_tpu_torch.core import matrix as cm

    old, cm.BIND_MIN_RANKS = cm.BIND_MIN_RANKS, 1
    try:
        g = sapi.gridinit(1, 1, device="cpu")
        assert sapi.current_grid() is g and sapi.blacs_gridinit is sapi.gridinit
        a = np.eye(4, dtype=np.float32) * 2
        np.testing.assert_array_equal(sapi.pslange("m", a, device="cpu"), 2.0)
        with pytest.raises(SlateError, match="grid"):
            sapi.pslange("m", a, device="meta")
    finally:
        cm.BIND_MIN_RANKS = old
        sapi.gridexit()


@pytest.fixture
def one_rank_world():
    """A world of one in this process; it ends with the test."""
    import torch.distributed as dist
    from slate_tpu_torch.parallel import mesh as pmesh

    started = not dist.is_initialized()
    yield
    if started:
        pmesh.destroy()


SMALL_COMPAT = {"tiles": 64, "grids": ((4, 2), (2, 4)), "pool_blocks": 512,
                "n": 96, "nb": 32, "nrhs": 3, "ls_m": 256, "ls_n": 32, "ls_nrhs": 4,
                "inv_n": 48, "eig_n": 48}


def test_chip_phase_14_rehearsal(one_rank_world, tmp_path):
    import chip_smoke as cs

    res = cs.compat_path("cpu", SMALL_COMPAT, tmp_dir=str(tmp_path))
    cs.check_compat_path(res, SMALL_COMPAT)
    assert res["native_backend"] == "native"
    assert res["grid"].startswith("1x1") and res["world_size"] == 1
    assert not list(tmp_path.iterdir())          # the checkpoint is removed
