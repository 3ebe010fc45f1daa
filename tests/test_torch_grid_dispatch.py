"""Grid-bound wrappers and the distributed compositions, against the JAX
package: mirrors ``tests/test_grid_dispatch.py`` (TestWrapperGridRouting, the
norm routing, ``test_gels_branches``) and ``tests/test_straggler_dist.py``
(TestInverseDist, TestLQDist, TestCondestDist, TestRbtDist).

A wrapper constructed with ``grid=`` holds a DTensor in the grid's block
layout, and the drivers with a distributed form run it: each routing test
also counts the collectives the call made.  The port runs on eight gloo ranks (one
pool for the module) in both grid orders, the JAX package on its virtual
8-device mesh, imported lazily (the ranks import this module, torch only).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slate_tpu_torch.parallel.launch import GRID, RankPool
from torch_rank_jobs import counted_call

G24 = {"col": (2, 4, "col"), "row": (2, 4, "row")}
ORDERS = ["col", "row"]


@pytest.fixture(scope="module")
def pool():
    with RankPool(8) as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    import slate_tpu
    from slate_tpu import parallel as jp

    return SimpleNamespace(jnp=jnp, jp=jp, slate=slate_tpu, g24=jp.ProcessGrid(2, 4))


def rng(s=0):
    return np.random.default_rng(s)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-300)


# ---------------------------------------------------------------------------
# the job the ranks run (torch only)


def _drive(kind, a, b, opts, spec):
    """Run one wrapper-level driver call on grid ``spec``; returns its result."""
    import slate_tpu_torch as st
    from slate_tpu_torch.core.matrix import distribution_grid
    from slate_tpu_torch.parallel.launch import grid_of, to_host

    g = grid_of(spec)
    t = None if a is None else torch.from_numpy(a)
    u = None if b is None else torch.from_numpy(b)
    nb = (opts or {}).get("block_size", 16)
    if kind == "construct":
        W = st.Matrix.from_array(t, nb=nb, grid=g)
        arr = W.storage.array
        out = (type(arr).__name__, [str(x) for x in arr.placements],
               tuple(arr.to_local().shape), to_host(W.array))
    elif kind == "potrf":
        out = st.potrf(st.HermitianMatrix.from_array("lower", t, nb=nb, grid=g), opts)
    elif kind == "posv":
        Bw = st.Matrix.from_array(u, nb=nb)
        st.posv(st.HermitianMatrix.from_array("lower", t, nb=nb, grid=g), Bw, opts)
        out = Bw.array
    elif kind == "gesv":
        out = st.gesv(st.Matrix.from_array(t, nb=nb, grid=g), u, opts)
    elif kind == "gemm":
        c = torch.from_numpy(opts.pop("c"))
        Cw = st.Matrix.from_array(c.clone(), nb=nb)
        st.gemm(0.5, st.Matrix.from_array(t, nb=nb, grid=g),
                st.Matrix.from_array(u, nb=nb), 2.0, Cw)
        out = Cw.array
    elif kind == "trsm":
        Bw = st.Matrix.from_array(u.clone(), nb=nb)
        st.trsm("left", 2.0, st.TriangularMatrix.from_array("lower", t, nb=nb,
                                                            grid=g), Bw, opts)
        out = Bw.array
    elif kind == "trsm_variant":
        # both operands on the grid; side, diag and the stationary method
        # from opts
        side, diag, method = opts["side"], opts["diag"], opts["method"]
        T = st.TriangularMatrix.from_array("lower", t, nb=nb, diag=diag, grid=g)
        Bw = st.Matrix.from_array(u.clone(), nb=nb, grid=g)
        getattr(st, method)(side, 2.0, T, Bw)
        out = Bw.array
    elif kind == "gels":
        out = st.gels(st.Matrix.from_array(t, nb=nb, grid=g), u, opts)
    elif kind == "norm":
        W = st.Matrix.from_array(t, nb=8, grid=g)
        out = [st.norm(k, W) for k in ("fro", "one", "inf", "max")]
    elif kind == "norm_herm":
        out = st.norm("one", st.HermitianMatrix.from_array("lower", t, nb=8, grid=g))
    elif kind == "norm_unit":
        out = st.norm("max", st.TriangularMatrix.from_array("lower", t, nb=8,
                                                            diag="unit", grid=g))
    elif kind == "gesv_rbt":
        out = st.gesv_rbt(st.Matrix.from_array(t, grid=g), u, opts)[0]
    elif kind == "mixed":
        other = grid_of((4, 2, spec[2]))
        A1 = st.Matrix.from_array(t, nb=8, grid=g)
        A2 = st.Matrix.from_array(t, nb=8, grid=other)
        try:
            distribution_grid(A1, A2)
            out = None
        except st.SlateError as e:
            out = str(e)
    elif kind == "nogrid":
        out = distribution_grid(st.Matrix.from_array(t, nb=8)) is None
    elif kind == "local":
        # drivers the JAX package runs on the global arrays, grid or not
        n = t.shape[0]
        H = st.HermitianMatrix.from_array("lower", t, nb=8, grid=g)
        spd = torch.eye(n, dtype=t.dtype) * 4 + u[:, :1] @ u[:, :1].T
        lam, _ = st.hegv(1, H, spd)
        band = st.BandMatrix(n, n, 2, 1, 8, grid=g, device="cpu", dtype=t.dtype)
        band.set_array(t)
        C = st.gbmm(1.0, band, u, 0.0, torch.zeros_like(u))
        out = (lam, C)
    elif kind.startswith("dist:"):
        # the eig/SVD, stedc, band and indefinite drivers on the grid
        n = t.shape[0]
        H = st.HermitianMatrix.from_array("lower", t, nb=8, grid=g)
        which = kind[len("dist:"):]
        if which == "heev":
            out = st.heev(H, {"block_size": 8})
        elif which == "svd":
            out = st.svd(st.Matrix.from_array(t, nb=8, grid=g), {"block_size": 8})
        elif which == "stedc":
            import importlib

            sm = importlib.import_module("slate_tpu_torch.linalg.stedc")
            old = sm._DIST_MERGE_MIN
            sm._DIST_MERGE_MIN = 64      # a small size takes the grid's merges
            try:
                out = sm.stedc(torch.diagonal(t).clone(), torch.diagonal(t, -1).clone(),
                               grid=g)
            finally:
                sm._DIST_MERGE_MIN = old
        elif which == "pbsv":
            band = st.HermitianBandMatrix("lower", n, 2, 8, grid=g, device="cpu",
                                          dtype=t.dtype)
            band.set_array(torch.tril(t))
            out = st.pbsv(band, u.clone(), {"block_size": 8})
        elif which == "gbsv":
            gband = st.BandMatrix(n, n, 1, 1, 8, grid=g, device="cpu", dtype=t.dtype)
            gband.set_array(t)
            out = st.gbsv(gband, u.clone(), {"block_size": 8})
        else:
            out = st.hesv(H, u.clone(), {"block_size": 8})
    else:
        raise ValueError(kind)
    return out


def drive(pool, kind, a=None, b=None, opts=None, order="col"):
    """Rank 0's host result of :func:`_drive` and how many collectives the
    call made there."""
    return pool.run(counted_call, "test_torch_grid_dispatch._drive",
                    (kind, a, b, opts, G24[order]), {}, G24[order])[0]


# ---------------------------------------------------------------------------


class TestWrapperGridRouting:
    @pytest.mark.parametrize("order", ORDERS)
    def test_construction_places_array(self, pool, jx, order):
        a = rng(1).standard_normal((64, 64)).astype(np.float32)
        (cls, placements, local, whole), _ = drive(pool, "construct", a, order=order)
        Aw = jx.slate.Matrix.from_array(jx.jnp.asarray(a), nb=16, grid=jx.g24)
        assert len(Aw.storage.array.sharding.device_set) == 8
        assert cls == "DTensor" and placements == ["S(0)", "S(1)"]
        assert local == (32, 16)
        np.testing.assert_array_equal(whole, a)

    @pytest.mark.parametrize("order", ORDERS)
    def test_potrf_routes_to_mesh(self, pool, jx, order):
        n = 96
        M = rng(2).standard_normal((n, n)).astype(np.float32)
        A = M @ M.T + n * np.eye(n, dtype=np.float32)
        (L, info), calls = drive(pool, "potrf", A, opts={"block_size": 16}, order=order)
        L = np.tril(L)
        assert calls > 0 and int(info) == 0
        assert np.abs(L @ L.T - A).max() / np.abs(A).max() < 1e-5
        H = jx.slate.HermitianMatrix.from_array("lower", jx.jnp.asarray(A), nb=16,
                                                grid=jx.g24)
        jL, jinfo = jx.slate.potrf(H, opts={"block_size": 16})
        assert int(jinfo) == 0 and np.abs(np.tril(np.asarray(jL)) - L).max() < 1e-4

    def test_posv_routes_to_mesh(self, pool):
        n = 64
        M = rng(12).standard_normal((n, n))
        A = M @ M.T + n * np.eye(n)
        b = rng(13).standard_normal((n, 3))
        X, calls = drive(pool, "posv", A, b, opts={"block_size": 16})
        assert calls > 0 and _rel(A @ X, b) < 1e-12

    @pytest.mark.parametrize("order", ORDERS)
    def test_gesv_routes_to_mesh(self, pool, jx, order):
        n = 80
        a = rng(3).standard_normal((n, n)).astype(np.float32)
        b = rng(4).standard_normal((n, 4)).astype(np.float32)
        (X, perm, info), calls = drive(pool, "gesv", a, b, {"block_size": 16}, order)
        assert calls > 0 and int(info) == 0
        assert np.abs(a @ X - b).max() < 5e-3
        Aw = jx.slate.Matrix.from_array(jx.jnp.asarray(a.copy()), nb=16, grid=jx.g24)
        _, jperm, _ = jx.slate.gesv(Aw, jx.jnp.asarray(b), opts={"block_size": 16})
        assert perm.tolist() == np.asarray(jperm).tolist()

    @pytest.mark.parametrize("order", ORDERS)
    def test_gemm_routes_to_mesh_unaligned(self, pool, order):
        m, k, n = 60, 52, 36
        a = rng(5).standard_normal((m, k)).astype(np.float32)
        b = rng(6).standard_normal((k, n)).astype(np.float32)
        c = rng(7).standard_normal((m, n)).astype(np.float32)
        C, calls = drive(pool, "gemm", a, b, {"c": c}, order)
        ref = 0.5 * a @ b + 2.0 * c
        assert calls > 0
        assert np.abs(C - ref).max() / np.abs(ref).max() < 1e-5

    def test_trsm_routes_to_mesh(self, pool):
        n = 48
        t = np.tril(rng(16).standard_normal((n, n))) + 5 * np.eye(n)
        b = rng(17).standard_normal((n, 2))
        X, calls = drive(pool, "trsm", t, b, {"block_size": 16})
        assert calls > 0 and np.abs(t @ X - 2.0 * b).max() < 1e-10
        X, calls = drive(pool, "trsm", t, rng(18).standard_normal((n, 40)),
                         {"block_size": 16})
        assert calls > 0

    @pytest.mark.parametrize("side", ["left", "right"])
    @pytest.mark.parametrize("diag", ["nonunit", "unit"])
    @pytest.mark.parametrize("method", ["trsmA", "trsmB"])
    def test_trsm_variants_on_the_grid(self, pool, jx, side, diag, method):
        """Both stationary methods, both sides and an implicit unit diagonal,
        with A and B bound to the grid, against the JAX package's grid-bound
        solve."""
        n, k = 48, 8
        t = np.tril(rng(19).standard_normal((n, n))) + 5 * np.eye(n)
        b = rng(20).standard_normal((n, k) if side == "left" else (k, n))
        X, calls = drive(pool, "trsm_variant", t, b,
                         {"side": side, "diag": diag, "method": method})
        T = np.tril(t)
        if diag == "unit":
            np.fill_diagonal(T, 1)
        r = T @ X - 2.0 * b if side == "left" else X @ T - 2.0 * b
        assert calls > 0
        assert np.abs(r).max() / (np.abs(T).sum(1).max() * np.abs(X).max()) < 1e-13
        Tj = jx.slate.TriangularMatrix.from_array("lower", jx.jnp.asarray(t), nb=16,
                                                  diag=diag, grid=jx.g24)
        Bj = jx.slate.Matrix.from_array(jx.jnp.asarray(b), nb=16, grid=jx.g24)
        getattr(jx.slate, method)(side, 2.0, Tj, Bj)
        assert _rel(X, np.asarray(Bj.array)) < 1e-10

    def test_mixed_grids_rejected(self, pool):
        msg, _ = drive(pool, "mixed", np.zeros((16, 16), np.float32))
        assert msg is not None and "different process grids" in msg

    def test_no_grid_stays_single_device(self, pool):
        a = rng(8).standard_normal((32, 32)).astype(np.float32)
        out, calls = drive(pool, "nogrid", a)
        assert out is True and calls == 0

    def test_15b_drivers_refuse_the_grid(self, pool, jx):
        """heev/svd/stedc/pbsv/gbsv/hesv on the 2x4 grid: each runs its
        distributed form (no longer refused), makes collectives,
        and agrees with the JAX package's grid-bound call: values within
        50 eps sqrt(n) ||A||_2, solves within the backward-error gate with
        info equal."""
        import importlib

        n = 16
        M = rng(9).standard_normal((n, n))
        A = M + M.T + 2 * n * np.eye(n)
        b = rng(10).standard_normal((n, 2))
        tol = 50 * np.finfo(np.float64).eps * np.sqrt(n) * np.linalg.norm(A, 2)
        gate = 50 * np.finfo(np.float64).eps * np.sqrt(n)
        slate, jnp, g = jx.slate, jx.jnp, jx.g24
        H = slate.HermitianMatrix.from_array("lower", jnp.asarray(A), nb=8, grid=g)

        (lam, Z), calls = drive(pool, "dist:heev", A, b)
        jlam, _ = slate.heev(H, {"block_size": 8})
        assert calls > 0 and np.abs(lam - np.asarray(jlam)).max() <= tol
        assert np.linalg.norm(A @ Z - Z * lam) / np.linalg.norm(A) < gate
        (S, U, VT), calls = drive(pool, "dist:svd", A, b)
        jS, _, _ = slate.svd(slate.Matrix.from_array(jnp.asarray(A), nb=8, grid=g),
                             {"block_size": 8})
        assert calls > 0 and np.abs(S - np.asarray(jS)).max() <= tol
        assert np.linalg.norm(U * S @ VT - A) / np.linalg.norm(A) < gate

        m = 80
        T = rng(11).standard_normal((m, m))
        T = np.diag(np.diag(T)) + np.diag(np.diag(T, -1), -1) + np.diag(np.diag(T, -1), 1)
        (lt, Qt), calls = drive(pool, "dist:stedc", T, b)
        jsm = importlib.import_module("slate_tpu.linalg.stedc")
        old = jsm._DIST_MERGE_MIN
        jsm._DIST_MERGE_MIN = 64
        try:
            jlt, _ = jsm.stedc(jnp.asarray(np.diag(T)), jnp.asarray(np.diag(T, -1)), grid=g)
        finally:
            jsm._DIST_MERGE_MIN = old
        assert calls > 0
        assert np.abs(lt - np.asarray(jlt)).max() <= 50 * np.finfo(float).eps * np.sqrt(
            m) * np.linalg.norm(T, 2)
        assert np.abs(T @ Qt - Qt * lt).max() < 1e-12

        ii, jj = np.mgrid[0:n, 0:n]
        Pb = np.where(np.abs(ii - jj) <= 2, A, 0.0)
        (X, info), calls = drive(pool, "dist:pbsv", Pb, b)
        Wb = slate.HermitianBandMatrix("lower", n, 2, 8, grid=g)
        Wb.set_array(jnp.asarray(np.tril(Pb)))
        jX, jinfo = slate.pbsv(Wb, jnp.asarray(b), {"block_size": 8})
        assert calls > 0 and int(info) == int(jinfo) == 0
        for x in (X, np.asarray(jX)):
            assert np.linalg.norm(Pb @ x - b) / (np.linalg.norm(Pb) * np.linalg.norm(x)) < gate
        Gb = np.where(np.abs(ii - jj) <= 1, A + M, 0.0)
        (X, info), calls = drive(pool, "dist:gbsv", Gb, b)
        Wg = slate.BandMatrix(n, n, 1, 1, 8, grid=g)
        Wg.set_array(jnp.asarray(Gb))
        jX, jinfo = slate.gbsv(Wg, jnp.asarray(b), {"block_size": 8})
        assert calls > 0 and int(info) == int(jinfo) == 0
        for x in (X, np.asarray(jX)):
            assert np.linalg.norm(Gb @ x - b) / (np.linalg.norm(Gb) * np.linalg.norm(x)) < gate
        (X, info), calls = drive(pool, "dist:hesv", A, b)
        jX, jinfo = slate.hesv(H, jnp.asarray(b), {"block_size": 8})
        assert calls > 0 and int(info) == int(jinfo) == 0
        for x in (X, np.asarray(jX)):
            assert np.linalg.norm(A @ x - b) / (np.linalg.norm(A) * np.linalg.norm(x)) < gate

    def test_drivers_without_a_distributed_form_run_locally(self, pool):
        """hegv and gbmm have no grid dispatch in the JAX package either: on a
        grid-bound wrapper they run on the whole matrix."""
        import scipy.linalg as sla

        n = 16
        M = rng(11).standard_normal((n, n))
        A = M + M.T
        b = rng(12).standard_normal((n, 3))
        (lam, C), _ = drive(pool, "local", A, b)
        spd = 4 * np.eye(n) + b[:, :1] @ b[:, :1].T
        np.testing.assert_allclose(np.sort(lam), sla.eigh(A, spd, eigvals_only=True),
                                   atol=1e-10)
        ii, jj = np.mgrid[0:n, 0:n]
        band = np.where((ii - jj <= 2) & (jj - ii <= 1), A, 0.0)
        np.testing.assert_allclose(C, band @ b, atol=1e-12)


class TestNormGridRouting:
    @pytest.mark.parametrize("order", ORDERS)
    def test_norm_wrapper_grid(self, pool, jx, order):
        a = rng(32).standard_normal((40, 24)).astype(np.float32)
        got, calls = drive(pool, "norm", a, order=order)
        W = jx.slate.Matrix.from_array(jx.jnp.asarray(a), nb=8, grid=jx.g24)
        assert calls > 0
        for k, g, ref in zip(("fro", "one", "inf", "max"), got,
                             [np.linalg.norm(a), np.abs(a).sum(0).max(),
                              np.abs(a).sum(1).max(), np.abs(a).max()]):
            assert abs(float(g) - ref) < 1e-3 * max(ref, 1)
            assert abs(float(g) - float(jx.slate.norm(k, W))) < 1e-5 * max(ref, 1)

    def test_norm_hermitian_wrapper_grid(self, pool, jx):
        n = 32
        M = rng(33).standard_normal((n, n)).astype(np.float32)
        A = (M + M.T) / 2
        got, calls = drive(pool, "norm_herm", np.tril(A))
        assert calls > 0
        assert abs(float(got) - np.abs(A).sum(0).max()) < 1e-3
        H = jx.slate.HermitianMatrix.from_array("lower", jx.jnp.asarray(np.tril(A)),
                                                nb=8, grid=jx.g24)
        assert abs(float(got) - float(jx.slate.norm("one", H))) < 1e-4

    def test_unit_diag_triangular_stays_local(self, pool):
        """Unit-diagonal triangles keep the local masked reduction."""
        n = 24
        a = np.tril(rng(34).standard_normal((n, n))).astype(np.float32)
        got, _ = drive(pool, "norm_unit", a)
        ref = np.abs(np.tril(a, -1) + np.eye(n)).max()
        assert abs(float(got) - ref) < 1e-5


class TestRound3GridDispatch:
    @pytest.mark.parametrize("order", ORDERS)
    def test_gels_branches(self, pool, order):
        r = np.random.default_rng(1234)
        for (m, n) in [(128, 48), (256, 32), (48, 128)]:
            a = r.standard_normal((m, n))
            b = (a @ r.standard_normal((n, 4)) if m >= n else r.standard_normal((m, 4)))
            X, calls = drive(pool, "gels", a, b, {"block_size": 16}, order)
            ref = np.linalg.lstsq(a, b, rcond=None)[0]
            assert calls > 0
            assert np.linalg.norm(X - ref) / max(np.linalg.norm(ref), 1e-30) < 1e-11, \
                (m, n)


def both(pool, name, *args, **kw):
    return [pool.call(name, *args, grid=g, **kw) for g in G24.values()]


class TestInverseDist:
    def test_trtri(self, pool, jx):
        r = np.random.default_rng(1234)
        n = 96
        t = np.tril(r.standard_normal((n, n))) + n * np.eye(n)
        jT = np.asarray(jx.jp.trtri_distributed(jx.jnp.asarray(t), jx.g24))
        for Tinv in both(pool, "trtri_distributed", t, GRID):
            assert _rel(Tinv, np.linalg.inv(t)) < 1e-12 and _rel(Tinv, jT) < 1e-12
        u = np.triu(r.standard_normal((n, n))) + n * np.eye(n)
        for Uinv in both(pool, "trtri_distributed", u, GRID, lower=False):
            assert _rel(Uinv, np.linalg.inv(u)) < 1e-12

    def test_potri(self, pool):
        r = np.random.default_rng(1234)
        n = 80
        a = r.standard_normal((n, n))
        spd = a @ a.T + n * np.eye(n)
        L = pool.call("potrf_distributed", spd, GRID, nb=16, grid=G24["col"])
        for Ainv in both(pool, "potri_distributed", L, GRID):
            full = np.tril(Ainv) + np.tril(Ainv, -1).T
            assert _rel(full, np.linalg.inv(spd)) < 1e-11

    def test_trtrm_matches_dense(self, pool, jx):
        n = 64
        t = np.tril(np.random.default_rng(1234).standard_normal((n, n)))
        jr = np.asarray(jx.jp.trtrm_distributed(jx.jnp.asarray(t), jx.g24))
        for got in both(pool, "trtrm_distributed", t, GRID):
            ref = np.tril(t.T @ t)
            assert np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1) < 1e-13
            assert np.linalg.norm(got - jr) / max(np.linalg.norm(ref), 1) < 1e-13

    def test_getri(self, pool):
        n = 96
        g = np.random.default_rng(1234).standard_normal((n, n))
        LU, perm, info = pool.call("getrf_distributed", g, GRID, nb=16, grid=G24["col"])
        for Ginv in both(pool, "getri_distributed", LU, perm, GRID):
            assert _rel(Ginv, np.linalg.inv(g)) < 1e-10
        assert int(info) == 0


class TestLQDist:
    def test_gelqf_reconstruction(self, pool, jx):
        m, n = 60, 180
        a = np.random.default_rng(1234).standard_normal((m, n))
        jL, _ = jx.jp.gelqf_distributed(jx.jnp.asarray(a), jx.g24, nb=16)
        for L, Q in both(pool, "gelqf_distributed", a, GRID, nb=16):
            assert _rel(L @ Q, a) < 1e-13
            assert np.linalg.norm(Q @ Q.T - np.eye(m)) < 1e-12
            assert np.linalg.norm(np.triu(L, 1)) == 0.0
            np.testing.assert_allclose(L, np.asarray(jL), atol=1e-10)

    def test_gels_lq_min_norm(self, pool):
        m, n = 50, 140
        r = np.random.default_rng(1234)
        a = r.standard_normal((m, n))
        B = r.standard_normal((m, 3))
        ref = np.linalg.lstsq(a, B, rcond=None)[0]
        for X in both(pool, "gels_lq_distributed", a, B, GRID, nb=16):
            assert _rel(X, ref) < 1e-12

    def test_potri_unaligned(self, pool):
        n = 90
        g = np.random.default_rng(1234).standard_normal((n, n))
        spd = g @ g.T + n * np.eye(n)
        L = pool.call("potrf_distributed", spd, GRID, nb=16, grid=G24["row"])
        for Ainv in both(pool, "potri_distributed", L, GRID):
            full = np.tril(Ainv) + np.tril(Ainv, -1).T
            assert _rel(full, np.linalg.inv(spd)) < 1e-11


class TestCondestDist:
    def test_gecondest(self, pool, jx):
        n = 96
        a = np.random.default_rng(1234).standard_normal((n, n))
        LU, perm, info = pool.call("getrf_distributed", a, GRID, nb=16, grid=G24["col"])
        anorm = np.linalg.norm(a, 1)
        true_rc = 1.0 / (anorm * np.linalg.norm(np.linalg.inv(a), 1))
        jLU, jperm, _ = jx.jp.getrf_distributed(jx.jnp.asarray(a), jx.g24, nb=16)
        jrc = float(jx.jp.gecondest_distributed(jLU, jperm, anorm, jx.g24))
        for rc in both(pool, "gecondest_distributed", LU, perm, anorm, GRID):
            assert 0.05 * true_rc < float(rc) < 20 * true_rc
            assert abs(float(rc) - jrc) <= 1e-8 * jrc

    def test_pocondest(self, pool):
        n = 80
        a = np.random.default_rng(1234).standard_normal((n, n))
        spd = a @ a.T + n * np.eye(n)
        L = pool.call("potrf_distributed", spd, GRID, nb=16, grid=G24["col"])
        anorm = np.linalg.norm(spd, 1)
        true_rc = 1.0 / (anorm * np.linalg.norm(np.linalg.inv(spd), 1))
        for rc in both(pool, "pocondest_distributed", L, anorm, GRID):
            assert 0.05 * true_rc < float(rc) < 20 * true_rc

    @pytest.mark.parametrize("norm_kind", ["one", "inf"])
    def test_trcondest(self, pool, jx, norm_kind):
        n = 64
        t = np.tril(np.random.default_rng(7).standard_normal((n, n))) + 4 * np.eye(n)
        jrc = float(jx.jp.trcondest_distributed(jx.jnp.asarray(t), jx.g24,
                                                norm_kind=norm_kind))
        for rc in both(pool, "trcondest_distributed", t, GRID, norm_kind=norm_kind):
            assert abs(float(rc) - jrc) <= 1e-8 * jrc


class TestRbtDist:
    def test_getrf_nopiv_distributed_factor(self, pool):
        n = 200
        A = np.random.default_rng(1234).standard_normal((n, n)) + n * np.eye(n)
        for LU, info in both(pool, "getrf_nopiv_distributed", A, GRID, nb=32):
            L = np.tril(LU, -1) + np.eye(n)
            assert int(info) == 0 and _rel(L @ np.triu(LU), A) < 1e-12

    def test_gesv_rbt_distributed_solves(self, pool):
        n = 180
        r = np.random.default_rng(1234)
        A = r.standard_normal((n, n))
        Xt = r.standard_normal((n, 3))
        B = A @ Xt
        for X, info, iters, via_rbt in both(pool, "gesv_rbt_distributed", A, B, GRID,
                                            depth=2, nb=32):
            assert int(info) == 0 and via_rbt
            assert _rel(X, Xt) < 1e-10
        x1, _, _, _ = pool.call("gesv_rbt_distributed", A, B[:, 0], GRID, depth=2,
                                nb=32, grid=G24["col"])
        assert x1.shape == (n,) and np.linalg.norm(x1 - Xt[:, 0]) < 1e-9

    def test_driver_grid_dispatch(self, pool):
        n = 96
        r = np.random.default_rng(1234)
        A = r.standard_normal((n, n))
        Xt = r.standard_normal((n, 2))
        X, calls = drive(pool, "gesv_rbt", A, A @ Xt, {"block_size": 16})
        assert calls > 0 and _rel(X, Xt) < 1e-10

    def test_gesv_rbt_distributed_complex(self, pool):
        n = 96
        r = np.random.default_rng(1234)
        A = r.standard_normal((n, n)) + 1j * r.standard_normal((n, n))
        Xt = r.standard_normal((n, 2)) + 1j * r.standard_normal((n, 2))
        for X, info, iters, via_rbt in both(pool, "gesv_rbt_distributed", A, A @ Xt,
                                            GRID, depth=2, nb=16):
            assert int(info) == 0 and via_rbt
            assert _rel(X, Xt) < 1e-10
