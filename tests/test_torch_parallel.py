"""Parity of the distributed tier (``slate_tpu_torch.parallel``) with the JAX
package's (``slate_tpu.parallel``), mirroring ``tests/test_parallel.py``.

The JAX side runs in this process on its 8-device virtual CPU mesh; the port
side runs on eight gloo ranks (one pool for the module, one intra-op thread
each) at 2×4 and 2×2, in both grid orders.  Inputs come from numpy seeds.
Each test applies the JAX test's own check to both packages' results and
holds the port to the JAX result.  The JAX package is imported lazily (the
``jx`` fixture): the ranks import this module for its jobs, and need torch
only.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from slate_tpu_torch.parallel.launch import GRID, RankPool

G24 = {"col": (2, 4, "col"), "row": (2, 4, "row")}
G22 = {"col": (2, 2, "col"), "row": (2, 2, "row")}
ORDERS = ["col", "row"]


@pytest.fixture(scope="module")
def pool():
    with RankPool(8) as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    import slate_tpu
    from slate_tpu import parallel as jp

    return SimpleNamespace(jax=jax, jnp=jnp, jp=jp, slate=slate_tpu,
                           g24=jp.ProcessGrid(2, 4),
                           g22=jp.ProcessGrid(2, 2, devices=jax.devices()[:4]))


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-300)


def both(pool, name, *args, grids=G24, **kw):
    """The port's result on each grid order."""
    return {o: pool.call(name, *args, grid=g, **kw) for o, g in grids.items()}


# ---------------------------------------------------------------------------
# jobs the ranks run (torch only)


def _grid_facts(spec):
    from slate_tpu_torch.parallel.launch import grid_of

    g = grid_of(spec)
    return {"p": g.p, "q": g.q, "size": g.size, "mesh": tuple(g.mesh.shape),
            "coords": [g.coords(r) for r in range(g.size)],
            "tile_rank": [g.tile_rank(i, j) for i in range(3) for j in range(3)],
            "rank": g.rank, "my": g.my_coords,
            "mesh_at_my": None if g.rank < 0 else int(g.mesh.mesh[g.my_coords])}


def _shards(state, spec):
    """Each rank's (mesh coordinate, local shard) of a wrapper rebuilt from the
    JAX wrapper's state on grid ``spec``."""
    from slate_tpu_torch.core.matrix import from_reference_state
    from slate_tpu_torch.parallel.launch import grid_of

    g = grid_of(spec)
    if g.rank < 0:
        return None
    w = from_reference_state(state, device="cpu", grid=spec)
    local = w.storage.array.to_local().numpy()
    return g.my_coords, local, w.tileIsLocal(0, 0), w.tileRank(0, 0)


def _wrapper_job(kind, a, opts, spec):
    """A driver call on a wrapper bound to grid ``spec`` (host results)."""
    import slate_tpu_torch as st
    from slate_tpu_torch.parallel.launch import grid_of, to_host

    grid = grid_of(spec)
    t = torch.from_numpy(a)
    if kind == "getrf":
        return to_host(st.getrf(st.Matrix.from_array(t, nb=opts["block_size"],
                                                     grid=grid), opts))
    H = st.HermitianMatrix.from_array("lower", t, nb=opts["block_size"], grid=grid)
    return to_host(st.potrf(H, opts))


def _redistribute_job(a, spec):
    from slate_tpu_torch.parallel import distribute, redistribute
    from slate_tpu_torch.parallel.launch import grid_of, to_host

    grid = grid_of(spec)
    r = redistribute(distribute(torch.from_numpy(a), grid), grid.replicated())
    return to_host(r.to_local())


def _potrf_gathered(A, grid, nb):
    """The replicated design the bound guards against: gather the whole
    distributed matrix, then factor."""
    from slate_tpu_torch.parallel import distribute, gather, potrf_distributed

    return potrf_distributed(gather(distribute(A, grid)), grid, nb=nb)


def _potrf_wrapper(A, grid, nb):
    """potrf through the public API, on a HermitianMatrix bound to the grid."""
    import slate_tpu_torch as st

    H = st.HermitianMatrix.from_array("lower", A, nb=nb, grid=grid)
    return st.potrf(H, {"block_size": nb})


def _gemm_wrapper(A, B, grid, nb):
    """gemm through the public API, on Matrix wrappers bound to the grid."""
    import slate_tpu_torch as st

    C = st.Matrix.from_array(torch.zeros_like(A), nb=nb, grid=grid)
    return st.gemm(1.0, st.Matrix.from_array(A, nb=nb, grid=grid),
                   st.Matrix.from_array(B, nb=nb, grid=grid), 0.0, C)


def _received(name, args, kwargs, spec):
    """Bytes this rank receives through the collectives while ``name`` runs:
    the collectives module's primitives are wrapped here, for this call.
    An all-reduce delivers its tensor, an all-gather the other members'
    pieces, a point-to-point exchange what it receives; a group of one
    delivers nothing."""
    from slate_tpu_torch.parallel import collectives as C
    from slate_tpu_torch.parallel.launch import _resolve, grid_of, to_device

    grid = grid_of(spec)
    got = [0]
    saved = (C._all_reduce, C._all_gather, C._send_recv, C._exchange)

    def all_reduce(t, group, op):
        if dist.get_world_size(group) > 1:
            got[0] += t.numel() * t.element_size()
        return saved[0](t, group, op)

    def all_gather(t, group):
        got[0] += (dist.get_world_size(group) - 1) * t.numel() * t.element_size()
        return saved[1](t, group)

    def send_recv(send, dst, recv, src, group):
        got[0] += recv.numel() * recv.element_size()
        return saved[2](send, dst, recv, src, group)

    def exchange(sends, recvs):
        got[0] += sum(t.numel() * t.element_size() for t, _ in recvs)
        return saved[3](sends, recvs)

    args = [grid if isinstance(a, str) and a == GRID else to_device(a) for a in args]
    C._all_reduce, C._all_gather, C._send_recv, C._exchange = (
        all_reduce, all_gather, send_recv, exchange)
    try:
        (name if callable(name) else _resolve(name))(*args, **kwargs)
    finally:
        C._all_reduce, C._all_gather, C._send_recv, C._exchange = saved
    return got[0]


# ---------------------------------------------------------------------------


class TestGrid:
    @pytest.mark.parametrize("order", ORDERS)
    def test_shape_and_devices(self, pool, jx, order):
        facts = pool.run(_grid_facts, G24[order])
        g = jx.jp.ProcessGrid(2, 4, order=order)
        for r, f in enumerate(facts):
            assert (f["p"], f["q"], f["size"], f["mesh"]) == (2, 4, 8, (2, 4))
            assert f["mesh"] == g.mesh.devices.shape
            # the mesh puts world rank r at its grid coordinate
            assert f["rank"] == r and f["mesh_at_my"] == r
            assert tuple(f["my"]) == g.coords(r)

    @pytest.mark.parametrize("order", ORDERS)
    def test_coords_col_order(self, pool, jx, order):
        f = pool.run(_grid_facts, G24[order])[0]
        g = jx.jp.ProcessGrid(2, 4, order=order)
        assert [tuple(c) for c in f["coords"]] == [g.coords(r) for r in range(8)]
        if order == "col":   # rank = i + j*p (func.hh:178-186)
            assert f["coords"][:3] == [(0, 0), (1, 0), (0, 1)]

    @pytest.mark.parametrize("order", ORDERS)
    def test_tile_rank_matches_grid(self, pool, jx, order):
        f = pool.run(_grid_facts, G24[order])[0]
        g = jx.jp.ProcessGrid(2, 4, order=order)
        assert f["tile_rank"] == [g.tile_rank(i, j) for i in range(3) for j in range(3)]
        facts22 = pool.run(_grid_facts, G22[order])
        assert [f2["rank"] for f2 in facts22] == [0, 1, 2, 3, -1, -1, -1, -1]


class TestDistribute:
    @pytest.mark.parametrize("order", ORDERS)
    def test_block_sharding_placement(self, pool, jx, rng, order):
        """Each rank's shard of a grid-bound wrapper equals, bit for bit, the
        JAX array's shard at the same mesh coordinate (from_reference_state
        carrying a JAX wrapper across)."""
        a = rng.standard_normal((16, 24))
        g = jx.jp.ProcessGrid(2, 4, order=order)
        W = jx.slate.Matrix.from_array(jx.jnp.asarray(a), nb=4, grid=g)
        arr = W.storage.array
        want = {}
        for sh in arr.addressable_shards:
            (i, j), = np.argwhere(g.mesh.devices == sh.device)
            want[(int(i), int(j))] = np.asarray(sh.data)
        state = {"class": "Matrix", "array": np.asarray(arr), "nb": 4,
                 "gridinfo": W.gridinfo()}
        got = pool.run(_shards, state, G24[order])
        assert len(want) == 8
        for r, (coords, local, is_local, owner) in enumerate(got):
            np.testing.assert_array_equal(local, want[tuple(coords)])
            assert is_local == (owner == r)

    def test_cyclic_roundtrip(self, pool, jx, rng):
        a = rng.standard_normal((16, 32))
        c = pool.call("cyclic_to_blocked", a, GRID, nb=4, grid=G24["col"])
        back = pool.call("blocked_to_cyclic", c, GRID, nb=4, grid=G24["col"])
        np.testing.assert_array_equal(back, a)
        jc = np.asarray(jx.jp.cyclic_to_blocked(jx.jnp.asarray(a), jx.g24, nb=4))
        np.testing.assert_array_equal(c, jc)

    def test_cyclic_groups_tiles(self, pool, jx):
        a = np.arange(16.0)[:, None] * np.ones((1, 8))
        c = pool.call("cyclic_to_blocked", a, GRID, nb=4, grid=G24["col"])
        assert list(c[:8, 0].astype(int)) == [0, 1, 2, 3, 8, 9, 10, 11]

    @pytest.mark.parametrize("order", ORDERS)
    def test_redistribute(self, pool, rng, order):
        a = rng.standard_normal((16, 16))
        r = pool.run(_redistribute_job, a, G24[order])[0]
        np.testing.assert_array_equal(r, a)


class TestSumma:
    def test_allgather_matches_matmul(self, pool, jx, rng):
        a = rng.standard_normal((16, 24))
        b = rng.standard_normal((24, 32))
        jc = np.asarray(jx.jp.gemm_allgather(jx.jnp.asarray(a), jx.jnp.asarray(b), jx.g24))
        for c in both(pool, "gemm_allgather", a, b, GRID).values():
            np.testing.assert_allclose(c, a @ b, rtol=1e-12)
            np.testing.assert_allclose(c, jc, rtol=1e-12)

    def test_ring_matches_matmul(self, pool, jx, rng):
        a = rng.standard_normal((8, 12))
        b = rng.standard_normal((12, 16))
        jc = np.asarray(jx.jp.gemm_ring(jx.jnp.asarray(a), jx.jnp.asarray(b), jx.g22))
        for c in both(pool, "gemm_ring", a, b, GRID, grids=G22).values():
            np.testing.assert_allclose(c, a @ b, rtol=1e-12)
            np.testing.assert_allclose(c, jc, rtol=1e-12)

    def test_dispatch_auto(self, pool, jx, rng):
        a = rng.standard_normal((8, 16))
        b = rng.standard_normal((16, 8))
        for c in both(pool, "gemm_distributed", a, b, GRID, grids=G22).values():
            np.testing.assert_allclose(c, a @ b, rtol=1e-12)

    def test_complex(self, pool, jx, rng):
        a = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
        b = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
        for name in ("gemm_allgather", "gemm_ring"):
            jc = np.asarray(getattr(jx.jp, name)(jx.jnp.asarray(a), jx.jnp.asarray(b),
                                                 jx.g22))
            for c in both(pool, name, a, b, GRID, grids=G22).values():
                np.testing.assert_allclose(c, a @ b, rtol=1e-12)
                np.testing.assert_allclose(c, jc, rtol=1e-12)


class TestDistributedSolvers:
    def test_potrf_residual(self, pool, jx, rng):
        n = 64
        A = _spd(rng, n)
        jL = np.asarray(jx.jp.potrf_distributed(jx.jnp.asarray(A), jx.g24, nb=16))
        for L in both(pool, "potrf_distributed", A, GRID, nb=16).values():
            assert _rel(L @ L.T, A) < 1e-12
            np.testing.assert_allclose(L, jL, atol=1e-12)

    def test_potrf_loop_method_large_panel_count(self, pool, jx, rng):
        n = 144
        A = _spd(rng, n)
        L_ref = np.linalg.cholesky(A)
        L_auto = pool.call("potrf_distributed", A, GRID, nb=4, grid=G24["row"])
        assert np.abs(L_auto - L_ref).max() < 1e-8
        L_loop = pool.call("potrf_distributed", A, GRID, nb=16, method="loop",
                           grid=G24["col"])
        assert np.abs(L_loop - L_ref).max() < 1e-8
        jl = np.asarray(jx.jp.potrf_distributed(jx.jnp.asarray(A), jx.g24, nb=16,
                                                method="loop"))
        assert np.abs(L_loop - jl).max() < 1e-10

    def test_posv_solves(self, pool, jx, rng):
        n, nrhs = 32, 8
        A = _spd(rng, n)
        X_true = rng.standard_normal((n, nrhs))
        B = A @ X_true
        jX = np.asarray(jx.jp.posv_distributed(jx.jnp.asarray(A), jx.jnp.asarray(B),
                                               jx.g24, nb=8))
        for X in both(pool, "posv_distributed", A, B, GRID, nb=8).values():
            np.testing.assert_allclose(X, X_true, rtol=1e-8)
            np.testing.assert_allclose(X, jX, rtol=1e-10)

    def test_posv_ragged_shapes(self, pool, jx, rng):
        n, nrhs = 23, 3
        A = _spd(rng, n)
        X_true = rng.standard_normal((n, nrhs))
        B = A @ X_true
        for X in both(pool, "posv_distributed", A, B, GRID, nb=8).values():
            assert X.shape == (n, nrhs)
            np.testing.assert_allclose(X, X_true, rtol=1e-8)

    @pytest.mark.parametrize("conj_trans", [False, True])
    def test_trsm(self, pool, jx, rng, conj_trans):
        n = 32
        L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
        B = rng.standard_normal((n, 16))
        jX = np.asarray(jx.jp.trsm_distributed(jx.jnp.asarray(L), jx.jnp.asarray(B),
                                               jx.g24, conj_trans=conj_trans))
        op = L.T if conj_trans else L
        for X in both(pool, "trsm_distributed", L, B, GRID,
                      conj_trans=conj_trans).values():
            np.testing.assert_allclose(op @ X, B, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(X, jX, rtol=1e-10, atol=1e-14)

    @pytest.mark.parametrize("lower,conj_trans", [(True, False), (True, True),
                                                  (False, False), (False, True)])
    def test_trsmA(self, pool, jx, rng, lower, conj_trans):
        """Stationary-A sweeps (every row of the sweep table)."""
        n = 40
        T = rng.standard_normal((n, n)) + n * np.eye(n)
        T = np.tril(T) if lower else np.triu(T)
        B = rng.standard_normal((n, 3))
        jX = np.asarray(jx.jp.trsmA_distributed(jx.jnp.asarray(T), jx.jnp.asarray(B),
                                                jx.g24, lower=lower,
                                                conj_trans=conj_trans))
        op = T.T if conj_trans else T
        for X in both(pool, "trsmA_distributed", T, B, GRID, lower=lower,
                      conj_trans=conj_trans).values():
            np.testing.assert_allclose(op @ X, B, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(X, jX, rtol=1e-10, atol=1e-14)


class TestCholQR:
    def test_qr_tall(self, pool, jx, rng):
        m, n = 128, 16
        A = rng.standard_normal((m, n))
        jQ, jR = jx.jp.cholqr_distributed(jx.jnp.asarray(A), jx.g24)
        for Q, R in both(pool, "cholqr_distributed", A, GRID).values():
            np.testing.assert_allclose(Q @ R, A, rtol=1e-10)
            np.testing.assert_allclose(Q.T @ Q, np.eye(n), atol=1e-10)
            assert np.allclose(np.tril(R, -1), 0)
            np.testing.assert_allclose(R, np.asarray(jR), atol=1e-10)
            np.testing.assert_allclose(Q, np.asarray(jQ), atol=1e-10)

    def test_qr_ragged_rows(self, pool, jx, rng):
        m, n = 61, 7
        A = rng.standard_normal((m, n))
        for Q, R in both(pool, "cholqr_distributed", A, GRID).values():
            assert Q.shape == (m, n)
            np.testing.assert_allclose(Q @ R, A, rtol=1e-9)

    def test_gels(self, pool, jx, rng):
        m, n, nrhs = 64, 8, 4
        A = rng.standard_normal((m, n))
        X_true = rng.standard_normal((n, nrhs))
        B = A @ X_true
        for X in both(pool, "gels_cholqr_distributed", A, B, GRID).values():
            np.testing.assert_allclose(X, X_true, rtol=1e-8)


def _lu_residual(A, LU, perm):
    m, n = A.shape
    k = min(m, n)
    L = np.tril(LU, -1)[:, :k] + np.eye(m, k)
    U = np.triu(LU[:k])
    return np.linalg.norm(A[perm] - L @ U) / np.linalg.norm(A), L


class TestDistributedLU:
    def test_getrf_residual(self, pool, jx, rng):
        n, nb = 96, 8
        A = rng.standard_normal((n, n))
        _, jperm, jinfo = jx.jp.getrf_distributed(jx.jnp.asarray(A), jx.g24, nb=nb)
        for LU, perm, info in both(pool, "getrf_distributed", A, GRID, nb=nb).values():
            res, L = _lu_residual(A, LU, perm)
            assert res < 1e-13
            assert int(info) == int(jinfo) == 0
            assert np.abs(L).max() < 4.0
            assert perm.tolist() == np.asarray(jperm).tolist()

    def test_getrf_ragged_unaligned(self, pool, jx, rng):
        n, nb = 100, 16
        A = rng.standard_normal((n, n))
        _, jperm, _ = jx.jp.getrf_distributed(jx.jnp.asarray(A), jx.g24, nb=nb)
        for LU, perm, info in both(pool, "getrf_distributed", A, GRID, nb=nb).values():
            assert _lu_residual(A, LU, perm)[0] < 1e-13
            assert sorted(perm.tolist()) == list(range(n))
            assert perm.tolist() == np.asarray(jperm).tolist()

    def test_gesv_solves(self, pool, jx, rng):
        n, nrhs = 64, 5
        A = rng.standard_normal((n, n))
        B = rng.standard_normal((n, nrhs))
        jX, jinfo = jx.jp.gesv_distributed(jx.jnp.asarray(A), jx.jnp.asarray(B),
                                           jx.g24, nb=8)
        for X, info in both(pool, "gesv_distributed", A, B, GRID, nb=8).values():
            assert _rel(A @ X, B) < 1e-10
            assert int(info) == int(jinfo) == 0
            np.testing.assert_allclose(X, np.asarray(jX), rtol=1e-9, atol=1e-12)

    def test_gesv_square_grid(self, pool, jx, rng):
        n = 64
        A = rng.standard_normal((n, n))
        B = rng.standard_normal((n, 3))
        for X, info in both(pool, "gesv_distributed", A, B, GRID, nb=16,
                            grids=G22).values():
            assert _rel(A @ X, B) < 1e-10

    def test_matches_single_device(self, pool, jx, rng):
        """Distributed solve == the single-device port's gesv (same matrix)."""
        import slate_tpu_torch as st

        n = 48
        A = rng.standard_normal((n, n))
        B = rng.standard_normal((n, 2))
        Xs = st.gesv(torch.tensor(A), torch.tensor(B))[0].numpy()
        for Xd, _ in both(pool, "gesv_distributed", A, B, GRID, nb=8).values():
            assert _rel(Xd, Xs) < 1e-9

    def test_singular_info(self, pool, jx):
        n = 32
        A = np.eye(n)
        A[5, 5] = 0.0
        _, _, jinfo = jx.jp.getrf_distributed(jx.jnp.asarray(A), jx.g24, nb=8)
        for _, _, info in both(pool, "getrf_distributed", A, GRID, nb=8).values():
            assert int(info) != 0 and int(info) == int(jinfo)

    def test_pp_panel_residual_and_growth(self, pool, jx, rng):
        n, nb = 96, 8
        A = rng.standard_normal((n, n))
        for LU, perm, info in both(pool, "getrf_distributed", A, GRID, nb=nb,
                                   lu_panel="pp").values():
            res, L = _lu_residual(A, LU, perm)
            assert res < 1e-13 and int(info) == 0
            assert np.abs(L).max() <= 1.0 + 1e-12
            assert sorted(perm.tolist()) == list(range(n))

    def test_pp_panel_matches_lapack_pivoting(self, pool, jx, rng):
        n, nb = 64, 8
        A = rng.standard_normal((n, n))
        _, _, perm_ref = jx.jax.lax.linalg.lu(jx.jnp.asarray(A))
        for _, perm, _ in both(pool, "getrf_distributed", A, GRID, nb=nb,
                               lu_panel="pp").values():
            assert perm.tolist() == np.asarray(perm_ref).tolist()

    def test_pp_panel_tall_tslu(self, pool, jx, rng):
        m, n, nb = 256, 64, 16
        A = rng.standard_normal((m, n))
        _, jperm, _ = jx.jp.getrf_tall_distributed(jx.jnp.asarray(A), jx.g24, nb=nb,
                                                   lu_panel="pp")
        for LU, perm, info in both(pool, "getrf_tall_distributed", A, GRID, nb=nb,
                                   lu_panel="pp").values():
            assert _lu_residual(A, LU, perm)[0] < 1e-13 and int(info) == 0
            assert perm.tolist() == np.asarray(jperm).tolist()

    def test_pp_vs_tournament_pivot_paths_differ(self, pool, jx, rng):
        n, nb = 96, 8
        A = rng.standard_normal((n, n))
        _, perm_t, _ = pool.call("getrf_distributed", A, GRID, nb=nb,
                                 lu_panel="tournament", grid=G24["col"])
        _, perm_p, _ = pool.call("getrf_distributed", A, GRID, nb=nb, lu_panel="pp",
                                 grid=G24["col"])
        assert perm_t.tolist() != perm_p.tolist()

    def test_lu_panel_reaches_mesh_from_options(self, pool, jx, rng):
        """Options(lu_panel="pp") on a grid-bound wrapper reaches the grid's
        panel: the wrapper's perm equals the direct distributed call's."""
        n, nb = 64, 8
        A = rng.standard_normal((n, n))
        got = pool.run(_wrapper_job, "getrf", A, {"lu_panel": "pp", "block_size": nb},
                       G24["col"])[0]
        _, perm_d, _ = pool.call("getrf_distributed", A, GRID, nb=nb, lu_panel="pp",
                                 grid=G24["col"])
        _, perm_w, info = got
        assert int(info) == 0
        assert perm_w.tolist() == perm_d.tolist()

    def test_getrf_tall_tslu(self, pool, jx, rng):
        for (m, n, nb) in [(256, 64, 16), (300, 70, 16), (130, 40, 16)]:
            A = rng.standard_normal((m, n))
            _, jperm, _ = jx.jp.getrf_tall_distributed(jx.jnp.asarray(A), jx.g24, nb=nb)
            for LU, perm, info in both(pool, "getrf_tall_distributed", A, GRID,
                                       nb=nb).values():
                assert _lu_residual(A, LU, perm)[0] < 1e-12, (m, n, nb)
                assert sorted(perm.tolist()) == list(range(m))
                assert int(info) == 0
                assert perm.tolist() == np.asarray(jperm).tolist()

    def test_getrf_dispatch_tall_routes_tslu(self, pool, jx, rng):
        m, n = 384, 96
        A = rng.standard_normal((m, n))
        LU, perm, info = pool.call("getrf_distributed", A, GRID, nb=32, grid=G24["row"])
        assert _lu_residual(A, LU, perm)[0] < 1e-12 and int(info) == 0


class TestDistributedQR:
    def test_tsqr_residual_orthogonality(self, pool, jx, rng):
        m, n = 200, 7
        A = rng.standard_normal((m, n))
        _, jR = jx.jp.tsqr_distributed(jx.jnp.asarray(A), jx.g24)
        for Q, R in both(pool, "tsqr_distributed", A, GRID).values():
            assert _rel(Q @ R, A) < 1e-14
            assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-13
            assert np.linalg.norm(np.tril(R, -1)) == 0.0
            np.testing.assert_allclose(np.abs(R), np.abs(np.asarray(jR)), atol=1e-12)

    def test_tsqr_ill_conditioned(self, pool, jx, rng):
        m, n = 160, 6
        U, _ = np.linalg.qr(rng.standard_normal((m, n)))
        V, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = U @ np.diag([1.0, 1e-3, 1e-5, 1e-8, 1e-10, 1e-12]) @ V.T
        for Q, R in both(pool, "tsqr_distributed", A, GRID).values():
            assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-12

    def test_gels_qr(self, pool, jx, rng):
        A = rng.standard_normal((120, 9))
        B = rng.standard_normal((120, 3))
        Xref = np.linalg.lstsq(A, B, rcond=None)[0]
        jX = np.asarray(jx.jp.gels_qr_distributed(jx.jnp.asarray(A), jx.jnp.asarray(B),
                                                  jx.g24))
        for X in both(pool, "gels_qr_distributed", A, B, GRID).values():
            assert _rel(X, Xref) < 1e-12 and _rel(X, jX) < 1e-12

    def test_geqrf_2d(self, pool, jx, rng):
        m, n, nb = 96, 64, 8
        A = rng.standard_normal((m, n))
        jQ, jR = jx.jp.geqrf_distributed(jx.jnp.asarray(A), jx.g24, nb=nb)
        for Q, R in both(pool, "geqrf_distributed", A, GRID, nb=nb).values():
            assert _rel(Q @ R, A) < 1e-13
            assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-12
            assert np.linalg.norm(np.tril(R, -1)) < 1e-14
            np.testing.assert_allclose(R, np.asarray(jR), atol=1e-10)
            np.testing.assert_allclose(Q, np.asarray(jQ), atol=1e-10)

    def test_geqrf_ragged_square(self, pool, jx, rng):
        m, n, nb = 100, 100, 16
        A = rng.standard_normal((m, n))
        for Q, R in both(pool, "geqrf_distributed", A, GRID, nb=nb, grids=G22).values():
            assert _rel(Q @ R, A) < 1e-13
            assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 1e-12

    def test_gels_caqr(self, pool, jx, rng):
        A = rng.standard_normal((96, 48))
        B = rng.standard_normal((96, 4))
        Xref = np.linalg.lstsq(A, B, rcond=None)[0]
        for X in both(pool, "gels_caqr_distributed", A, B, GRID, nb=8).values():
            assert _rel(X, Xref) < 1e-11


class TestPipelinedPotrf:
    def test_matches_reference(self, pool, jx):
        r = np.random.default_rng(0)
        for n, nb in [(128, 8), (100, 8)]:
            M = r.standard_normal((n, n)).astype(np.float32)
            A = M @ M.T + n * np.eye(n, dtype=np.float32)
            jL = np.asarray(jx.jp.potrf_pipelined(jx.jnp.asarray(A), jx.g24, nb=nb))
            for L in both(pool, "potrf_pipelined", A, GRID, nb=nb).values():
                assert np.abs(L @ L.T - A).max() / np.abs(A).max() < 1e-5
                assert np.abs(np.triu(L, 1)).max() == 0.0
                assert np.abs(L - jL).max() < 1e-4

    def test_single_block_per_device(self, pool, jx):
        r = np.random.default_rng(1)
        n, nb = 64, 8
        M = r.standard_normal((n, n)).astype(np.float32)
        A = M @ M.T + n * np.eye(n, dtype=np.float32)
        for L in both(pool, "potrf_pipelined", A, GRID, nb=nb).values():
            assert np.abs(L @ L.T - A).max() / np.abs(A).max() < 1e-5


class TestTallDistributedLU:
    def test_tall_factorization(self, pool, jx):
        r = np.random.default_rng(0)
        for m, n in [(96, 64), (100, 30)]:
            a = r.standard_normal((m, n)).astype(np.float32)
            for LU, perm, info in both(pool, "getrf_distributed", a, GRID,
                                       nb=16).values():
                assert int(info) == 0
                assert sorted(perm.tolist()) == list(range(m))
                L = np.tril(LU, -1)[:, :n] + np.eye(m, n, dtype=np.float32)
                assert np.abs(a[perm] - L @ np.triu(LU[:n, :n])).max() < 1e-4

    def test_wide_factorization(self, pool, jx):
        r = np.random.default_rng(2)
        for m, n in [(64, 96), (30, 100)]:
            a = r.standard_normal((m, n)).astype(np.float32)
            _, jperm, _ = jx.jp.getrf_distributed(jx.jnp.asarray(a), jx.g24, nb=16)
            for LU, perm, info in both(pool, "getrf_distributed", a, GRID,
                                       nb=16).values():
                assert int(info) == 0
                assert sorted(perm.tolist()) == list(range(m))
                L = np.tril(LU[:, :m], -1) + np.eye(m, dtype=np.float32)
                assert np.abs(a[perm] - L @ np.triu(LU)).max() < 1e-4
                assert perm.tolist() == np.asarray(jperm).tolist()

    def test_tall_wrapper_routes(self, pool, jx):
        r = np.random.default_rng(1)
        m, n = 80, 48
        a = r.standard_normal((m, n)).astype(np.float32)
        LU, perm, info = pool.run(_wrapper_job, "getrf", a, {"block_size": 16},
                                  G24["col"])[0]
        assert int(info) == 0
        L = np.tril(LU, -1)[:, :n] + np.eye(m, n, dtype=np.float32)
        assert np.abs(a[perm] - L @ np.triu(LU[:n, :n])).max() < 1e-4


class TestDistributedMixedAndGeneralized:
    def test_mixed_precision_distributed(self, pool, jx):
        r = np.random.default_rng(9)
        n, nrhs = 64, 4
        m = r.standard_normal((n, n))
        Af = m @ m.T + n * np.eye(n)
        B = r.standard_normal((n, nrhs))
        _, jit, jok = jx.jp.posv_mixed_distributed(jx.jnp.asarray(Af), jx.jnp.asarray(B),
                                                   jx.g24, nb=16)
        for X, iters, ok in both(pool, "posv_mixed_distributed", Af, B, GRID,
                                 nb=16).values():
            assert ok and _rel(Af @ X, B) < 1e-12
            assert ok == jok and abs(iters - jit) <= 1
        G = r.standard_normal((n, n))
        for X2, perm, info, it2, ok2 in both(pool, "gesv_mixed_distributed", G, B, GRID,
                                             nb=16).values():
            assert ok2 and int(info) == 0
            assert sorted(perm.tolist()) == list(range(n))
            assert _rel(G @ X2, B) < 1e-12

    def test_gmres_ir_distributed(self, pool, jx):
        r = np.random.default_rng(12)
        n = 64
        a = r.standard_normal((n, n)) + n * np.eye(n)
        b = r.standard_normal(n)
        for X, perm, info, restarts, ok in both(pool, "gesv_mixed_gmres_distributed",
                                                a, b, GRID, nb=16).values():
            assert ok and int(info) == 0
            assert _rel(a @ np.ravel(X), b) < 1e-12
        m = r.standard_normal((n, n))
        spd = m @ m.T + n * np.eye(n)
        for Xp, rst, okp in both(pool, "posv_mixed_gmres_distributed", spd, b, GRID,
                                 nb=16).values():
            assert okp and _rel(spd @ np.ravel(Xp), b) < 1e-12


class TestDistributedAtScale:
    def test_getrf_distributed_n2048(self, pool, jx, rng):
        n, nb = 2048, 256
        A = rng.standard_normal((n, n)).astype(np.float32)
        LU, perm, info = pool.call("getrf_distributed", A, GRID, nb=nb, grid=G24["col"])
        L = np.tril(LU, -1) + np.eye(n, dtype=np.float32)
        res = np.linalg.norm(A[perm] - L @ np.triu(LU)) / np.linalg.norm(A)
        assert res < 1e-4 and int(info) == 0
        assert sorted(perm.tolist()) == list(range(n))


class TestBatched:
    """The batch axis sharded over the flattened grid (parallel/batched.py):
    per-request solutions, perm and info as the JAX package's."""

    def test_gesv_batched(self, pool, jx, rng):
        a = rng.standard_normal((16, 12, 12))
        a[5] = 0.0                                   # a singular request
        b = rng.standard_normal((16, 12, 2))
        jX, jperm, jinfo = jx.jp.gesv_batched_distributed(
            jx.jnp.asarray(a), jx.jnp.asarray(b), jx.g24)
        for x, perm, info in both(pool, "gesv_batched_distributed", a, b,
                                  GRID).values():
            assert info.tolist() == np.asarray(jinfo).tolist()
            assert info[5] > 0 and (np.delete(info, 5) == 0).all()
            for i in set(range(16)) - {5}:
                assert _rel(a[i] @ x[i], b[i]) < 1e-12
                np.testing.assert_allclose(x[i], np.asarray(jX)[i], rtol=1e-10,
                                           atol=1e-12)
                assert perm[i].tolist() == np.asarray(jperm)[i].tolist()

    def test_posv_batched(self, pool, jx, rng):
        a = np.stack([_spd(rng, 10) for _ in range(8)])
        b = rng.standard_normal((8, 10, 3))
        jX, jinfo = jx.jp.posv_batched_distributed(jx.jnp.asarray(a),
                                                   jx.jnp.asarray(b), jx.g24)
        for x, info in both(pool, "posv_batched_distributed", a, b, GRID).values():
            assert info.tolist() == np.asarray(jinfo).tolist() == [0] * 8
            np.testing.assert_allclose(x, np.asarray(jX), rtol=1e-10, atol=1e-12)

    def test_batch_must_divide_the_grid(self, pool, jx, rng):
        a = rng.standard_normal((10, 4, 4))
        b = rng.standard_normal((10, 4, 1))
        with pytest.raises(Exception, match="must divide"):
            jx.jp.gesv_batched_distributed(jx.jnp.asarray(a), jx.jnp.asarray(b),
                                           jx.g24)
        with pytest.raises(RuntimeError, match="must divide"):
            pool.call("gesv_batched_distributed", a, b, GRID, grid=G24["col"])


class TestLookaheadRouting:
    def test_driver_lookahead_routes_pipeline(self, pool, jx, rng):
        """Option::Lookahead >= 2 through the public potrf driver takes the
        software pipeline — the same factor."""
        n = 64
        g = rng.standard_normal((n, n))
        spd = g @ g.T + n * np.eye(n)
        L, info = pool.run(_wrapper_job, "potrf", spd,
                           {"block_size": 16, "lookahead": 2}, G24["col"])[0]
        L = np.tril(L)
        assert _rel(L @ L.T, spd) < 1e-13 and int(info) == 0


class TestDistributedNotReplicated:
    """Bytes each rank receives through the collectives, counted on the test's
    side (``_received`` wraps the primitives), at 2×4 with n = 16·nb, f64.
    The bounds (in elements of 8 bytes) follow each algorithm, per rank (i, j)
    with mr = n/p rows and mc = n/q columns:

    * gemm_allgather: A's row block gathered along q, B's column block along p:
      mr·k·(q-1)/q + k·mc·(p-1)/p <= n²/p + n²/q.
    * potrf: per panel of width nb, my rows of the panel along q (<= mr·nb),
      the nb×nb diagonal block along p, the panel rows of my columns along p
      (<= mc·nb): <= n²/p + n²/q + n·nb.
    * gesv: getrf moves per panel two panel copies along q (2·mr·nb), the
      tournament's candidates along p ((p-1)(nb² + nb)), the 2nb dirty rows
      and the U row band along p (3·nb·mc) and the diagonal block (nb²), then
      2n for the info; getrs's two sweeps move the column panels of my rows
      (mr·n for the pair), the w×w diagonal blocks over the grid (4·n·w, w the
      trsm block) and B's block rows along p, plus one block of slack per
      sweep: 3n²/p + 3n²/q + n·(p·nb + 2·nb + 4·w + 6) + 2·mr·w.

    The same calls through the public API, on wrappers bound to the grid,
    are held to the same bounds.  gemm moves what gemm_allgather does.  potrf
    first assembles the full Hermitian matrix from the stored triangle: each
    rank receives its block of the mirrored strict triangle (at most
    n²/(pq)), and ``info`` sums the diagonal (n).  potrf's own traffic is
    about n²·(1/2p + 1/2q), half the bound's main term, and n²/(pq) is at
    most that half, so the sum stays under the bound.

    A whole-matrix gather adds 7/8·n² per rank at 2×4, more than any bound's
    slack, so it fails them (checked directly for potrf, and by margin for
    each wrapper call)."""

    n, nb = 256, 16

    def _max_received(self, pool, name, *args, **kw):
        got = pool.run(_received, name, args, kw, G24["col"])
        return max(got) / 8

    def test_gemm_allgather(self, pool, rng):
        n, p, q = self.n, 2, 4
        a, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
        assert self._max_received(pool, "gemm_allgather", a, b, GRID) <= n * n / p + n * n / q

    def test_potrf(self, pool, rng):
        n, nb, p, q = self.n, self.nb, 2, 4
        got = self._max_received(pool, "potrf_distributed", _spd(rng, n), GRID, nb=nb)
        assert got <= n * n / p + n * n / q + n * nb

    def test_gesv(self, pool, rng):
        from slate_tpu_torch.parallel.solvers import _trsm_block

        n, nb, p, q = self.n, self.nb, 2, 4
        w = _trsm_block(n, SimpleNamespace(p=p, q=q))
        bound = (3 * n * n / p + 3 * n * n / q + n * (p * nb + 2 * nb + 4 * w + 6)
                 + 2 * (n // p) * w)
        a, b = rng.standard_normal((n, n)), rng.standard_normal((n, 2))
        got = self._max_received(pool, "gesv_distributed", a, b, GRID, nb=nb)
        assert got <= bound
        # the guard works: one whole-matrix gather more would break the bound
        assert got + 7 / 8 * n * n > bound

    def test_potrf_wrapper(self, pool, rng):
        n, nb, p, q = self.n, self.nb, 2, 4
        bound = n * n / p + n * n / q + n * nb
        got = self._max_received(pool, _potrf_wrapper, _spd(rng, n), GRID, nb)
        assert got <= bound
        assert got + 7 / 8 * n * n > bound

    def test_gemm_wrapper(self, pool, rng):
        n, nb, p, q = self.n, self.nb, 2, 4
        a, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
        bound = n * n / p + n * n / q
        got = self._max_received(pool, _gemm_wrapper, a, b, GRID, nb)
        assert got <= bound
        assert got + 7 / 8 * n * n > bound

    def test_whole_gather_fails_the_bound(self, pool, rng):
        n, nb, p, q = self.n, self.nb, 2, 4
        got = self._max_received(pool, _potrf_gathered, _spd(rng, n), GRID, nb=nb)
        assert got > n * n / p + n * n / q + n * nb


@pytest.fixture
def one_rank_world():
    """The tests below start a world of one in this process; it ends with them."""
    from slate_tpu_torch.parallel import mesh as pmesh

    started = not dist.is_initialized()
    yield
    if started:
        pmesh.destroy()


def test_one_rank_grid_without_launcher(rng, one_rank_world):
    """ProcessGrid(1, 1) on the CPU starts a world of one in this process, with
    no launcher, and its drivers agree with the single-device port."""
    import slate_tpu_torch as st
    from slate_tpu_torch.parallel import (ProcessGrid, gather, gesv_distributed,
                                          norm_distributed, posv_distributed)

    with pytest.raises(st.SlateError, match="CUDA"):
        ProcessGrid(1, 1)                    # cuda unless the caller asks for the CPU
    g = ProcessGrid(1, 1, device="cpu")
    assert g.size == 1 and g.rank == 0 and dist.get_world_size() == 1
    n = 48
    A = torch.tensor(_spd(rng, n))
    B = torch.tensor(rng.standard_normal((n, 3)))
    X = gather(posv_distributed(A, B, g, nb=16))
    Xs, info = st.posv(A, B)
    assert _rel(X.numpy(), Xs.numpy()) < 1e-12 and int(info) == 0
    G = torch.tensor(rng.standard_normal((n, n)))
    Xg, info = gesv_distributed(G, B, g, nb=16)
    assert _rel(gather(Xg).numpy(), st.gesv(G, B)[0].numpy()) < 1e-10
    assert abs(float(norm_distributed("fro", G, g)) - float(torch.linalg.norm(G))) \
        < 1e-12 * float(torch.linalg.norm(G))
    with pytest.raises(st.SlateError, match="p\\*q <= 1"):
        ProcessGrid(2, 1, device="cpu")


# chip_smoke.py's phase 12 (the distributed tier on a 1x1 grid) at a small size
SMALL_DIST = {"n": 96, "nb": 32, "nrhs": 3, "gesv_nb": 16, "ls_m": 512, "ls_n": 32,
              "ls_nrhs": 4, "geqrf_n": 64, "geqrf_nb": 16, "mixed_n": 96, "inv_n": 48,
              "batch": 4, "bucket": 8, "batch_nrhs": 1}


def test_chip_phase_rehearsal(one_rank_world):
    import chip_smoke as cs

    res = cs.dist_path("cpu", SMALL_DIST)
    cs.check_dist_path(res, SMALL_DIST)
    assert res["grid"].startswith("1x1") and res["world_size"] == 1
    for kind in ("one", "inf", "max", "fro"):
        assert res[f"norm_{kind}_launches"] == {"col_reduce": 0, "row_sums": 0}
