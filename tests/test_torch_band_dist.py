"""Parity of the distributed band and Hermitian-indefinite solvers
(``slate_tpu_torch.parallel.band_dist`` / ``indefinite_dist``) with the JAX
package's, mirroring ``tests/test_straggler_dist.py``'s TestBandCholeskyDist,
TestBandLUDist, TestIndefiniteDist, the band and indefinite cases of
TestComplexDist, and TestEdgeShapes.

The port runs on eight gloo ranks (one pool for the module, one intra-op
thread each), the JAX package in this process on its virtual 8-device mesh,
imported lazily (the ranks import this module, torch only).  Both get the
same numpy inputs; solves are held to the backward-error gate with ``info``
equal to the JAX package's.  The compiled-module checks of the JAX tests
become counts of the bytes each rank receives: a band factorization moves
O(n·kd) a rank (one masked sum of a (kd+1)×w window per window), which a
whole-matrix gather would exceed.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from slate_tpu_torch.parallel.launch import GRID, RankPool

G24 = (2, 4, "col")


@pytest.fixture(scope="module")
def pool():
    with RankPool(8) as p:
        yield p


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from slate_tpu import parallel as jp

    return SimpleNamespace(jax=jax, jnp=jnp, jp=jp, g24=jp.ProcessGrid(2, 4),
                           g11=jp.ProcessGrid(1, 1, devices=jax.devices()[:1]))


def rng(s=0):
    return np.random.default_rng(s)


def _spd_band(r, n, kd, cplx=False):
    A = np.zeros((n, n), complex if cplx else float)
    for j in range(1, kd + 1):
        v = r.standard_normal(n - j)
        if cplx:
            v = v + 1j * r.standard_normal(n - j)
        A += np.diag(v, j) + np.diag(v.conj(), -j)
    return A + np.diag(np.abs(r.standard_normal(n)) + (6 if cplx else 4) * kd)


def _gen_band(r, n, kl, ku):
    G = np.zeros((n, n))
    for j in range(1, kl + 1):
        G += np.diag(r.standard_normal(n - j), -j)
    for j in range(1, ku + 1):
        G += np.diag(r.standard_normal(n - j), j)
    return G + np.diag(r.standard_normal(n))


def lower_band(A, kd):
    n = A.shape[0]
    j, i = np.arange(kd + 1)[:, None], np.arange(n)[None, :]
    return np.where(i + j < n, A[np.clip(i + j, 0, n - 1), i], 0)


def general_band(A, kl, ku, extra=0):
    n = A.shape[0]
    j, i = np.arange(kl + ku + extra + 1)[:, None], np.arange(n)[None, :]
    r = i + j - ku - extra
    return np.where((r >= 0) & (r < n), A[np.clip(r, 0, n - 1), i], 0)


def run(pool, name, *args, grid=G24, **kw):
    return pool.call(name, *args, grid=grid, **kw)


def berr(A, X, B):
    return np.linalg.norm(A @ X - B) / (np.linalg.norm(A) * np.linalg.norm(X))


def gate(A):
    return 50 * np.finfo(np.float64).eps * np.sqrt(A.shape[0])


# ---------------------------------------------------------------------------
# jobs the ranks run (torch only)


def _received(name, args, kwargs, spec):
    """Bytes this rank receives through the collectives while ``name`` runs,
    counted as tests/test_torch_parallel.py counts them."""
    import torch.distributed as dist
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
        _resolve(name)(*args, **kwargs)
    finally:
        C._all_reduce, C._all_gather, C._send_recv, C._exchange = saved
    return got[0]


def _band_wrapper(kind, a, b, kd, spec, host=True):
    """pbsv / gbsv through the public driver on a band wrapper bound to the
    grid, B plain; returns (X, info, what the wrapper holds after) on the
    host, or nothing (``host=False``: no gather after the call)."""
    import torch
    import slate_tpu_torch as st
    from slate_tpu_torch.parallel.launch import grid_of, to_host

    g = grid_of(spec)
    n = a.shape[0]
    t = torch.as_tensor(a)
    b = torch.as_tensor(b)
    if kind == "pbsv":
        W = st.HermitianBandMatrix("lower", n, kd, 8, grid=g, device="cpu", dtype=t.dtype)
        W.set_array(torch.tril(t))
        X, info = st.pbsv(W, b, {"block_size": 8})
    else:
        W = st.BandMatrix(n, n, kd, kd, 8, grid=g, device="cpu", dtype=t.dtype)
        W.set_array(t)
        X, info = st.gbsv(W, b, {"block_size": 8})
    return to_host((X, info, W.array)) if host else None


def _band_wrapper_received(kind, a, b, kd, spec):
    """Bytes received by the wrapper route (the band comes off the blocks,
    the factor writes back shard by shard)."""
    return _received("test_torch_band_dist._band_wrapper", (kind, a, b, kd, spec),
                     {"host": False}, spec)


def _gathered_pbsv(Ab, b, kd, grid):
    """pbsv_distributed after a whole-matrix gather of a block-layout n×n
    operand: what the byte bound must catch."""
    from slate_tpu_torch.parallel import gather, pbsv_distributed
    from slate_tpu_torch.parallel.distribute import local_block, wrap

    n = Ab.shape[1]
    gather(wrap(local_block(Ab.new_zeros((n, n)), grid), grid, (n, n)))
    return pbsv_distributed(Ab, b, grid, kd, nb=8)


# ---------------------------------------------------------------------------


class TestBandCholeskyDist:
    def test_pbtrf_residual(self, pool, jx):
        n, kd, nb = 200, 9, 8
        A = _spd_band(rng(1), n, kd)
        Ab = lower_band(np.tril(A), kd)
        Lb, info = run(pool, "pbtrf_distributed", Ab, GRID, kd, nb=nb)
        L = run(pool, "band_lower_to_dense", Lb, n)
        assert np.linalg.norm(L @ L.T - A) / np.linalg.norm(A) < 1e-13
        jLb, jinfo = jx.jp.pbtrf_distributed(jx.jnp.asarray(Ab), jx.g24, kd, nb=nb)
        assert int(info) == int(jinfo) == 0
        assert np.abs(Lb - np.asarray(jLb)).max() < 1e-12 * np.abs(Lb).max()

    def test_pbtrs_and_pbsv(self, pool, jx):
        n, kd, nb = 150, 5, 16
        A = _spd_band(rng(2), n, kd)
        Ab = lower_band(np.tril(A), kd)
        B = rng(3).standard_normal((n, 3))
        Lb, _ = run(pool, "pbtrf_distributed", Ab, GRID, kd, nb=nb)
        X = run(pool, "pbtrs_distributed", Lb, B, GRID, kd, nb=nb)
        assert np.linalg.norm(A @ X - B) / np.linalg.norm(B) < 1e-12
        X2, info = run(pool, "pbsv_distributed", Ab, B, GRID, kd, nb=nb)
        jX, jinfo = jx.jp.pbsv_distributed(jx.jnp.asarray(Ab), jx.jnp.asarray(B), jx.g24,
                                           kd, nb=nb)
        assert berr(A, X2, B) < gate(A) and berr(A, np.asarray(jX), B) < gate(A)
        assert int(info) == int(jinfo) == 0

    def test_tbsm_trans(self, pool):
        n, kd, nb = 120, 7, 8
        A = _spd_band(rng(4), n, kd)
        Lb, _ = run(pool, "pbtrf_distributed", lower_band(np.tril(A), kd), GRID, kd, nb=nb)
        L = run(pool, "band_lower_to_dense", Lb, n)
        B = rng(5).standard_normal((n, 2))
        Y = run(pool, "tbsm_distributed", Lb, B, GRID, kd, nb=nb, trans=True)
        assert np.linalg.norm(L.T @ Y - B) / np.linalg.norm(B) < 1e-12
        y = run(pool, "tbsm_distributed", Lb, B[:, 0], GRID, kd, nb=nb)
        assert y.shape == (n,) and np.linalg.norm(L @ y - B[:, 0]) / np.linalg.norm(B) < 1e-12

    def test_not_spd_info(self, pool, jx):
        n, kd = 64, 3
        A = _spd_band(rng(6), n, kd)
        A[10, 10] = -50.0
        Ab = lower_band(np.tril(A), kd)
        _, info = run(pool, "pbtrf_distributed", Ab, GRID, kd, nb=8)
        _, jinfo = jx.jp.pbtrf_distributed(jx.jnp.asarray(Ab), jx.g24, kd, nb=8)
        assert int(info) != 0 and int(info) == int(jinfo)


class TestBandLUDist:
    def test_gbsv_pivoting_active(self, pool, jx):
        """Indefinite band: in-window pivoting engages and the wide factored
        storage keeps the window multipliers."""
        n, kb, nb = 128, 16, 16
        G = _gen_band(rng(7), n, kb, kb)
        Gb = general_band(G, kb, kb, extra=kb)
        B = rng(8).standard_normal((n, 2))
        X, info = run(pool, "gbsv_distributed", Gb, B, GRID, kb, kb, nb=nb)
        jX, jinfo = jx.jp.gbsv_distributed(jx.jnp.asarray(Gb), jx.jnp.asarray(B), jx.g24,
                                           kb, kb, nb=nb)
        assert np.linalg.norm(G @ X - B) / np.linalg.norm(B) < 1e-11
        assert berr(G, np.asarray(jX), B) < gate(G) and berr(G, X, B) < gate(G)
        assert int(info) == int(jinfo) == 0

    def test_gbsv_asymmetric_band(self, pool):
        n, kl, ku = 200, 7, 5
        G = _gen_band(rng(9), n, kl, ku)
        B = rng(10).standard_normal((n, 3))
        X, info = run(pool, "gbsv_distributed", general_band(G, kl, ku, extra=kl), B,
                      GRID, kl, ku, nb=8)
        assert np.linalg.norm(G @ X - B) / np.linalg.norm(B) < 1e-11
        assert int(info) == 0

    def test_gbtrf_factor_reuse(self, pool):
        """One factor, several solves (a vector right-hand side each), and
        the factored form back to dense with band_general_to_dense."""
        n, kl, ku = 96, 4, 6
        G = _gen_band(rng(11), n, kl, ku)
        bs = np.stack([np.random.default_rng(s).standard_normal(n) for s in (1, 2)])
        xs, lub = pool.run(_factor_reuse, general_band(G, kl, ku, extra=kl), bs, kl, ku,
                           G24)[0]
        for x, b in zip(xs, bs):
            assert x.shape == (n,) and np.linalg.norm(G @ x - b) / np.linalg.norm(b) < 1e-11
        assert lub.shape[1] == n


def _factor_reuse(Gb, bs, kl, ku, spec):
    import torch
    from slate_tpu_torch.parallel import gbtrf_distributed, gbtrs_distributed
    from slate_tpu_torch.parallel.launch import grid_of, to_host

    g = grid_of(spec)
    fac, _ = gbtrf_distributed(torch.from_numpy(Gb), g, kl, ku, nb=8)
    xs = [gbtrs_distributed(fac, torch.from_numpy(b), g) for b in bs]
    return to_host((xs, fac.lub))


class TestIndefiniteDist:
    def test_hetrf_reconstruction(self, pool):
        n, nb = 128, 16
        a = rng(12).standard_normal((n, n))
        a = (a + a.T) / 2
        fac, info = run(pool, "hetrf_distributed", a, GRID, nb=nb)
        L, perm = fac.L, fac.perm
        T = run(pool, "band_general_to_dense", fac.Tband, n, nb, nb, extra=nb)
        PAP = a[perm][:, perm]
        assert np.linalg.norm(PAP - L @ T @ L.T) / np.linalg.norm(a) < 1e-12
        assert sorted(perm.tolist()) == list(range(n))
        assert int(info) == 0
        assert np.allclose(np.diag(L), 1.0) and np.linalg.norm(np.triu(L, 1)) == 0.0

    def test_hesv_solves(self, pool, jx):
        n, nb = 100, 8                       # padded, unaligned
        a = rng(13).standard_normal((n, n))
        a = (a + a.T) / 2
        B = rng(14).standard_normal((n, 3))
        X, info = run(pool, "hesv_distributed", a, B, GRID, nb=nb)
        jX, jinfo = jx.jp.hesv_distributed(jx.jnp.asarray(a), jx.jnp.asarray(B), jx.g24,
                                           nb=nb)
        assert np.linalg.norm(a @ X - B) / np.linalg.norm(B) < 1e-11
        assert berr(a, X, B) < 10 * gate(a) and berr(a, np.asarray(jX), B) < 10 * gate(a)
        assert int(info) == int(jinfo) == 0


class TestComplexDist:
    def test_complex_hesv(self, pool):
        n, nb = 96, 8
        r = rng(15)
        H = r.standard_normal((n, n)) + 1j * r.standard_normal((n, n))
        H = (H + H.conj().T) / 2
        B = r.standard_normal((n, 2)) + 1j * r.standard_normal((n, 2))
        X, info = run(pool, "hesv_distributed", H, B, GRID, nb=nb)
        assert np.linalg.norm(H @ X - B) / np.linalg.norm(B) < 1e-11
        assert int(info) == 0

    def test_complex_pbsv(self, pool):
        n, kd, nb = 96, 5, 8
        r = rng(16)
        A = _spd_band(r, n, kd, cplx=True)
        B = r.standard_normal((n, 2)) + 1j * r.standard_normal((n, 2))
        X, info = run(pool, "pbsv_distributed", lower_band(np.tril(A), kd), B, GRID, kd,
                      nb=nb)
        assert np.linalg.norm(A @ X - B) / np.linalg.norm(B) < 1e-12
        assert int(info) == 0


class TestEdgeShapes:
    """1×1 grid, one panel (nb = n), tiny n over 8 ranks, full-bandwidth
    band, kl = 0 band."""

    def test_edges(self, pool):
        r = rng(17)
        B = r.standard_normal((40, 2))
        H = r.standard_normal((40, 40))
        H = (H + H.T) / 2
        X, _ = run(pool, "hesv_distributed", H, B, GRID, nb=8, grid=(1, 1, "col"))
        assert np.linalg.norm(H @ X - B) / np.linalg.norm(B) < 1e-11
        X2, _ = run(pool, "hesv_distributed", H, B, GRID, nb=40)
        assert np.linalg.norm(H @ X2 - B) / np.linalg.norm(B) < 1e-11
        H3 = r.standard_normal((8, 8))
        H3 = (H3 + H3.T) / 2
        B3 = r.standard_normal((8, 1))
        X3, _ = run(pool, "hesv_distributed", H3, B3, GRID, nb=4)
        assert np.linalg.norm(H3 @ X3 - B3) / np.linalg.norm(B3) < 1e-11
        A = H @ H.T + 80 * np.eye(40)
        Xb, _ = run(pool, "pbsv_distributed", lower_band(np.tril(A), 39), B, GRID, 39, nb=8)
        assert np.linalg.norm(A @ Xb - B) / np.linalg.norm(B) < 1e-12
        G = np.triu(np.tril(r.standard_normal((40, 40)), 2)) + 10 * np.eye(40)
        Xg, _ = run(pool, "gbsv_distributed", general_band(G, 0, 2), B, GRID, 0, 2, nb=8)
        assert np.linalg.norm(G @ Xg - B) / np.linalg.norm(B) < 1e-12


class TestBandDistributedNotReplicated:
    """Bytes each rank receives at 2×4, in elements of 8 bytes, n = 512.
    Counting convention (tests/test_torch_parallel.py): an all-reduce
    delivers its tensor once per grid dim it runs over (two for the
    flattened grid).

    * pbsv: per window of the factor one (kd+1)×w masked sum, per window of
      each of the two sweeps one band window and one w×nrhs block of B:
      2·nt·((kd+1)·w·3 + w·nrhs·2), with nt = npad/nb windows; plus the
      factor cut to n columns and fetched back to npad by the solve, and X
      cut to n rows (each at most a rank's window: 3·(kd+1)·nc + nrhs·nc,
      nc = npad/P), and the info's scalars.
    * gbsv: the factor's nd×wc windows, the forward sweep's nd×nb panels and
      wr×nrhs blocks, the backward sweep's nd×wc windows and wc×nrhs blocks:
      2·nt·(nd·(2wc + nb) + nrhs·(wr + wc)), plus 3·nd·nc + nrhs·nc and the
      info's scalars.

    Both are O(n·kd) a rank, a small share of the 7/8·n² a whole-matrix
    gather would add (checked directly for pbsv)."""

    n, kd, nb, nrhs = 512, 4, 8, 2

    def _pbsv_bound(self):
        from slate_tpu_torch.parallel.band_dist import _chol_geometry

        w, npad = _chol_geometry(self.n, self.kd, self.nb, 8)
        nt, nc = npad // self.nb, npad // 8
        return (2 * nt * ((self.kd + 1) * w * 3 + w * self.nrhs * 2)
                + (3 * (self.kd + 1) + self.nrhs) * nc + 4)

    def test_pbsv(self, pool):
        n, kd = self.n, self.kd
        A = _spd_band(rng(18), n, kd)
        B = rng(19).standard_normal((n, self.nrhs))
        got = pool.run(_received, "pbsv_distributed", (lower_band(np.tril(A), kd), B,
                                                       GRID, kd), {"nb": self.nb}, G24)
        bound = self._pbsv_bound()
        assert max(got) / 8 <= bound
        assert max(got) / 8 + 7 / 8 * n * n > bound

    def test_gbsv(self, pool):
        from slate_tpu_torch.parallel.band_dist import _band_lu_geometry

        n, kl, nb, nrhs = self.n, self.kd, self.nb, self.nrhs
        G = _gen_band(rng(20), n, kl, kl)
        B = rng(21).standard_normal((n, nrhs))
        got = pool.run(_received, "gbsv_distributed",
                       (general_band(G, kl, kl, extra=kl), B, GRID, kl, kl), {"nb": nb},
                       G24)
        wr, wc, nd, npad = _band_lu_geometry(n, kl, kl, nb, 8)
        nt, nc = npad // nb, npad // 8
        bound = 2 * nt * (nd * (2 * wc + nb) + nrhs * (wr + wc)) + (3 * nd + nrhs) * nc + 4
        assert max(got) / 8 <= bound
        assert bound < 7 / 8 * n * n

    def test_pbsv_wrapper(self, pool):
        """Through the public driver on a grid-bound band wrapper: the band
        comes off the blocks in one masked sum of (kd+1)·n (twice, one per
        grid dim) and the factor goes back shard by shard after one gather
        of its compact form ((P-1)/P·(kd+1)·n): still O(n·kd)."""
        n, kd = self.n, self.kd
        A = _spd_band(rng(22), n, kd)
        B = rng(23).standard_normal((n, self.nrhs))
        got = pool.run(_band_wrapper_received, "pbsv", A, B, kd, G24)
        bound = self._pbsv_bound() + 3 * (kd + 1) * n
        assert max(got) / 8 <= bound
        assert max(got) / 8 + 7 / 8 * n * n > bound

    def test_whole_gather_fails_the_bound(self, pool):
        n, kd = self.n, self.kd
        A = _spd_band(rng(24), n, kd)
        got = pool.run(_received, "test_torch_band_dist._gathered_pbsv",
                       (lower_band(np.tril(A), kd), rng(25).standard_normal((n, 2)), kd,
                        GRID), {}, G24)
        assert max(got) / 8 > self._pbsv_bound()


def test_band_wrappers_write_back(pool):
    """The grid routes write the factor into the wrapper, shard by shard:
    pbsv leaves L; gbsv leaves the factored form, except in a band wrapper
    whose storage holds only kl subdiagonals (the JAX package's guard)."""
    n, kd = 64, 3
    A = _spd_band(rng(26), n, kd)
    B = rng(27).standard_normal((n, 2))
    X, info, W = pool.run(_band_wrapper, "pbsv", A, B, kd, G24)[0]
    assert int(info) == 0 and berr(A, X, B) < gate(A)
    assert np.linalg.norm(np.tril(W) @ np.tril(W).T - A) / np.linalg.norm(A) < 1e-13
    G = _gen_band(rng(28), n, kd, kd)
    X, info, W = pool.run(_band_wrapper, "gbsv", G, B, kd, G24)[0]
    assert int(info) == 0 and berr(G, X, B) < gate(G)
    assert np.array_equal(W, G)            # kl < wr - 1: the wrapper keeps A


def _cols_shards(a, spec):
    """This rank's (mesh coordinate, COLS shard) of ``a``, and the COLS
    DTensor gathered back and fetched into the row layout."""
    import torch
    from slate_tpu_torch.parallel.distribute import (COLS, ROWS, gather, layout_of,
                                                     local_block, wrap)
    from slate_tpu_torch.parallel.launch import grid_of

    g = grid_of(spec)
    t = torch.from_numpy(a)
    loc = local_block(t, g, layout=COLS)
    X = wrap(loc, g, a.shape, COLS)
    rows = local_block(X, g, layout=ROWS)                  # window by window
    return (tuple(g.my_coords), loc.numpy(), layout_of(X), gather(X).numpy(),
            rows.numpy(), local_block(t, g, layout=ROWS).numpy())


@pytest.mark.parametrize("order", ["col", "row"])
def test_cols_layout_placement(pool, jx, order):
    """The column layout over the flattened grid: each rank's shard equals,
    bit for bit, the JAX array's shard at the same mesh coordinate under
    ``P(None, (ROW_AXIS, COL_AXIS))`` (band_dist's compact storage); the
    DTensor gathers back whole and moves to the row layout exactly."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from slate_tpu.parallel.mesh import COL_AXIS, ROW_AXIS

    a = rng(29).standard_normal((6, 40))
    g = jx.jp.ProcessGrid(2, 4, order=order)
    arr = jx.jax.device_put(jx.jnp.asarray(a),
                            NamedSharding(g.mesh, P(None, (ROW_AXIS, COL_AXIS))))
    want = {}
    for sh in arr.addressable_shards:
        (i, j), = np.argwhere(g.mesh.devices == sh.device)
        want[(int(i), int(j))] = np.asarray(sh.data)
    for coords, loc, layout, whole, rows, rows_ref in pool.run(_cols_shards, a,
                                                               (2, 4, order)):
        np.testing.assert_array_equal(loc, want[coords])
        assert layout == "cols"
        np.testing.assert_array_equal(whole, a)
        np.testing.assert_array_equal(rows, rows_ref)
