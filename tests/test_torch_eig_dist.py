"""Parity of the distributed eigenvalue / SVD tier (``slate_tpu_torch.parallel``
``eig_dist``, ``chase_dist``, ``secular``, stedc's grid) with the JAX
package's, mirroring ``tests/test_eig_dist.py`` (TestHeevDistributed,
TestSvdDistributed, TestStage1Sharding, TestShardedChaseVectors),
``tests/test_chase_dist.py``, and the distributed tests of
``tests/test_heev_range.py``, ``tests/test_stedc.py`` and
``tests/test_steqr.py``.

The port runs on eight gloo ranks (one pool for the module, one intra-op
thread each), the JAX package in this process on its virtual 8-device mesh,
imported lazily (the ranks import this module for its jobs, torch only).
Both get the same numpy inputs.  Tolerances: the chases equal the port's
single-device pipelined chases bit for bit; eigenvalues and singular values
agree with the JAX package within 50·eps·sqrt(n)·||A||_2; vectors pass the
residual and orthogonality gates (their signs and bases are free).  The
compiled-module checks of the JAX tests become counts: the bytes each rank
receives through the collectives, the collectives a call makes, and each
rank's share of the chase's windows.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slate_tpu_torch.parallel.launch import GRID, RankPool
from torch_rank_jobs import counted_call

G24 = {"col": (2, 4, "col"), "row": (2, 4, "row")}
G22 = (2, 2, "col")
EPS = {np.float32: np.finfo(np.float32).eps, np.float64: np.finfo(np.float64).eps,
       np.complex64: np.finfo(np.float32).eps, np.complex128: np.finfo(np.float64).eps}


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


def rng(s=0):
    return np.random.default_rng(s)


def sym(n, seed, dtype=np.float64, cplx=False):
    r = rng(seed)
    m = r.standard_normal((n, n))
    if cplx:
        m = m + 1j * r.standard_normal((n, n))
    return ((m + m.conj().T) / 2).astype(dtype)


def tol(a, dtype=None) -> float:
    """50·eps·sqrt(n)·||A||_2, the values' agreement bound."""
    n = min(a.shape)
    return 50 * EPS[dtype or a.dtype.type] * np.sqrt(n) * np.linalg.norm(a, 2)


def run(pool, name, *args, grid=G24["col"], **kw):
    """Rank 0's numpy result of ``name(*args, **kw)`` on the grid."""
    return pool.call(name, *args, grid=grid, **kw)


# ---------------------------------------------------------------------------
# jobs the ranks run (torch only)


def _band(n, b, seed, cplx=False, upper=False):
    r = rng(seed)
    m = r.standard_normal((n, n))
    if cplx:
        m = m + 1j * r.standard_normal((n, n))
    ri, ci = np.arange(n)[:, None], np.arange(n)[None, :]
    if upper:
        return np.where((ci >= ri) & (ci - ri <= b), m, 0)
    return np.where(np.abs(ri - ci) <= b, (m + m.conj().T) / 2, 0)


def _chase_pair(n, b, seed, spec, cplx=False, bidiag=False, want_vectors=True):
    """The distributed chase and the port's single-device pipelined chase on
    one band: each output pair, and whether they are equal bit for bit."""
    from slate_tpu_torch.linalg.eig import _hb2st_chase_pipelined
    from slate_tpu_torch.linalg.svd import _tb2bd_chase_pipelined
    from slate_tpu_torch.parallel import hb2st_chase_distributed, tb2bd_chase_distributed
    from slate_tpu_torch.parallel.launch import grid_of

    g = grid_of(spec)
    if g.rank < 0:
        return None
    A = torch.tensor(_band(n, b, seed, cplx, upper=bidiag))
    if bidiag:
        ref = _tb2bd_chase_pipelined(A.clone(), b)
        got = tb2bd_chase_distributed(A, b, g, want_vectors=want_vectors)
    else:
        ref = _hb2st_chase_pipelined(A.clone(), b)
        got = hb2st_chase_distributed(A, b, g, want_vectors=want_vectors)
    return ([bool(torch.equal(x, y)) for x, y in zip(ref, got)],
            [y.numpy() for y in got], [x.numpy() for x in ref])


def _received(name, args, kwargs, spec):
    """Bytes this rank receives through the collectives while ``name`` runs
    (the primitives wrapped for this call, as tests/test_torch_parallel.py
    counts them) and how many point-to-point exchanges it made."""
    import torch.distributed as dist
    from slate_tpu_torch.parallel import collectives as C
    from slate_tpu_torch.parallel.launch import _resolve, grid_of, to_device

    grid = grid_of(spec)
    if grid.rank < 0:
        return None
    got, p2p = [0], [0]
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
        p2p[0] += 1
        return saved[3](sends, recvs)

    args = [grid if isinstance(a, str) and a == GRID else to_device(a) for a in args]
    C._all_reduce, C._all_gather, C._send_recv, C._exchange = (
        all_reduce, all_gather, send_recv, exchange)
    try:
        _resolve(name)(*args, **kwargs)
    finally:
        C._all_reduce, C._all_gather, C._send_recv, C._exchange = saved
    return got[0], p2p[0]


def _every_rank(A, nb, spec):
    """Each rank's eigenvalues (values-only and with vectors) and singular
    values, as bytes, to compare across ranks."""
    from slate_tpu_torch.parallel import heev_distributed, svd_distributed
    from slate_tpu_torch.parallel.launch import grid_of

    g = grid_of(spec)
    a = torch.from_numpy(A)
    lam, _ = heev_distributed(a, g, nb=nb, want_vectors=False)
    lam_v, _ = heev_distributed(a, g, nb=nb)
    lam_c, _ = heev_distributed(a, g, nb=nb, method_eig="qr")
    S, _, _ = svd_distributed(a, g, nb=nb, want_vectors=False)
    return [x.numpy().tobytes() for x in (lam, lam_v, lam_c, S)]


def _wrapper(kind, a, spec, opts):
    """A public driver on a wrapper bound to the grid; counts every use of
    the distributed chases (the forwarding check)."""
    import slate_tpu_torch as st
    from slate_tpu_torch.parallel import chase_dist
    from slate_tpu_torch.parallel.launch import grid_of, to_host

    g = grid_of(spec)
    if g.rank < 0:
        return None, []
    t = torch.from_numpy(a)
    seen = []
    saved = chase_dist.hb2st_chase_distributed, chase_dist.tb2bd_chase_distributed

    def spy(fn):
        def wrapped(*args, **kw):
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return wrapped

    chase_dist.hb2st_chase_distributed, chase_dist.tb2bd_chase_distributed = map(spy, saved)
    try:
        if kind == "heev":
            out = st.heev(st.HermitianMatrix.from_array("lower", t, nb=8, grid=g), opts,
                          want_vectors=False, chase_distributed=True)
        elif kind == "svd":
            out = st.svd(st.Matrix.from_array(t, nb=8, grid=g), opts, want_u=False,
                         want_vt=False, chase_distributed=True)
        elif kind == "heev_range":
            out = st.heev_range(st.HermitianMatrix.from_array("lower", t, nb=16, grid=g),
                                opts, il=10, iu=20)
        elif kind == "svd_range":
            out = st.svd_range(st.Matrix.from_array(t, nb=16, grid=g), opts, il=0, iu=5)
        elif kind == "eig_count":
            try:
                st.eig_count(st.HermitianMatrix.from_array("lower", t, nb=16, grid=g),
                             -1.0, 1.0)
                out = None
            except st.SlateError as e:
                out = (type(e).__name__, str(e))
        else:
            raise ValueError(kind)
    finally:
        chase_dist.hb2st_chase_distributed, chase_dist.tb2bd_chase_distributed = saved
    return to_host(out), seen


def _gridless_refusals(a):
    """chase_distributed on a plain tensor: both drivers refuse."""
    import slate_tpu_torch as st

    msgs = []
    for f in (lambda: st.heev(torch.from_numpy(a), want_vectors=False,
                              chase_distributed=True),
              lambda: st.svd(torch.from_numpy(a), want_u=False, want_vt=False,
                             chase_distributed=True)):
        try:
            f()
            msgs.append(None)
        except st.SlateError as e:
            msgs.append(str(e))
    return msgs


def _grid_kw(name, args, kwargs, spec):
    """``name(*args, **kwargs)`` with numpy turned into tensors and GRID into
    the grid; the result as it comes (counted_call brings it to the host
    after its count)."""
    from slate_tpu_torch.parallel.launch import _resolve, grid_of, to_device

    g = grid_of(spec)
    args = [g if isinstance(a, str) and a == GRID else to_device(a) for a in args]
    kwargs = {k: (g if isinstance(v, str) and v == GRID else to_device(v))
              for k, v in kwargs.items()}
    return _resolve(name)(*args, **kwargs)


def counted(pool, name, args, kwargs=None, spec=G24["col"]):
    """Every rank's (numpy result, collectives made) of one call."""
    return pool.run(counted_call, "test_torch_eig_dist._grid_kw",
                    (name, args, kwargs or {}, spec), {}, spec)


def _stedc_job(d, e, Z, merge_min, spec):
    """stedc over the grid with the distributed-merge threshold lowered so a
    small size takes the grid path, and the collectives it made."""
    import importlib

    sm = importlib.import_module("slate_tpu_torch.linalg.stedc")
    old = sm._DIST_MERGE_MIN
    sm._DIST_MERGE_MIN = merge_min
    try:
        kw = {"grid": GRID} if Z is None else {"grid": GRID, "Z": Z}
        return counted_call("test_torch_eig_dist._grid_kw",
                            ("slate_tpu_torch.linalg.stedc.stedc", (d, e), kw, spec),
                            {}, spec)
    finally:
        sm._DIST_MERGE_MIN = old


def _error(name, args, kwargs, spec):
    """The message of the error ``name`` raises here (None if it returns)."""
    try:
        _grid_kw(name, args, kwargs, spec)
    except Exception as e:                    # noqa: BLE001 - the message is checked
        return f"{type(e).__name__}: {e}"
    return None


def _secular_rows(m, seed, spec):
    """secular_roots_sharded against the replicated solve, and how many
    brackets this rank bisected."""
    import importlib

    from slate_tpu_torch.parallel.launch import grid_of
    from slate_tpu_torch.parallel.secular import secular_roots_sharded

    sm = importlib.import_module("slate_tpu_torch.linalg.stedc")
    g = grid_of(spec)
    r = rng(seed)
    d = torch.tensor(np.sort(r.standard_normal(m)))
    z2 = torch.tensor(r.standard_normal(m) ** 2 + 1e-3)
    rho = torch.tensor(0.7)
    seen = []
    real = sm._secular_bisect

    def spy(d_, z2_, rho_, pole, *rest):
        seen.append(pole.shape[0])
        return real(d_, z2_, rho_, pole, *rest)

    sm._secular_bisect = spy
    try:
        t8, s8, lam8 = secular_roots_sharded(d, z2, rho, g)
    finally:
        sm._secular_bisect = real
    t1, s1, lam1 = sm._secular_roots(d, z2, rho)
    return [x.numpy() for x in (t8, s8, lam8, t1, s1, lam1)], seen


def _q2_rows(A, kd, spec):
    """hb2st_q_distributed against the replicated Q2, with each rank's row
    count (and its collectives, by counted_call)."""
    from slate_tpu_torch.linalg.eig import hb2st, hb2st_reflectors, he2hb
    from slate_tpu_torch.parallel import eig_dist
    from slate_tpu_torch.parallel.launch import grid_of

    g = grid_of(spec)
    a = torch.from_numpy(A)
    band, _, _ = he2hb(a, None, nb=kd)
    _, _, Q2_r = hb2st(band, kd=kd, want_vectors=True)
    _, e_c, Vs, taus = hb2st_reflectors(band, kd=kd)
    Q = eig_dist.hb2st_q_distributed(Vs, taus, e_c, A.shape[0], g)
    return Q2_r.numpy(), tuple(Q.to_local().shape), Q


def _q2_counted(A, kd, spec):
    return counted_call("test_torch_eig_dist._q2_rows", (A, kd, spec), {}, spec)


# ---------------------------------------------------------------------------


class TestHeevDistributed:
    def test_values_and_vectors(self, pool, jx):
        n = 48
        A = sym(n, 1, np.float32)
        lam, Z = run(pool, "heev_distributed", A, GRID, nb=8)
        jlam, jZ = jx.jp.heev_distributed(jx.jnp.asarray(A), jx.g24, nb=8)
        np.testing.assert_allclose(np.sort(lam), np.linalg.eigvalsh(A), atol=2e-4)
        assert np.abs(A @ Z - Z * lam[None, :]).max() < 5e-3
        assert np.abs(lam - np.asarray(jlam)).max() <= tol(A)

    def test_values_only_dc(self, pool, jx):
        n = 40
        A = sym(n, 2, np.float32)
        lam, Z = run(pool, "heev_distributed", A, GRID, nb=8, want_vectors=False,
                     method_eig="dc")
        jlam, _ = jx.jp.heev_distributed(jx.jnp.asarray(A), jx.g24, nb=8,
                                         want_vectors=False, method_eig="dc")
        assert Z is None
        np.testing.assert_allclose(np.sort(lam), np.linalg.eigvalsh(A), atol=2e-4)
        assert np.abs(lam - np.asarray(jlam)).max() <= tol(A)

    def test_vectors_dc_routes_stedc(self, pool):
        """method_eig='dc' with vectors goes through stedc (the counted
        collectives include the merges' when their threshold is lowered)."""
        n = 40
        A = sym(n, 42, np.float32)
        lam, Z = run(pool, "heev_distributed", A, GRID, nb=8, method_eig="dc")
        np.testing.assert_allclose(np.sort(lam), np.linalg.eigvalsh(A), atol=2e-4)
        assert np.abs(A @ Z - Z * lam[None, :]).max() < 5e-3

    def test_tiny_input_falls_back(self, pool):
        lam, Z = run(pool, "heev_distributed", np.ones((1, 1), np.float32), GRID)
        assert np.allclose(lam, [1.0])
        S, U, VT = run(pool, "svd_distributed", np.ones((2, 3), np.float32), GRID)
        assert S.shape == (2,)

    def test_complex(self, pool, jx):
        n = 24
        A = sym(n, 3, np.complex64, cplx=True)
        lam, Z = run(pool, "heev_distributed", A, GRID, nb=4)
        jlam, _ = jx.jp.heev_distributed(jx.jnp.asarray(A), jx.g24, nb=4)
        assert np.abs(A @ Z - Z * lam[None, :]).max() < 5e-3
        assert np.abs(lam - np.asarray(jlam)).max() <= tol(A)

    @pytest.mark.parametrize("method", ["qr", "bisection"])
    def test_methods(self, pool, jx, method):
        """MethodEig.QR (steqr on each rank's rows) and bisection + stein, in
        both grid orders, against the JAX package's same method."""
        n = 64
        A = sym(n, 5)
        jlam, _ = jx.jp.heev_distributed(jx.jnp.asarray(A), jx.g24, nb=8,
                                         method_eig=method)
        for spec in G24.values():
            lam, Z = run(pool, "heev_distributed", A, GRID, nb=8, method_eig=method,
                         grid=spec)
            assert np.abs(lam - np.asarray(jlam)).max() <= tol(A)
            assert np.linalg.norm(A @ Z - Z * lam) / np.linalg.norm(A) < 50 * EPS[
                np.float64] * np.sqrt(n) * (10 if method == "qr" else 1)
            assert np.linalg.norm(Z.T @ Z - np.eye(n)) / n < 50 * EPS[np.float64] * np.sqrt(n)


class TestSvdDistributed:
    @pytest.mark.parametrize("m,n", [(40, 24), (24, 40), (32, 32), (96, 24)])
    def test_reconstruction(self, pool, jx, m, n):
        a = rng(m + n).standard_normal((m, n)).astype(np.float32)
        S, U, VT = run(pool, "svd_distributed", a, GRID, nb=6)
        jS = np.asarray(jx.jp.svd_distributed(jx.jnp.asarray(a), jx.g24, nb=6,
                                              want_vectors=False)[0])
        np.testing.assert_allclose(S, np.linalg.svd(a, compute_uv=False), atol=2e-4)
        assert np.abs(U @ np.diag(S) @ VT - a).max() < 1e-3
        assert np.abs(S - jS).max() <= tol(a)

    def test_values_only(self, pool):
        a = rng(9).standard_normal((30, 20)).astype(np.float32)
        S, U, VT = run(pool, "svd_distributed", a, GRID, nb=6, want_vectors=False)
        assert U is None and VT is None
        np.testing.assert_allclose(S, np.linalg.svd(a, compute_uv=False), atol=2e-4)

    def test_method_bisection_and_complex(self, pool):
        a = rng(10).standard_normal((48, 40)) + 1j * rng(11).standard_normal((48, 40))
        S, U, VT = run(pool, "svd_distributed", a, GRID, nb=8, method_svd="bisection")
        np.testing.assert_allclose(S, np.linalg.svd(a, compute_uv=False), atol=1e-10)
        assert np.linalg.norm(U * S @ VT - a) / np.linalg.norm(a) < 1e-10


class TestStage1Sharding:
    """The JAX tests prove stage 1 sharded from the compiled module; here the
    proof is the band's spectrum, the reflectors' layout, and the bytes each
    rank receives."""

    def test_he2hb_distributed_matches_single(self, pool):
        from slate_tpu_torch.linalg.eig import he2hb

        n, nb = 96, 8
        a = sym(n, 20)
        band_d, Vs, Ts = run(pool, "he2hb_distributed", a, GRID, nb=nb)
        band_s, _, _ = he2hb(torch.from_numpy(a), nb=nb)
        lam_d = np.linalg.eigvalsh(band_d)
        lam_s = np.linalg.eigvalsh(band_s.numpy())
        assert np.max(np.abs(lam_d - lam_s)) / np.max(np.abs(lam_s)) < 1e-12
        npad = 128                             # n padded to a multiple of nb·P
        assert Vs.shape == (npad // nb - 1, npad, nb) and Ts.shape == (npad // nb - 1, nb, nb)
        assert np.abs(band_d[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > nb]
                      ).max() == 0

    def test_ge2tb_distributed_preserves_singular_values(self, pool):
        m, n, nb = 120, 80, 8
        a = rng(21).standard_normal((m, n))
        band, _, _ = run(pool, "ge2tb_distributed", a, GRID, nb=nb)
        s_d = np.linalg.svd(band, compute_uv=False)
        s_s = np.linalg.svd(a, compute_uv=False)
        assert np.max(np.abs(s_d - s_s)) / s_s[0] < 1e-12

    def test_complex_he2hb(self, pool):
        H = sym(64, 22, np.complex128, cplx=True)
        band, _, _ = run(pool, "he2hb_distributed", H, GRID, nb=8)
        lam_d = np.sort(np.linalg.eigvalsh(band))
        assert np.max(np.abs(lam_d - np.linalg.eigvalsh(H))) < 1e-12

    def test_he2hb_received_bytes(self, pool):
        """Per rank and panel, stage 1 receives the panel's other rows
        ((P-1)/P·n·nb, the all-gather) and W = Vᴴ A (nb·n, an all-reduce
        over the flattened grid, counted once per grid dim), plus its block
        rows from the block layout once (<= n²/P) and the max norm's
        scalars: nj·((P-1)/P + 2)·n·nb + n²/P + 8.  The bound follows the
        algorithm, which moves O(n²) a rank in all (as the JAX package's);
        it does not separate a whole-matrix gather, which the band and chase
        bounds do (tests/test_torch_band_dist.py and below)."""
        n, nb, P = 256, 16, 8
        a = sym(n, 23)
        got = pool.run(_received, "test_torch_eig_dist._he2hb_block", (a, nb, GRID), {},
                       G24["col"])
        nj = n // nb - 1
        bound = nj * ((P - 1) / P + 2) * n * nb + n * n / P + 8
        assert max(g[0] for g in got) / 8 <= bound


def _he2hb_block(a, nb, grid):
    """he2hb_distributed of a block-layout operand (the wrapper's layout)."""
    from slate_tpu_torch.parallel import he2hb_distributed
    from slate_tpu_torch.parallel.distribute import local_block, wrap

    return he2hb_distributed(wrap(local_block(a, grid), grid, a.shape), grid, nb=nb)


class TestShardedChaseVectors:
    def test_matches_replicated_accumulation(self, pool):
        n, kd = 64, 8
        A = sym(n, 11, np.float32)
        (Q2_r, shape, Q2_s), _ = pool.run(_q2_counted, A, kd, G24["col"])[0]
        assert np.abs(Q2_s - Q2_r).max() < 1e-5
        assert shape == (n // 8, n)

    def test_zero_collectives_and_row_sharding(self, pool):
        """Each rank builds its own rows of Q2 from the tape: no collectives
        (the gather that checks the result comes after the count)."""
        n, kd = 64, 8
        A = sym(n, 12, np.float32)
        got = pool.run(_q2_counted, A, kd, G24["col"])
        for (Q2_r, shape, _), calls in got:
            assert shape == (n // 8, n)
        assert all(calls == 0 for _, calls in got)


class TestChaseDistributed:
    """tests/test_chase_dist.py: the segment-parallel chases equal the port's
    single-device pipelined chases bit for bit (the JAX tests hold theirs to
    1e-10; exchanging the boundary squares instead of summing deltas makes
    the port's exact)."""

    @pytest.mark.parametrize("n,b,spec", [(96, 4, (2, 4, "col")), (96, 4, (1, 4, "col")),
                                          (80, 3, (2, 2, "col")), (61, 5, (2, 2, "col"))])
    def test_chase_distributed_matches_pipelined(self, pool, n, b, spec):
        same, got, ref = pool.run(_chase_pair, n, b, 1, spec)[0]
        assert all(same), [float(np.abs(x - y).max()) for x, y in zip(got, ref)]

    def test_chase_distributed_complex(self, pool, jx):
        """Hermitian complex band: bit for bit against the pipelined chase,
        and |e| and d against the JAX package's sequential chase."""
        from slate_tpu.linalg.eig import _hb2st_chase

        n, b = 96, 4
        same, got, _ = pool.run(_chase_pair, n, b, 2, G24["col"], cplx=True,
                                want_vectors=False)[0]
        assert all(same[:2])
        d0, e0, _, _ = _hb2st_chase(jx.jnp.asarray(_band(n, b, 2, cplx=True)), b)
        assert np.abs(np.asarray(d0) - got[0]).max() < 1e-10
        assert np.abs(np.abs(np.asarray(e0)) - np.abs(got[1])).max() < 1e-10

    def test_chase_distributed_spectrum(self, pool):
        n, b = 72, 6
        _, (d, e_c, _, _), _ = pool.run(_chase_pair, n, b, 3, G22)[0]
        e = np.abs(e_c)
        T = np.diag(d) + np.diag(e, -1) + np.diag(e, 1)
        ref = np.linalg.eigvalsh(_band(n, b, 3))
        assert np.max(np.abs(np.linalg.eigvalsh(T) - ref)) < 1e-10

    def test_chase_distributed_narrow_segment_raises(self, pool):
        """n/P below the 2b+2 floor refuses, on every rank, rather than corrupt."""
        msgs = pool.run(_error, "hb2st_chase_distributed", (_band(32, 6, 4), 6, GRID),
                        {}, G24["col"])
        assert all(m.startswith("SlateError") and "too narrow" in m for m in msgs)

    def test_heev_distributed_chase_distributed(self, pool, jx):
        n = 96
        A = sym(n, 5)
        ref = np.linalg.eigvalsh(A)
        lam, _ = run(pool, "heev_distributed", A, GRID, nb=8, want_vectors=False,
                     chase_distributed=True, grid=G22)
        jlam, _ = jx.jp.heev_distributed(jx.jnp.asarray(A), jx.g22, nb=8,
                                         want_vectors=False, chase_distributed=True)
        assert np.max(np.abs(np.sort(lam) - ref)) < 1e-8 * n
        assert np.abs(lam - np.asarray(jlam)).max() <= tol(A)
        lam2, Z = run(pool, "heev_distributed", A, GRID, nb=8, chase_distributed=True,
                      grid=G22)
        assert np.linalg.norm(A @ Z - Z * lam2[None, :]) / (np.linalg.norm(A) * n) < 1e-12
        assert np.linalg.norm(Z.T @ Z - np.eye(n)) < 1e-10 * n

    @pytest.mark.parametrize("n,b,spec", [(96, 4, (2, 4, "col")), (96, 4, (1, 4, "col")),
                                          (80, 3, (2, 2, "col")), (61, 5, (2, 2, "col"))])
    def test_tb2bd_distributed_matches_pipelined(self, pool, n, b, spec):
        same, got, ref = pool.run(_chase_pair, n, b, 6, spec, bidiag=True)[0]
        assert all(same), [float(np.abs(x - y).max()) for x, y in zip(got, ref)]

    def test_tb2bd_distributed_complex_singular_values(self, pool):
        n, b = 96, 4
        same, (d_c, e_c, *_), _ = pool.run(_chase_pair, n, b, 7, G24["col"], cplx=True,
                                            bidiag=True, want_vectors=False)[0]
        assert all(same[:2])
        Bd = np.diag(np.abs(d_c))
        Bd[np.arange(n - 1), np.arange(1, n)] = np.abs(e_c)
        sv_ref = np.linalg.svd(_band(n, b, 7, cplx=True, upper=True), compute_uv=False)
        assert np.max(np.abs(np.sort(np.linalg.svd(Bd, compute_uv=False))
                             - np.sort(sv_ref))) < 1e-10

    def test_svd_distributed_chase_distributed(self, pool, jx):
        n = 96
        A = rng(8).standard_normal((n, n))
        S, _, _ = run(pool, "svd_distributed", A, GRID, nb=8, want_vectors=False,
                      chase_distributed=True, grid=G22)
        jS = np.asarray(jx.jp.svd_distributed(jx.jnp.asarray(A), jx.g22, nb=8,
                                              want_vectors=False,
                                              chase_distributed=True)[0])
        assert np.max(np.abs(S - np.linalg.svd(A, compute_uv=False))) < 1e-8
        assert np.abs(S - jS).max() <= tol(A)
        S2, U, VT = run(pool, "svd_distributed", A, GRID, nb=8, chase_distributed=True,
                        grid=G22)
        assert np.linalg.norm(U * S2 @ VT - A) / np.linalg.norm(A) < 1e-10

    def test_public_driver_chase_distributed_kwarg(self, pool):
        """heev/svd on grid-bound wrappers forward chase_distributed to the
        distributed pipeline, which runs the segment-parallel chase."""
        n = 96
        A = sym(n, 9)
        got = pool.run(_wrapper, "heev", A, G22, {"block_size": 8})
        (lam, _), seen = got[0]
        assert np.max(np.abs(np.sort(lam) - np.linalg.eigvalsh(A))) < 1e-8 * n
        assert all(s == ["hb2st_chase_distributed"] for _, s in got[:4])
        G = rng(10).standard_normal((n, n))
        got = pool.run(_wrapper, "svd", G, G22, {"block_size": 8})
        (S, _, _), seen = got[0]
        assert np.max(np.abs(S - np.linalg.svd(G, compute_uv=False))) < 1e-8
        assert all(s == ["tb2bd_chase_distributed"] for _, s in got[:4])

    def test_public_driver_chase_distributed_forwarding(self, pool, jx):
        """A gridless call refuses chase_distributed, in both packages."""
        A = sym(16, 11)
        msgs = pool.run(_gridless_refusals, A)[0]
        assert all(m is not None and "grid-bound wrapper" in m for m in msgs)
        for f in (lambda: jx.slate.heev(jx.jnp.asarray(A), want_vectors=False,
                                        chase_distributed=True),
                  lambda: jx.slate.svd(jx.jnp.asarray(A), want_u=False, want_vt=False,
                                       chase_distributed=True)):
            with pytest.raises(jx.slate.SlateError):
                f()

    def test_chase_distributed_perdevice_work_shrinks(self):
        """Each rank's share of the chase's windows at P = 8 is about 1/8 of
        the whole schedule's (the JAX test pins the compiled flops)."""
        from slate_tpu_torch.parallel.chase_dist import _schedule

        n, b = 1024, 16
        n_sweeps, m_max = n - 2, -(-(n - 1) // b)
        whole = len(_schedule(n, b, 0, n, n_sweeps, m_max, False)[2])
        seg = n // 8
        parts = [len(_schedule(n, b, p * seg, (p + 1) * seg, n_sweeps, m_max, False)[2])
                 for p in range(8)]
        assert sum(parts) == whole
        assert max(parts) < 0.3 * whole

    def test_chase_distributed_collectives_are_small(self, pool):
        """Per round a rank receives at most two boundary squares and one
        reflector, O(b²) whatever n is, plus the final gathers of d and e:
        T·(2(2b+1)² + b + 1) + 2·P·seg elements (values only)."""
        b, P = 4, 8
        for n in (96, 192):
            band = _band(n, b, 12)
            got = pool.run(_received, "hb2st_chase_distributed", (band, b, GRID), {},
                           G24["col"])
            T = 2 * (n - 2) + -(-(n - 1) // b)
            seg = -(-n // P)
            bound = T * (2 * (2 * b + 1) ** 2 + b + 1) + 2 * P * seg
            assert max(g[0] for g in got) / 8 <= bound
            assert max(g[1] for g in got) == T            # one exchange a round
        # a rank at the end has one partner: about half a middle rank's traffic
        assert min(g[0] for g in got) < 0.7 * max(g[0] for g in got)


class TestSubsets:
    """The distributed tests of tests/test_heev_range.py."""

    @pytest.mark.parametrize("il,iu", [(0, 8), (40, 56)])
    def test_heev_range_distributed(self, pool, jx, il, iu):
        n = 96
        A = sym(n, 13)
        ref = np.linalg.eigvalsh(A)
        lam, Z = run(pool, "heev_range_distributed", A, GRID, il, iu, nb=8)
        jlam, _ = jx.jp.heev_range_distributed(jx.jnp.asarray(A), jx.g24, il, iu, nb=8,
                                               want_vectors=False)
        assert np.max(np.abs(lam - ref[il:iu])) < 1e-9
        assert np.abs(lam - np.asarray(jlam)).max() <= tol(A)
        assert np.linalg.norm(A @ Z - Z * lam[None, :]) < 1e-8
        assert np.linalg.norm(Z.T @ Z - np.eye(iu - il)) < 1e-8
        lam2, _ = run(pool, "heev_range_distributed", A, GRID, il, iu, nb=8,
                      want_vectors=False)
        assert np.max(np.abs(lam2 - ref[il:iu])) < 1e-9

    def test_heev_range_distributed_with_dist_chase(self, pool):
        n = 96
        A = sym(n, 14)
        lam, Z = run(pool, "heev_range_distributed", A, GRID, 10, 20, nb=6,
                     chase_distributed=True, grid=G22)
        assert np.max(np.abs(lam - np.linalg.eigvalsh(A)[10:20])) < 1e-9
        assert np.linalg.norm(A @ Z - Z * lam[None, :]) < 1e-8

    def test_heev_range_distributed_complex(self, pool):
        n = 96
        A = sym(n, 15, np.complex128, cplx=True)
        lam, Z = run(pool, "heev_range_distributed", A, GRID, 20, 30, nb=8)
        assert np.max(np.abs(lam - np.linalg.eigvalsh(A)[20:30])) < 1e-9
        assert np.linalg.norm(A @ Z - Z * lam[None, :]) < 1e-8

    @pytest.mark.parametrize("m,n", [(96, 96), (64, 128)])
    def test_svd_range_distributed(self, pool, jx, m, n):
        A = rng(16).standard_normal((m, n))
        Sref = np.linalg.svd(A, compute_uv=False)
        S, U, VT = run(pool, "svd_range_distributed", A, GRID, 0, 6, nb=8)
        jS = np.asarray(jx.jp.svd_range_distributed(jx.jnp.asarray(A), jx.g24, 0, 6,
                                                    nb=8, want_vectors=False)[0])
        assert np.max(np.abs(S - Sref[:6])) < 1e-9
        assert np.abs(S - jS).max() <= tol(A)
        assert np.linalg.norm(A @ VT.conj().T - U * S[None, :]) < 1e-8
        S2, _, _ = run(pool, "svd_range_distributed", A, GRID, 0, 6, nb=8,
                       want_vectors=False)
        assert np.max(np.abs(S2 - Sref[:6])) < 1e-9

    def test_svd_range_distributed_with_dist_chase(self, pool):
        A = rng(17).standard_normal((96, 96))
        S, U, VT = run(pool, "svd_range_distributed", A, GRID, 0, 6, nb=6,
                       chase_distributed=True, grid=G22)
        assert np.max(np.abs(S - np.linalg.svd(A, compute_uv=False)[:6])) < 1e-9
        assert np.linalg.norm(A @ VT.conj().T - U * S[None, :]) < 1e-8

    def test_heev_range_wrapper_grid_routes_to_mesh(self, pool, jx):
        n, il, iu = 96, 10, 20
        A = sym(n, 18)
        (lam, Z), _ = pool.run(_wrapper, "heev_range", A, G24["col"],
                               {"block_size": 16})[0]
        H = jx.slate.HermitianMatrix.from_array("lower", jx.jnp.asarray(A), nb=16,
                                                grid=jx.g24)
        jlam, _ = jx.slate.heev_range(H, opts={"block_size": 16}, il=il, iu=iu)
        assert np.max(np.abs(lam - np.linalg.eigvalsh(A)[il:iu])) < 1e-8
        assert np.abs(lam - np.asarray(jlam)).max() <= tol(A)
        assert np.linalg.norm(A @ Z - Z * lam[None, :]) < 1e-7

    def test_svd_range_wrapper_grid_routes_to_mesh(self, pool):
        A = rng(19).standard_normal((96, 64))
        (S, U, VT), _ = pool.run(_wrapper, "svd_range", A, G24["col"],
                                 {"block_size": 16})[0]
        assert np.max(np.abs(S - np.linalg.svd(A, compute_uv=False)[:5])) < 1e-8
        assert np.linalg.norm(A @ VT.T - U * S[None, :]) < 1e-7

    def test_eig_count_wrapper_grid_rejected(self, pool, jx):
        """eig_count has no distributed pipeline in either package: a
        grid-bound wrapper gets the JAX package's own error, word for word."""
        A = sym(64, 20)
        (kind, msg), _ = pool.run(_wrapper, "eig_count", A, G24["col"], None)[0]
        H = jx.slate.HermitianMatrix.from_array("lower", jx.jnp.asarray(A), nb=16,
                                                grid=jx.g24)
        with pytest.raises(jx.slate.SlateError) as err:
            jx.slate.eig_count(H, -1.0, 1.0)
        assert kind == type(err.value).__name__ == "SlateError"
        assert msg == str(err.value)


class TestTridiagonalOnTheGrid:
    """tests/test_stedc.py's distributed merges and secular sharding, and
    tests/test_steqr.py's distributed QR."""

    def test_stedc_distributed_merges(self, pool, jx):
        import importlib

        n = 220
        r = rng(21)
        d, e = r.standard_normal(n), r.standard_normal(n - 1)
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        got = pool.run(_stedc_job, d, e, None, 64, G24["col"])
        (lam, Q), calls = got[0]
        assert all(c > 0 for _, c in got)          # the merges ran over the grid
        ref = np.linalg.eigvalsh(T)
        assert np.max(np.abs(lam - ref)) / np.max(np.abs(ref)) < 1e-13
        assert np.max(np.abs(T @ Q - Q * lam[None, :])) < 1e-12
        assert np.max(np.abs(Q.T @ Q - np.eye(n))) < 1e-12
        jsm = importlib.import_module("slate_tpu.linalg.stedc")
        old = jsm._DIST_MERGE_MIN
        jsm._DIST_MERGE_MIN = 64
        try:
            jlam, _ = jsm.stedc(jx.jnp.asarray(d), jx.jnp.asarray(e), grid=jx.g24)
        finally:
            jsm._DIST_MERGE_MIN = old
        assert np.abs(lam - np.asarray(jlam)).max() <= tol(T)
        Z = r.standard_normal((n, n))
        (lam2, QZ), _ = pool.run(_stedc_job, d, e, Z, 64, G24["col"])[0]
        assert np.max(np.abs(QZ - Z @ Q)) < 1e-11

    @pytest.mark.parametrize("m", [512, 203])
    def test_secular_sharded(self, pool, m):
        """Each rank bisects ceil(m/P) brackets (padded to a multiple of P);
        the roots equal the replicated solve's."""
        got = pool.run(_secular_rows, m, 5, G24["col"])
        (t8, s8, lam8, t1, s1, lam1), seen = got[0]
        scale = 10.0
        np.testing.assert_allclose(lam8, lam1, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(t8, t1, rtol=1e-10, atol=1e-12 * scale)
        assert all(s == [-(-m // 8)] for _, s in got)

    def test_steqr_distributed_matches_single(self, pool):
        from slate_tpu_torch.linalg.steqr_qr import steqr_qr

        n = 80
        r = rng(22)
        d, e = r.standard_normal(n), r.standard_normal(n - 1)
        lam_d, Q_d = run(pool, "steqr_distributed", d, e, GRID)
        lam_s, Q_s = steqr_qr(torch.tensor(d), torch.tensor(e))
        assert np.abs(lam_d - lam_s.numpy()).max() < 1e-13
        assert np.abs(Q_d - Q_s.numpy()).max() < 1e-12

    def test_steqr_distributed_has_no_collectives(self, pool):
        n = 48
        r = rng(23)
        d, e = r.standard_normal(n), r.standard_normal(n - 1)
        got = counted(pool, "steqr_distributed", (d, e, GRID))
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        lam, Q = got[0][0]
        assert np.max(np.abs(T @ Q - Q * lam)) < 1e-12
        # the counted call includes the result's gather only after the count
        assert all(calls == 0 for _, calls in got)


def test_eigenvalues_bit_identical_on_every_rank(pool):
    """Every rank holds the same eigenvalues and singular values, bit for
    bit: the replicated chase's (d, e) are rank 0's, broadcast before any
    data-dependent host loop (stedc's merges make collectives)."""
    A = sym(72, 24)
    got = pool.run(_every_rank, A, 8, G24["col"])
    for kind in range(4):
        assert len({g[kind] for g in got}) == 1, kind


def test_hegv_distributed(pool, jx):
    import scipy.linalg as sla

    n = 48
    A = sym(n, 25)
    B = rng(26).standard_normal((n, n))
    B = B @ B.T / n + 2 * np.eye(n)
    jlam, _ = jx.jp.hegv_distributed(1, jx.jnp.asarray(A), jx.jnp.asarray(B), jx.g24,
                                     nb=8)
    for itype in (1, 2, 3):
        lam, X = run(pool, "hegv_distributed", itype, A, B, GRID, nb=8)
        ref = sla.eigh(A, B, eigvals_only=True, type=itype)
        assert np.abs(lam - ref).max() < 1e-10
        if itype == 1:
            assert np.abs(lam - np.asarray(jlam)).max() <= tol(A) * np.linalg.cond(B)
            assert np.abs(A @ X - B @ X * lam).max() < 1e-10
    msgs = pool.run(_error, "hegv_distributed", (1, A, -np.eye(n), GRID), {"nb": 8},
                    G24["col"])
    assert all("not positive definite" in m for m in msgs)


def test_dryrun_multichip(pool):
    """The dryrun_multichip steps (factor, solve, SUMMA residual, the LU / QR
    / mixed solves, heev / svd / norm) on 8 gloo ranks at small n."""
    from slate_tpu_torch.parallel.launch import dryrun_multichip

    out = dryrun_multichip(8, pool=pool, n=64, device="cpu")
    assert out["grid"] == (2, 4)
    assert all(out["ok"].values()), out


def test_dryrun_multichip_runs_on_the_card_unless_asked(monkeypatch):
    """Without a launcher and without ``device="cpu"`` the dry run asks for
    the card: several ranks need ``torchrun`` and it raises, rather than
    running on a gloo pool on the CPU."""
    import torch.distributed as dist

    from slate_tpu_torch import SlateError
    from slate_tpu_torch.parallel.launch import dryrun_multichip

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(SlateError, match="CUDA is not available"):
            dryrun_multichip(2)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SlateError, match="torchrun"):
        dryrun_multichip(2)
    assert not dist.is_initialized()


# chip_smoke.py's phase 13 (the distributed eig tier on a 1x1 grid) at a small size
SMALL_DIST_EIG = {"two_stage_n": 96, "small_n": 96, "method_n": 64, "range_k": 8,
                  "band_k": 4, "nb": 8, "solve_nb": 16, "sterf_n": 64}


@pytest.fixture
def one_rank_world():
    """A world of one in this process for the rehearsal; it ends with it."""
    import torch.distributed as dist
    from slate_tpu_torch.parallel import mesh as pmesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    started = not dist.is_initialized()
    yield
    torch.set_num_threads(threads)
    if started:
        pmesh.destroy()


def test_chip_phase_13_rehearsal(one_rank_world):
    import chip_smoke as cs

    res = cs.dist_eig_path("cpu", SMALL_DIST_EIG)
    cs.check_dist_eig_path(res, SMALL_DIST_EIG)
    assert res["grid"].startswith("1x1") and res["world_size"] == 1
    assert set(cs.DIST_EIG_SINGLE) == {k[:-len("_dist_s")] for k in res["times"]
                                       if k.endswith("_dist_s")}
