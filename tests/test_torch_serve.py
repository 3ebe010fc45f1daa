"""The batched solver service of the PyTorch port against the JAX package:
cache keys and hit/miss/evict accounting, the batched drivers (X, perm,
info, reports, escalation), bucketing and padding, the synchronous packer,
and the seeded request stream.

Both packages get the same numpy stacks.  Tolerances: X to 1e-10 relative in
f64 (the same LU / Cholesky / CSNE on different LAPACK builds), 1e-4 relative
in f32 for the mixed-traffic packer; perm, info, report chains, keys, counts
and the request stream exactly.  The port runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu.serve import cache as jcache
from slate_tpu_torch.serve import cache as tcache


@pytest.fixture(autouse=True)
def _fresh_default_caches():
    st.serve.reset_cache()
    sj.serve.reset_cache()
    yield
    st.serve.reset_cache()
    sj.serve.reset_cache()


def _rel(x, ref) -> float:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the cache: keys and accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
@pytest.mark.parametrize("opts", [None, {"solve_report": True},
                                  {"use_fallback_solver": False,
                                   "block_size": 64}])
def test_cache_key_equals_jax(dtype, opts):
    a = np.zeros((4, 16, 16), dtype)
    b = np.zeros((4, 16, 2), dtype)
    want = jcache.ExecutableCache.make_key("gesv_batched", (a, b), opts, True)
    got = tcache.ExecutableCache.make_key(
        "gesv_batched", (torch.from_numpy(a), torch.from_numpy(b)), opts, True)
    assert got == want
    spec = [tcache.TensorSpec((4, 16, 16), torch.from_numpy(a).dtype),
            tcache.TensorSpec((4, 16, 2), dtype)]
    assert tcache.ExecutableCache.make_key("gesv_batched", spec, opts,
                                           True) == want


def test_executable_key_equals_jax():
    for policy_kw in ({}, {"max_batch": 4, "batch_dims": (1, 4)}):
        jp = sj.serve.BucketPolicy(**policy_kw)
        tp = st.serve.BucketPolicy(**policy_kw)
        for n_items in (1, 3, 4, 17):
            want = sj.serve.executable_key(jp, sj.Options(), "gels",
                                           (32, 16, 4), "float32", n_items)
            got = st.serve.executable_key(tp, st.Options(), "gels",
                                          (32, 16, 4), "float32", n_items)
            assert got == want


def _stack(n, batch, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n, n)).astype(dtype)
            + n * np.eye(n, dtype=dtype),
            rng.standard_normal((batch, n, 1)).astype(dtype))


def test_hit_miss_evict_counts_equal_jax():
    """One call sequence through a capacity-2 cache of each package: the
    same hits, misses, evictions and residents after every call."""
    seq = [(2, 8), (2, 8), (3, 8), (2, 13), (2, 8), (2, 13), (3, 8)]
    jc, tc = sj.serve.ExecutableCache(capacity=2), \
        st.serve.ExecutableCache(capacity=2)
    for batch, n in seq:
        a, b = _stack(n, batch, seed=batch * 100 + n)
        sj.serve.gesv_batched(a, b, cache=jc)
        st.serve.gesv_batched(a, b, cache=tc, device="cpu")
        assert tc.stats() == jc.stats(), (batch, n)
        assert tc.last_lookup()["hit"] == jc.last_lookup()["hit"]
    assert tc.stats() == {"hits": 2, "misses": 5, "evictions": 3, "size": 2}


def test_warmup_slots_drop_clear_holds():
    tc = st.serve.ExecutableCache(device="cpu")
    build = st.serve.batched.batched_build("gesv_batched")
    shapes = [((8, 8), np.float32), ((8, 1), torch.float32)]
    assert tc.warmup("gesv_batched", build, shapes, slots=(1, 4)) == 2
    tc.warmup("gesv_batched", build, shapes, slots=(1, 4))
    assert tc.stats() == {"hits": 2, "misses": 2, "evictions": 0, "size": 2}
    key = tc.make_key("gesv_batched",
                      [tcache.TensorSpec((4, 8, 8), np.float32),
                       tcache.TensorSpec((4, 8, 1), np.float32)], None, False)
    assert tc.holds(key) and len(tc) == 2
    tc.drop()                                # entries go, counters stay
    assert not tc.holds(key) and tc.stats()["misses"] == 2
    tc.clear()
    assert tc.stats() == {"hits": 0, "misses": 0, "evictions": 0, "size": 0}
    # the donate bit is dropped on the CPU, as the JAX package drops it
    a, b = _stack(8, 2, 0)
    st.serve.gesv_batched(torch.from_numpy(a), torch.from_numpy(b), cache=tc,
                          donate=True, opts={"use_fallback_solver": False})
    (k,) = tc._table
    assert k[-1] is False


def test_default_cache_and_reset():
    c = st.serve.default_cache()
    assert st.serve.default_cache() is c
    a, b = _stack(8, 2, 0)
    st.serve.posv_batched(a @ a.transpose(0, 2, 1), b, device="cpu")
    assert c.stats()["misses"] == 1
    st.serve.reset_cache()
    assert st.serve.default_cache() is not c


def test_no_cuda_raises_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only rule")
    a, b = _stack(8, 2, 0)
    with pytest.raises(st.SlateError, match="CUDA"):
        st.serve.gesv_batched(a, b)
    with pytest.raises(st.SlateError, match="CUDA"):
        st.serve.ServeQueue(start=False)
    with pytest.raises(st.SlateError, match="CUDA"):
        st.serve.solve_many([("gesv", a[0], b[0])])
    with pytest.raises(st.SlateError, match="CUDA"):
        st.serve.ExecutorPool(1, st.serve.BucketPolicy(), st.Options(),
                              [st.serve.ExecutableCache()])


# ---------------------------------------------------------------------------
# the batched drivers against the JAX package (f64, batch 5)
# ---------------------------------------------------------------------------


def _poison(a, singular_at, nan_at, nan_pos=-1):
    """A zero row + column at 2 in element ``singular_at``, a NaN on the
    diagonal of element ``nan_at`` (the last entry by default: where the
    NaN sits on the pivot path, its info depends on the LAPACK build's
    pivot search, see test_nan_pivot_info_is_build_dependent)."""
    a = a.copy()
    if singular_at is not None:
        a[singular_at, :, 2] = 0.0
        a[singular_at, 2, :] = 0.0
    if nan_at is not None:
        a[nan_at, nan_pos, nan_pos] = np.nan
    return a


def _check_elements(xt, xj, infos, tol=1e-10):
    for i, inf in enumerate(infos):
        if inf == 0:
            assert _rel(xt[i], np.asarray(xj)[i]) <= tol, i


@pytest.mark.parametrize("n", [8, 13])
@pytest.mark.parametrize("poison", [False, True])
def test_gesv_batched_matches_jax(n, poison):
    a, b = _stack(n, 5, seed=n)
    b = np.concatenate([b, 2 * b], axis=-1)
    if poison:
        a = _poison(a, singular_at=1, nan_at=3)
    xj, pj, ij = sj.serve.gesv_batched(a, b)
    xt, pt, it = st.serve.gesv_batched(a, b, device="cpu")
    assert pt.dtype == torch.int64 and it.dtype == torch.int32
    np.testing.assert_array_equal(_np(it), _np(ij))
    np.testing.assert_array_equal(_np(pt), _np(pj))
    _check_elements(xt, xj, _np(ij))
    if poison:
        assert _np(it)[1] > 0 and _np(it)[3] > 0
        assert (_np(it)[[0, 2, 4]] == 0).all()


def test_nan_pivot_info_is_build_dependent():
    """A NaN at (1, 1) of a 13 x 13 element: the JAX package's CPU LU
    passes over the NaN row in its pivot search and reports the last pivot
    (13); the port's (MKL) takes it and reports 2.  Both flag the element,
    and its batchmates agree (ROADMAP.md §C)."""
    a, b = _stack(13, 5, seed=13)
    a = _poison(a, singular_at=1, nan_at=3, nan_pos=1)
    _, _, ij = sj.serve.gesv_batched(a, b)
    xt, _, it = st.serve.gesv_batched(a, b, device="cpu")
    it, ij = _np(it), _np(ij)
    assert it[3] > 0 and ij[3] > 0
    np.testing.assert_array_equal(np.delete(it, 3), np.delete(ij, 3))


@pytest.mark.parametrize("n", [8, 13])
@pytest.mark.parametrize("poison", [False, True])
def test_posv_batched_matches_jax(n, poison):
    g, b = _stack(n, 5, seed=20 + n)
    a = g @ g.transpose(0, 2, 1) + n * np.eye(n)
    if poison:
        a = _poison(a, singular_at=2, nan_at=4)
    xj, ij = sj.serve.posv_batched(a, b[..., 0])
    xt, it = st.serve.posv_batched(a, b[..., 0], device="cpu")
    assert xt.shape == (5, n)                    # a 2-D B comes back 2-D
    np.testing.assert_array_equal(_np(it), _np(ij))
    _check_elements(xt, xj, _np(ij))


@pytest.mark.parametrize("shape", [(26, 13), (8, 13), (13, 13)])
@pytest.mark.parametrize("poison", [False, True])
def test_gels_batched_matches_jax(shape, poison):
    m, n = shape
    rng = np.random.default_rng(m * 31 + n)
    a = rng.standard_normal((5, m, n))
    b = rng.standard_normal((5, m, 2))
    if poison:
        a[1, :, 4] = 0.0                         # rank-deficient: escalates
        a[3, 2, 2] = np.nan
    xj, ij = sj.serve.gels_batched(a, b)
    xt, it = st.serve.gels_batched(a, b, device="cpu")
    assert xt.shape == (5, n, 2)
    np.testing.assert_array_equal(_np(it), _np(ij))
    _check_elements(xt, xj, _np(ij))
    if poison:
        # the NaN element stays failed in both packages; the zero column
        # escalates to the full gels (QR for these shapes: recovered only
        # where the system is wide)
        assert _np(it)[3] != 0
        assert (_np(it)[1] == 0) == (m < n)


def test_batched_info_per_element_without_fallback():
    """With the fallback off, the rung-1 info of each element is its own
    and no element escalates."""
    a, b = _stack(8, 4, seed=5)
    a = _poison(a, singular_at=2, nan_at=None)
    opts = {"use_fallback_solver": False}
    _, _, ij = sj.serve.gesv_batched(a, b, opts)
    _, _, it = st.serve.gesv_batched(a, b, opts, device="cpu")
    np.testing.assert_array_equal(_np(it), _np(ij))
    assert st.serve.last_escalations() == {}


@pytest.mark.parametrize("routine", ["gesv", "posv", "gels"])
def test_solve_report_chains_equal_jax(routine):
    rng = np.random.default_rng(7)
    n = 8
    if routine == "gels":
        a = rng.standard_normal((4, 2 * n, n))
        b = rng.standard_normal((4, 2 * n, 1))
        a[2, :, 3] = 0.0
    else:
        g = rng.standard_normal((4, n, n))
        a = g @ g.transpose(0, 2, 1) + n * np.eye(n) if routine == "posv" \
            else g + n * np.eye(n)
        b = rng.standard_normal((4, n, 1))
        a[2] = 0.0
    name = routine + "_batched"
    *_, rj = getattr(sj.serve, name)(a, b, {"solve_report": True})
    *_, rt = getattr(st.serve, name)(a, b, {"solve_report": True},
                                     device="cpu")
    assert [(r.routine, r.info, r.fallback_chain, r.recovered,
             r.precision_used) for r in rt] == \
        [(r.routine, r.info, r.fallback_chain, r.recovered,
          r.precision_used) for r in rj]
    assert rt[2].fallback_chain == ("batched", "elementwise")


@pytest.mark.parametrize("i", [0, 3])
def test_zero_pivot_fault_recovers_elementwise_like_jax(i):
    a, b = _stack(8, 5, seed=11)
    spec = ("gesv_batched", "zero_pivot")
    with sj.robust.FaultPlan([sj.robust.FaultSpec(*spec, call_index=i)]) as pj:
        xj, _, ij, rj = sj.serve.gesv_batched(a, b, {"solve_report": True})
    with st.robust.FaultPlan([st.robust.FaultSpec(*spec, call_index=i)]) as pt:
        xt, _, it, rt = st.serve.gesv_batched(a, b, {"solve_report": True},
                                              device="cpu")
        esc = st.serve.last_escalations()
    assert pt.fired == pj.fired == (("gesv_batched", "zero_pivot", i),)
    assert [r.fallback_chain for r in rt] == [r.fallback_chain for r in rj]
    assert rt[i].fallback_chain == ("batched", "elementwise")
    assert rt[i].recovered and rt[i].info == 0
    assert esc == {i: {"rungs": ("batched", "elementwise"),
                       "recovered": True}}
    np.testing.assert_array_equal(_np(it), _np(ij))
    assert (_np(it) == 0).all()
    assert _rel(xt, xj) <= 1e-10


def test_ghost_slots_are_inert():
    """Elements past n_real are never checked, escalated or reported —
    even poisoned ones."""
    a, b = _stack(8, 4, seed=13)
    a[3] = np.nan
    opts = {"solve_report": True}
    *_, it, rt = st.serve.gesv_batched(a, b, opts, n_real=3, device="cpu")
    *_, ij, rj = sj.serve.gesv_batched(a, b, opts, n_real=3)
    assert len(rt) == len(rj) == 3
    assert st.serve.last_escalations() == {}
    np.testing.assert_array_equal(_np(it), _np(ij))
    assert all(r.fallback_chain == ("batched",) and r.recovered for r in rt)


def test_start_finish_split_and_device_rule():
    a, b = _stack(8, 3, seed=17)
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    pb = st.serve.start_batched("gesv_batched", A, B)
    assert isinstance(pb, st.serve.PendingBatch)
    assert pb.a0.device.type == "cpu"            # a tensor keeps its device
    payload, info, reports = st.serve.finish_batched(pb)
    assert reports is None and (info == 0).all()
    x_ref = np.linalg.solve(a, b)
    assert _rel(payload[0], x_ref) <= 1e-12
    # a Matrix-free 2-D right-hand side is squeezed back
    xt, _, _ = st.serve.gesv_batched(A, B[..., 0])
    assert xt.shape == (3, 8)


# ---------------------------------------------------------------------------
# bucketing and padding
# ---------------------------------------------------------------------------


GRID = [(r, m, n, k) for r in ("gesv", "posv") for m in (1, 8, 13, 16, 17, 100,
                                                          128, 129, 300)
        for n in (m,) for k in (1, 3, 4, 5, 9)] + \
    [("gels", m, n, k) for m, n in ((26, 13), (8, 13), (16, 16), (160, 80),
                                    (30, 29), (13, 40), (200, 3))
     for k in (1, 4)]


def test_bucket_policy_equals_jax():
    for kw in ({}, {"dims": (8, 24), "nrhs_dims": (2,), "max_batch": 4,
                    "batch_dims": (1, 2, 4)}):
        jp, tp = sj.serve.BucketPolicy(**kw), st.serve.BucketPolicy(**kw)
        for r, m, n, k in GRID:
            assert tp.bucket(r, m, n, k) == jp.bucket(r, m, n, k), (r, m, n, k)
        for nb in range(1, 40):
            assert tp.round_batch(nb) == jp.round_batch(nb)
    with pytest.raises(st.SlateError):
        st.serve.BucketPolicy().bucket("gesv", 8, 9, 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pad_and_unpad_equal_jax(dtype):
    rng = np.random.default_rng(3)
    policy = st.serve.BucketPolicy()
    for r, m, n, k in GRID[::3]:
        a = rng.standard_normal((m, n)).astype(dtype)
        b = rng.standard_normal((m, k)).astype(dtype)
        bucket = policy.bucket(r, m, n, k)
        at, bt = st.serve.pad_request(r, a, b, bucket)
        aj, bj = sj.serve.pad_request(r, a, b, bucket)
        np.testing.assert_array_equal(at, np.asarray(aj))
        np.testing.assert_array_equal(bt, np.asarray(bj))
        assert at.dtype == np.asarray(aj).dtype
        x = rng.standard_normal((bucket[1], bucket[2]))
        np.testing.assert_array_equal(
            st.serve.unpad_result(torch.from_numpy(x), n, k).numpy(),
            np.asarray(sj.serve.unpad_result(x, n, k)))


def test_padding_preserves_solution():
    rng = np.random.default_rng(4)
    for r, (m, n) in (("gesv", (13, 13)), ("gels", (26, 13)),
                      ("gels", (8, 13))):
        a = rng.standard_normal((m, n)) + (n * np.eye(n) if m == n else 0)
        b = rng.standard_normal((m, 2))
        bucket = st.serve.BucketPolicy().bucket(r, m, n, 2)
        ap, bp = st.serve.pad_request(r, a, b, bucket)
        drv = getattr(st.serve, r + "_batched")
        xp = drv(ap[None], bp[None], device="cpu")[0][0]
        x = drv(a[None], b[None], device="cpu")[0][0]
        assert _rel(st.serve.unpad_result(xp, n, 2), x.numpy()) <= 1e-10


# ---------------------------------------------------------------------------
# the seeded stream and the synchronous packer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 9])
def test_make_requests_bit_identical(seed):
    want = sj.serve.make_requests(60, seed=seed)
    got = st.serve.make_requests(60, seed=seed)
    assert len(got) == len(want) == 60
    for (rt, at, bt), (rj, aj, bj) in zip(got, want):
        assert rt == rj
        assert at.dtype == aj.dtype and at.tobytes() == aj.tobytes()
        assert bt.dtype == bj.dtype and bt.tobytes() == bj.tobytes()


def test_solve_many_matches_jax_and_second_pass_hits():
    reqs = st.serve.make_requests(48, seed=9, dims=(8, 13, 24))
    jc = sj.serve.ExecutableCache()
    tc = st.serve.ExecutableCache()
    want = sj.serve.solve_many(reqs, cache=jc)
    got = st.serve.solve_many(reqs, cache=tc, device="cpu")
    assert len(got) == len(want) == 48
    for (r, a, b), (xt, it), (xj, ij) in zip(reqs, got, want):
        assert it == int(ij) == 0
        assert isinstance(xt, torch.Tensor) and xt.device.type == "cpu"
        assert xt.shape == np.asarray(xj).shape == (a.shape[1], b.shape[1])
        assert _rel(xt, xj) <= 1e-4, r
    assert tc.stats() == jc.stats()
    misses = tc.stats()["misses"]
    st.serve.solve_many(reqs, cache=tc, device="cpu")
    assert tc.stats()["misses"] == misses          # all hits
    assert tc.stats()["hits"] >= misses


def test_tensor_operands_take_the_device_route():
    """Tensor operands stay tensors up to the packer, which copies them
    into their slots on the batch's device (the route a request already on
    the card takes); the results equal the numpy route's bit for bit, and
    the keys, flight dtype and pad-waste count read the same."""
    from slate_tpu_torch.serve import queue as tq

    reqs = st.serve.make_requests(24, seed=9, dims=(8, 13, 24))
    # single right-hand sides go in as 1-D tensors
    as_t = [(r, torch.from_numpy(a),
             torch.from_numpy(b[:, 0] if b.shape[1] == 1 else b))
            for r, a, b in reqs]
    policy = st.serve.BucketPolicy()
    for (r, a, b), (_, at, bt) in zip(reqs, as_t):
        key_np, it_np = tq._normalize_request(policy, r, a, b)
        key_t, it_t = tq._normalize_request(policy, r, at, bt)
        assert key_t == key_np and isinstance(it_t.a, torch.Tensor)
        assert it_t.ready is None and it_t.nrhs == it_np.nrhs
    want = st.serve.solve_many(reqs, cache=st.serve.ExecutableCache(),
                               device="cpu")
    got = st.serve.solve_many(as_t, cache=st.serve.ExecutableCache(),
                              device="cpu")
    for (xw, iw), (xg, ig) in zip(want, got):
        assert ig == iw == 0 and torch.equal(xg, xw)
    # one chunk mixing both kinds packs the same slots; the ghost stays I
    a = np.random.default_rng(4).standard_normal((13, 13)) + 13 * np.eye(13)
    b = np.random.default_rng(5).standard_normal((13, 2))
    items = [tq._normalize_request(policy, "gesv", x, y)[1]
             for x, y in ((a, b), (torch.from_numpy(a), torch.from_numpy(b)))]
    bucket = policy.bucket("gesv", 13, 13, 2)
    A, B, _ = st.serve.executor._pack_batch("gesv", bucket, items, 4,
                                            torch.device("cpu"))
    assert torch.equal(A[0], A[1]) and torch.equal(B[0], B[1])
    assert torch.equal(A[0, :13, :13], torch.from_numpy(a))
    assert torch.equal(A[2], torch.eye(bucket[0], dtype=A.dtype))
    assert not B[2].any()


def test_solve_many_unknown_routine_raises():
    a, b = _stack(8, 1, 0)
    with pytest.raises(st.SlateError, match="unknown routine"):
        st.serve.solve_many([("syev", a[0], b[0])], device="cpu")


def test_public_names_cover_the_jax_package():
    assert set(sj.serve.__all__) <= set(st.serve.__all__)
    for name in sj.serve.__all__:
        assert hasattr(st.serve, name), name
    assert st.robust.POINT_SERVE == sj.robust.faults.POINT_SERVE
    assert set(st.obs.__all__) >= {"TimeSeriesSampler", "SLOMonitor", "SLO",
                                   "default_serve_slos", "validate_timeseries"}
