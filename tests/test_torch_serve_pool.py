"""The executor pool of the PyTorch port against the JAX package: routing
and residency on a fixed chunk sequence at N = 2, drain-and-reroute on a
worker crash, equal results across pool sizes at equal batch rounding,
work-stealing, the slot-ladder warm-up, and capacity rescaling — on the CPU.

Residency, counts, routing and typed failures must match the JAX package's
(tests/test_executor.py is the reference behaviour); results across pool
sizes must be bitwise equal within the port.  Every ``result()`` takes a
timeout and every queue is closed by a ``with`` block.
"""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu_torch.serve.executor import SERVE_SITE, executable_key


def _dd(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return a + n * np.eye(n, dtype=np.float32)


def _rhs(n, nrhs=1, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, nrhs)).astype(np.float32)


def _policy(pkg, max_batch=4, batch_dims=(1, 4), max_wait_ms=500.0):
    return pkg.serve.BucketPolicy(max_batch=max_batch,
                                  batch_dims=tuple(batch_dims),
                                  max_wait_ms=max_wait_ms)


def _tqueue(executors, **kw):
    policy_kw = {k: kw.pop(k) for k in ("max_batch", "batch_dims",
                                        "max_wait_ms") if k in kw}
    return st.serve.ServeQueue(policy=_policy(st, **policy_kw),
                               cache=st.serve.ExecutableCache(),
                               executors=executors, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("SLATE_TPU_FLIGHT_PATH", str(tmp_path / "flight.json"))
    st.obs.reset()
    yield
    st.obs.reset()


def _requests(routine, groups, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(groups):
        reqs = []
        for _ in range(4):
            n = 8
            if routine == "gels":
                a = rng.standard_normal((2 * n, n)).astype(np.float32)
                b = rng.standard_normal((2 * n, 1)).astype(np.float32)
            elif routine == "posv":
                g = rng.standard_normal((n, n)).astype(np.float32)
                a = (g @ g.T + n * np.eye(n)).astype(np.float32)
                b = rng.standard_normal((n, 1)).astype(np.float32)
            else:
                a = rng.standard_normal((n, n)).astype(np.float32) \
                    + n * np.eye(n, dtype=np.float32)
                b = rng.standard_normal((n, 1)).astype(np.float32)
            reqs.append((routine, a, b))
        out.append(reqs)
    return out


def _serve_groups(q, groups):
    out = []
    for g in groups:
        ts = [q.submit(r, a, b) for r, a, b in g]
        # await the whole group before offering the next: every pool size
        # sees the same max_batch-sized chunks in the same order
        out.append([t.result(timeout=120.0) for t in ts])
    return out


@pytest.mark.parametrize("routine", ["gesv", "posv", "gels"])
def test_pool_sizes_give_equal_results(routine):
    groups = _requests(routine, 3)
    with _tqueue(1) as q:
        ref = _serve_groups(q, groups)
    for n_ex in (2, 4):
        with _tqueue(n_ex) as q:
            got = _serve_groups(q, groups)
        for gr, gg in zip(ref, got):
            for (xr, ir), (xg, ig) in zip(gr, gg):
                assert ir == ig == 0
                assert torch.equal(xr, xg)         # bitwise, same chunking
    # and the port's per-element solutions agree with the JAX package's
    q = sj.serve.ServeQueue(policy=_policy(sj),
                            cache=sj.serve.ExecutableCache())
    try:
        want = _serve_groups(q, groups)
    finally:
        q.close()
    for gr, gw in zip(ref, want):
        for (xr, ir), (xw, iw) in zip(gr, gw):
            assert ir == int(iw) == 0
            xw = np.asarray(xw)
            assert np.linalg.norm(xr.numpy() - xw) <= 1e-4 * np.linalg.norm(xw)


def _residency_run(pkg, q):
    """Three identical cold->warm chunks of one bucket on an N=2 pool."""
    for _ in range(3):
        ts = [q.submit("gesv", _dd(8, s), _rhs(8)) for s in range(4)]
        for t in ts:
            assert t.result(timeout=120.0)[1] == 0
    c0, c1 = q.pool.caches()
    key = pkg.serve.executable_key(q.policy, q.opts, "gesv",
                                   q.policy.bucket("gesv", 8, 8, 1),
                                   "float32", 4)
    return (c0.stats()["misses"], c0.stats()["hits"], c1.stats()["misses"],
            q.pool.residency(key), sorted({t.executor for t in ts}))


def test_residency_routing_equals_jax():
    with _tqueue(2) as q:
        got = _residency_run(st, q)
    jq = sj.serve.ServeQueue(policy=_policy(sj),
                             cache=sj.serve.ExecutableCache(), executors=2)
    try:
        want = _residency_run(sj, jq)
    finally:
        jq.close()
    assert got == want == (1, 2, 0, (0,), ["ex0"])


def test_slot_ladder_warmup_pins_pool_wide_builds():
    with _tqueue(2, continuous=True) as q:
        assert q.warmup([("gesv", 8, 8, 1)]) == 2
        assert [c.stats()["misses"] for c in q.pool.caches()] == [2, 2]
        for count in (3, 1, 2):
            ts = [q.submit("gesv", _dd(8, s), _rhs(8)) for s in range(count)]
            for t in ts:
                assert t.result(timeout=120.0)[1] == 0
        assert [c.stats()["misses"] for c in q.pool.caches()] == [2, 2]
        key = executable_key(q.policy, q.opts, "gesv", (16, 16, 1),
                             "float32", 3)
        assert q.pool.residency(key) == (0, 1)


def test_backed_up_resident_executor_loses_chunks():
    n = 64
    with _tqueue(2, max_batch=1, batch_dims=(1,), max_wait_ms=0.0,
                 steal_threshold=2) as q:
        bucket = q.policy.bucket("gesv", n, n, 1)
        q.pool.caches()[0].warmup(
            "gesv_batched", st.serve.batched.batched_build("gesv_batched"),
            [((1,) + bucket[:2], np.float32),
             ((1, bucket[0], bucket[2]), np.float32)], q.opts)
        steals0 = q.pool.steals
        # a stall on ex0's first batch backs its queue up behind residency
        with st.robust.FaultPlan([st.robust.FaultSpec(
                SERVE_SITE, "slow_executor", executor=0, delay_s=0.2)]):
            ts = [q.submit("gesv", _dd(n, s), _rhs(n, seed=s))
                  for s in range(40)]
            for t in ts:
                assert t.result(timeout=120.0)[1] == 0
        assert q.pool.steals > steals0
        assert {t.executor for t in ts} == {"ex0", "ex1"}
        c = st.obs.REGISTRY.get("slate_serve_steals_total")
        assert c is not None and sum(c.series().values()) >= 1


def test_worker_crash_drains_and_reroutes():
    flight = st.serve.FlightRecorder(capacity=256, auto_dump_path=None)
    with _tqueue(2, max_wait_ms=2.0, flight=flight) as q:
        with st.robust.FaultPlan([st.robust.FaultSpec(
                SERVE_SITE, "worker_crash", executor=0)]):
            ts = [q.submit("gesv", _dd(8, s), _rhs(8)) for s in range(40)]
            failed = ok = 0
            for t in ts:
                try:
                    _, info = t.result(timeout=60.0)
                    assert info == 0
                    ok += 1
                except st.SlateError as e:
                    assert "worker thread died" in str(e)
                    failed += 1
            # only the chunk in flight on the dying executor fails
            assert 1 <= failed <= 4 and ok == len(ts) - failed
        assert q.capacity_fraction() == 0.5
        assert q.admission.capacity_fraction == 0.5
        t = q.submit("gesv", _dd(8, 99), _rhs(8))
        assert t.result(timeout=60.0)[1] == 0 and t.executor == "ex1"
        assert q.executor_depths().keys() == {"ex0", "ex1"}
    c = st.obs.REGISTRY.get("slate_serve_worker_deaths_total")
    assert any(dict(k).get("executor") == "ex0" for k in c.series())
    recs = [r for r in flight.records() if r.reason == "worker_death"]
    assert recs and all(r.executor == "ex0" and "worker crash" in r.error
                        for r in recs)


def test_last_executor_death_fails_fast():
    """When the last executor dies, the queue turns fail-fast before the
    dying batch's tickets fail, so a submit made right after ``result()``
    raised is refused (the JAX package orders these the other way round,
    which is the race behind its known failure of
    test_worker_death_fails_tickets_fast_and_blocks_submit)."""
    flight = st.serve.FlightRecorder(capacity=64, auto_dump_path=None)
    with _tqueue(1, max_wait_ms=1.0, flight=flight) as q:
        with st.robust.FaultPlan([st.robust.FaultSpec(SERVE_SITE,
                                                      "worker_crash")]):
            t = q.submit("gesv", _dd(8), _rhs(8))
            with pytest.raises(st.SlateError, match="worker thread died"):
                t.result(timeout=30.0)
        with pytest.raises(st.SlateError, match="died"):
            q.submit("gesv", _dd(8, 2), _rhs(8))
        assert q.capacity_fraction() == 0.0
        q.flush(timeout=5.0)                  # returns: nothing in flight
    recs = [r for r in flight.records() if r.reason == "worker_death"]
    assert recs and all("worker crash" in r.error for r in recs)


def test_cache_flush_forces_rebuild_and_keeps_stats():
    with _tqueue(1, max_wait_ms=1.0) as q:
        assert q.submit("gesv", _dd(8), _rhs(8)).result(timeout=60.0)[1] == 0
        with st.robust.FaultPlan([st.robust.FaultSpec(SERVE_SITE,
                                                      "cache_flush")]):
            t = q.submit("gesv", _dd(8, 1), _rhs(8))
            assert t.result(timeout=60.0)[1] == 0
        assert q.cache.stats()["misses"] == 2 and t.cache_hit is False
        c = st.obs.REGISTRY.get("slate_serve_cache_flushes_total")
        assert c is not None


def test_capacity_rescaling_and_pool_validation():
    ctl = st.serve.AdmissionController(st.serve.AdmissionPolicy(
        rate={"best_effort": 100.0}, burst={"best_effort": 10.0}))
    ctl.scale_capacity(0.5)
    ctl.scale_capacity(0.5)                  # idempotent, not 25.0
    assert ctl._buckets["best_effort"].rate == pytest.approx(50.0)
    ctl.scale_capacity(1.0)
    assert ctl._buckets["best_effort"].rate == pytest.approx(100.0)
    with pytest.raises(ValueError):
        ctl.scale_capacity(0.0)
    with pytest.raises(st.SlateError, match="executors"):
        st.serve.ServeQueue(executors=0, start=False, device="cpu")
    with pytest.raises(st.SlateError, match="caches"):
        st.serve.ExecutorPool(2, st.serve.BucketPolicy(), st.Options(),
                              [st.serve.ExecutableCache()], device="cpu")


def test_scale_workload_runs_every_pool_size():
    out = st.serve.run_scale_workload(executor_counts=(1, 2), num_requests=80,
                                      seed=0, dims=(8, 13), device="cpu")
    assert out["executor_counts"] == [1, 2]
    for k in ("1", "2"):
        run = out["runs"][k]
        assert run["bad"] == 0 and run["misses_after_warmup"] == 0
        assert run["executors"] == int(k)
    assert set(out["solves_per_sec"]) == {"1", "2"}


def test_stress_many_submitters_every_ticket_resolves_once():
    """Four executors, eight submitting threads and a shortened switch
    interval: every ticket resolves exactly once with its own solution, and
    the queue's in-flight count returns to zero (a lost update in the
    shared accounting would leave it off or hang flush())."""
    import sys
    import threading

    reqs = st.serve.make_requests(160, seed=21, dims=(8, 13))
    results = [None] * len(reqs)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _tqueue(4, max_wait_ms=1.0, continuous=True) as q:
            def submitter(k):
                for i in range(k, len(reqs), 8):
                    r, a, b = reqs[i]
                    results[i] = q.submit(r, a, b)

            threads = [threading.Thread(target=submitter, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
                assert not t.is_alive()
            got = [t.result(timeout=60.0) for t in results]
            q.flush(timeout=30.0)
            with q._cv:
                assert q._inflight == 0 and not any(q._pending.values())
    finally:
        sys.setswitchinterval(prev)
    for (r, a, b), (x, info) in zip(reqs, got):
        assert info == 0
        ref = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                              rcond=None)[0]
        assert np.linalg.norm(x.numpy() - ref) <= 1e-4 * np.linalg.norm(ref)
    lat = st.obs.REGISTRY.get("slate_serve_latency_seconds")
    assert sum(s["count"] for s in lat.series().values()) == len(reqs)
