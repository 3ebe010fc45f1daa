"""The serving queue of the PyTorch port against the JAX package: admission
decisions under an injected clock, flight records through both packages'
validators, SLO verdicts and time-series documents on the same registry
samples, and the live queue (flush and continuous modes, ghost slots,
typed deadline expiry, SLO-coupled shedding, chaos) on the CPU.

Decisions, verdicts, documents and info codes must be equal; solutions are
checked against numpy at rtol 1e-4 (f32 requests).  Every ``result()`` takes
a timeout and every queue is closed by its ``with`` block.
"""

import json
import time

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu.serve import admission as ja
from slate_tpu_torch.serve import admission as ta


def _dd(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return a + n * np.eye(n, dtype=np.float32)


def _rhs(n, nrhs=1, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, nrhs)).astype(np.float32)


def _queue(**kw):
    kw.setdefault("cache", st.serve.ExecutableCache())
    kw.setdefault("flight", st.serve.FlightRecorder(auto_dump_path=None))
    return st.serve.ServeQueue(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _fresh_registries(tmp_path, monkeypatch):
    # exhausted ladders auto-dump the flight ring: keep the file in tmp
    monkeypatch.setenv("SLATE_TPU_FLIGHT_PATH", str(tmp_path / "flight.json"))
    st.obs.reset()
    yield
    st.obs.reset()


class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# admission: the same decisions under one injected clock
# ---------------------------------------------------------------------------


def _decisions(mod, policy_kw, script):
    clock = _Clock()
    ctl = mod.AdmissionController(mod.AdmissionPolicy(**policy_kw),
                                  clock=clock)
    out = []
    for step in script:
        kind = step[0]
        if kind == "tick":
            clock.t += step[1]
        elif kind == "admit":
            _, lane, depth, inflight = step
            try:
                ctl.admit(lane, depth, inflight)
                out.append("ok")
            except Exception as e:                       # noqa: BLE001
                out.append((type(e).__name__, getattr(e, "reason", None),
                            round(getattr(e, "retry_after_s", 0.0), 9)))
        elif kind == "verdicts":
            out.append(ctl.consume_verdicts(step[1]))
        elif kind == "scale":
            ctl.scale_capacity(step[1])
        elif kind == "escalate":
            out.append(ctl.escalations.take(step[1]))
    return out


ADMISSION_SCRIPTS = {
    "depth_and_inflight": (
        {"max_depth": {"best_effort": 2, "batch": 3}, "max_in_flight": 5},
        [("admit", "best_effort", 1, 0), ("admit", "best_effort", 2, 0),
         ("admit", "batch", 2, 4), ("admit", "batch", 3, 0),
         ("admit", "interactive", 10, 5), ("admit", "interactive", 10, 4)]),
    "token_bucket": (
        {"rate": {"best_effort": 4.0}, "burst": {"best_effort": 2.0}},
        [("admit", "best_effort", 0, 0)] * 3 + [("tick", 0.25)]
        + [("admit", "best_effort", 0, 0)] * 2 + [("tick", 10.0)]
        + [("admit", "best_effort", 0, 0)] * 3
        + [("scale", 0.5), ("tick", 0.25), ("admit", "best_effort", 0, 0),
           ("tick", 0.25), ("admit", "best_effort", 0, 0),
           ("admit", "interactive", 0, 0)]),
    "slo_shedding": (
        {"slo_lanes": {"batch_p99": "batch"}},
        [("verdicts", ["warning"]), ("admit", "best_effort", 0, 0),
         ("admit", "batch", 0, 0),
         ("verdicts", [type("V", (), {"verdict": "breach",
                                      "name": "batch_p99"})()]),
         ("admit", "best_effort", 0, 0), ("admit", "batch", 0, 0),
         ("verdicts", [type("V", (), {"verdict": "breach",
                                      "name": "other"})()]),
         ("admit", "batch", 0, 0), ("admit", "interactive", 0, 0),
         ("verdicts", ["ok"]), ("admit", "best_effort", 0, 0)]),
    "escalation_budget": (
        {"max_escalations_per_window": 3, "escalation_window_s": 1.0},
        [("escalate", 2), ("escalate", 2), ("escalate", 5), ("tick", 0.5),
         ("escalate", 1), ("tick", 0.6), ("escalate", 5), ("escalate", 1)]),
}


@pytest.mark.parametrize("name", sorted(ADMISSION_SCRIPTS))
def test_admission_decisions_equal_jax(name):
    policy_kw, script = ADMISSION_SCRIPTS[name]
    got = _decisions(ta, policy_kw, script)
    want = _decisions(ja, policy_kw, script)
    assert got == want
    assert any(d != "ok" for d in got)        # each script exercises a shed


def test_token_bucket_and_policy_validation_equal_jax():
    for mod in (ta, ja):
        b = mod.TokenBucket(rate=10.0, burst=100.0, clock=lambda: 0.0)
        assert b.try_take(100.0, now=0.0)
        b.set_rate(1.0, now=1.0)
        assert b.tokens(now=2.0) == pytest.approx(11.0)
        assert b.retry_after_s(20.0, now=2.0) == pytest.approx(9.0)
        for bad in ({"rate": {"vip": 1.0}}, {"rate": {"batch": 0.0}},
                    {"burst": {"batch": 1.0}}):
            with pytest.raises(ValueError):
                mod.AdmissionPolicy(**bad)
    assert ta.LANES == ja.LANES and ta.DEFAULT_LANE == ja.DEFAULT_LANE
    for verdicts in (["warning"], ["breach"], ["ok", "no_data"]):
        assert ta.shed_lanes_from_verdicts(verdicts, ta.AdmissionPolicy()) == \
            ja.shed_lanes_from_verdicts(verdicts, ja.AdmissionPolicy())


# ---------------------------------------------------------------------------
# flight records and SLO / time-series documents
# ---------------------------------------------------------------------------


def _record(mod, i):
    return mod.FlightRecord(
        trace_id=f"gesv-1-{i:06d}", routine="gesv", bucket="16x16x1",
        dtype="float32", t_submit_unix=1.0e9 + i,
        stages={"submit": 1e-5, "queue_wait": 2e-3, "execute": 1e-3},
        info=0 if i % 2 else 3, cache_hit=bool(i % 2), batch=4,
        occupancy=0.75, ladder=("batched", "elementwise") if i == 2 else (),
        exhausted=i == 2, error=None, lane="batch",
        reason="deadline" if i == 3 else None, executor="ex1")


def test_flight_records_pass_both_validators(tmp_path):
    docs = {}
    for name, mod in (("torch", st.serve), ("jax", sj.serve)):
        rec = mod.FlightRecorder(capacity=3,
                                 auto_dump_path=str(tmp_path / f"{name}.json"))
        for i in range(5):
            rec.record(_record(mod, i))
        assert len(rec) == 3
        path = rec.on_exhaustion(rec.records()[-1])
        docs[name] = json.load(open(path))
    for doc in docs.values():
        st.serve.validate_flight(doc)
        sj.serve.validate_flight(doc)
    for key in ("schema", "reason", "capacity", "records"):
        assert docs["torch"][key] == docs["jax"][key]
    with pytest.raises(ValueError):
        st.serve.validate_flight({"schema": "other", "records": []})


def _feed(obs_mod, reg):
    """The same counters/histograms in both packages' registries, sampled
    into windows at explicit timestamps."""
    sampler = obs_mod.TimeSeriesSampler(registry=reg, interval_s=1.0)
    sampler.sample(now=100.0)
    buckets = st.serve.executor._STAGE_BUCKETS
    h = reg.histogram("slate_serve_latency_seconds", "", buckets=buckets)
    for k in range(200):
        h.observe(0.001 * (1 + k % 7), routine="gesv", lane="interactive")
        h.observe(2.0 if k % 9 == 0 else 0.004, routine="posv",
                  lane="batch")
    reg.counter("slate_serve_requests_total").inc(400, routine="gesv")
    reg.counter("slate_serve_worker_errors_total").inc(9, routine="gesv")
    reg.counter("slate_serve_cache_hits_total").inc(50, routine="gesv")
    reg.counter("slate_serve_cache_misses_total").inc(4, routine="gesv")
    sampler.sample(now=101.0)
    reg.counter("slate_serve_cache_hits_total").inc(200, routine="gesv")
    for _ in range(30):
        h.observe(0.9, routine="gels", lane="interactive")
    sampler.sample(now=102.5)
    mon = obs_mod.SLOMonitor(obs_mod.default_serve_slos(
        p99_latency_s=0.5, warmup_windows=1), sampler, registry=reg)
    return sampler, mon.evaluate()


def test_slo_verdicts_and_timeseries_equal_jax():
    ts, tv = _feed(st.obs, st.obs.MetricsRegistry())
    js, jv = _feed(sj.obs, sj.obs.MetricsRegistry())
    assert [v.to_dict() for v in tv] == [v.to_dict() for v in jv]
    assert {v.verdict for v in tv} >= {"ok", "breach"}
    tw, jw = ts.windows(), js.windows()
    assert tw == jw
    tdoc = ts.collect(source="test", slos=[v.to_dict() for v in tv])
    jdoc = js.collect(source="test", slos=[v.to_dict() for v in jv])
    for doc in (tdoc, jdoc):
        st.obs.validate_timeseries(doc)
        sj.obs.validate_timeseries(doc)
    assert tdoc["windows"] == jdoc["windows"] and tdoc["slos"] == jdoc["slos"]
    with pytest.raises(ValueError):
        st.obs.validate_timeseries(dict(tdoc, interval_s=0))


def test_obs_reset_clears_slo_state():
    reg = st.obs.REGISTRY
    sampler = st.obs.TimeSeriesSampler(interval_s=1.0)
    sampler.sample(now=0.0)
    st.obs.counter("slate_serve_requests_total").inc(5, routine="gesv")
    sampler.sample(now=1.0)
    st.obs.SLOMonitor(st.obs.default_serve_slos(), sampler).evaluate()
    assert reg.get("slate_slo_status") is not None
    st.obs.reset()
    assert reg.get("slate_slo_status") is None
    assert reg.get("slate_serve_requests_total") is None


# ---------------------------------------------------------------------------
# the live queue on the CPU
# ---------------------------------------------------------------------------


def _mixed(n_req, seed):
    return st.serve.make_requests(n_req, seed=seed, dims=(8, 13, 24))


def _check_solutions(reqs, results):
    for (r, a, b), (x, info) in zip(reqs, results):
        assert info == 0
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        ref = np.linalg.lstsq(a64, b64, rcond=None)[0]
        assert np.linalg.norm(x.numpy() - ref) <= 1e-4 * np.linalg.norm(ref)


@pytest.mark.parametrize("continuous", [False, True])
def test_queue_serves_mixed_traffic(continuous):
    reqs = _mixed(60, seed=5)
    with _queue(continuous=continuous) as q:
        q.warmup(sorted({(r, a.shape[0], a.shape[1], b.shape[1])
                         for r, a, b in reqs}), dtype=torch.float32)
        misses = q.cache.stats()["misses"]
        tickets = [q.submit(r, a, b) for r, a, b in reqs]
        results = [t.result(timeout=60.0) for t in tickets]
        q.flush(timeout=30.0)
        assert q.cache.stats()["misses"] == misses     # zero after warm-up
    _check_solutions(reqs, results)
    for t in tickets:
        assert t.executor == "ex0" and t.cache_hit is True
        assert set(t.stages) >= {"submit", "queue_wait", "pad", "cache",
                                 "execute", "resolve"}
    c = st.obs.REGISTRY.get("slate_serve_requests_total")
    assert sum(c.series().values()) == 60


def test_continuous_flush_equal_results_and_joins():
    """Continuous and flush modes give the same per-element results at equal
    slot capacity; a closed-loop burst in continuous mode joins staged
    dispatches."""
    reqs = [("gesv", _dd(8, s), _rhs(8, seed=s)) for s in range(4)]
    policy = st.serve.BucketPolicy(max_batch=4, batch_dims=(4,),
                                   max_wait_ms=200.0)
    out = {}
    for cont in (False, True):
        with _queue(policy=policy, continuous=cont) as q:
            out[cont] = [t.result(timeout=60.0)
                         for t in [q.submit(*r) for r in reqs]]
    for (xf, i_f), (xc, ic) in zip(out[False], out[True]):
        assert i_f == ic == 0 and torch.equal(xf, xc)
    stats = st.serve.run_mixed_workload(120, seed=2, dims=(8, 13),
                                        continuous=True, device="cpu",
                                        return_tickets=True)
    assert stats["bad"] == 0 and stats["misses_after_warmup"] == 0
    assert stats["slot_joins"] == sum(t.slot_joined
                                      for t in stats["tickets"])


def test_ghost_slots_inert_through_the_queue():
    """A chunk of 3 in a 4-slot batch: the identity ghost is never
    reported, escalated or billed, and a singular real element escalates
    alone."""
    sing = _dd(8, 3)
    sing[:, 2] = sing[2, :] = 0.0
    policy = st.serve.BucketPolicy(max_batch=4, batch_dims=(4,),
                                   max_wait_ms=50.0)
    with _queue(policy=policy) as q:
        ts = [q.submit("gesv", a, _rhs(8)) for a in (_dd(8, 1), sing,
                                                     _dd(8, 2))]
        res = [t.result(timeout=60.0) for t in ts]
        q.flush(timeout=30.0)
    assert [i for _, i in res] == [0, 3, 0]
    assert ts[1].ladder == ("batched", "elementwise") and ts[1].exhausted
    assert ts[0].ladder == ts[2].ladder == ()
    h = st.obs.REGISTRY.get("slate_serve_batch_occupancy")
    assert h is not None
    c = st.obs.REGISTRY.get("slate_robust_fallbacks_total")
    assert sum(c.series().values()) == 1               # the one real failure


def test_deadline_expiry_typed_like_jax():
    flight = st.serve.FlightRecorder(auto_dump_path=None)
    with _queue(flight=flight) as q:
        with st.robust.FaultPlan([st.robust.FaultSpec(
                st.serve.SERVE_SITE, "slow_executor", call_index=0,
                delay_s=0.3)]):
            t_slow = q.submit("gesv", _dd(8, 1), _rhs(8))
            time.sleep(0.05)
            t = q.submit("gesv", _dd(8, 2), _rhs(8), lane="best_effort",
                         deadline=0.05)
            assert t_slow.result(timeout=30.0)[1] == 0
            with pytest.raises(st.DeadlineExceededError) as ei:
                t.result(timeout=30.0)
    e = ei.value
    assert (e.lane, e.deadline_s) == ("best_effort", pytest.approx(0.05))
    assert e.elapsed_s >= 0.05
    assert type(e).__name__ == sj.core.exceptions.DeadlineExceededError.__name__
    (rec,) = [r for r in flight.records() if r.reason == "deadline"]
    assert rec.lane == "best_effort"
    with _queue(start=False) as q:
        q.submit("gesv", _dd(8, 1), _rhs(8), lane="interactive")
        t = q.submit("gesv", _dd(24, 2), _rhs(24), lane="best_effort",
                     deadline=0.05)
        with q._cv:
            swept = q._sweep_expired_locked(t.t_deadline + 1.0)
        assert [it.ticket for _, it in swept] == [t]
        q._expire(*swept[0])
        with pytest.raises(st.DeadlineExceededError):
            t.result(timeout=0)
        assert q.lane_depths() == {"interactive": 1}


def test_lane_order_and_submit_validation():
    with _queue(start=False) as q:
        q.submit("gesv", _dd(8, 1), _rhs(8), lane="best_effort")
        q.submit("gesv", _dd(24, 2), _rhs(24), lane="batch")
        q.submit("gesv", _dd(13, 3), _rhs(13), lane="interactive")
        ready = q._ready_keys(time.perf_counter() + 10.0)
        assert [k[0] for k in ready] == ["interactive", "batch",
                                         "best_effort"]
        with pytest.raises(st.SlateError):
            q.submit("gesv", _dd(8), _rhs(8), lane="vip")
        with pytest.raises(st.SlateError):
            q.submit("gesv", _dd(8), _rhs(8), deadline=-1.0)
    with pytest.raises(st.SlateError, match="closed"):
        q.submit("gesv", _dd(8), _rhs(8))


def test_depth_shed_and_slo_coupled_shed():
    flight = st.serve.FlightRecorder(auto_dump_path=None)
    with _queue(admission=st.serve.AdmissionPolicy(
            max_depth={"best_effort": 1}), start=False, flight=flight) as q:
        q.submit("gesv", _dd(8, 1), _rhs(8), lane="best_effort")
        with pytest.raises(st.QueueOverloadError) as ei:
            q.submit("gesv", _dd(8, 2), _rhs(8), lane="best_effort")
        assert (ei.value.lane, ei.value.reason) == ("best_effort", "depth")
        (rec,) = [r for r in flight.records() if r.reason == "shed"]
        assert "QueueOverloadError" in rec.error

    sampler = st.obs.TimeSeriesSampler(interval_s=1.0)
    sampler.sample(now=0.0)
    h = st.obs.histogram("slate_serve_latency_seconds", "",
                         buckets=st.serve.executor._STAGE_BUCKETS)
    for _ in range(100):
        h.observe(50.0, routine="gesv", lane="interactive")
    sampler.sample(now=1.0)
    mon = st.obs.SLOMonitor([st.obs.SLO(
        name="interactive_p99", kind="latency",
        metric="slate_serve_latency_seconds",
        labels=(("lane", "interactive"),), objective=0.5, windows=100)],
        sampler)
    with _queue(start=False, admission=st.serve.AdmissionPolicy(
            slo_refresh_s=0.0)) as q:
        q.attach_slo(mon)
        with pytest.raises(st.QueueOverloadError) as ei:
            q.submit("gesv", _dd(8), _rhs(8), lane="batch")
        assert ei.value.reason == "slo_breach"
        t = q.submit("gesv", _dd(8), _rhs(8), lane="interactive")
        assert not t.done()
        assert q.slo_status() == {"interactive_p99": 2}


def test_trace_stitches_a_request_and_escalation_cap():
    st.trace.on()
    try:
        with _queue(admission=st.serve.AdmissionPolicy(
                max_escalations_per_window=0)) as q:
            sing = _dd(8, 3)
            sing[:, 2] = sing[2, :] = 0.0
            ok = q.submit("gesv", _dd(8, 1), _rhs(8))
            bad = q.submit("gesv", sing, _rhs(8))
            assert ok.result(timeout=60.0)[1] == 0
            with pytest.raises(st.SingularMatrixError):
                bad.result(timeout=60.0)
            q.flush(timeout=30.0)
        events = list(st.trace._events)
    finally:
        st.trace.off()
        st.trace._events.clear()
    mine = {e["name"] for e in events
            if e.get("args", {}).get("trace_id") == ok.trace_id}
    assert {"serve.submit", "serve.queue_wait", "serve.pad", "serve.cache",
            "serve.execute", "serve.resolve"} <= mine
    assert bad.exhausted
