"""Synthetic mixed-workload generator + the serving-throughput measurement.

The serving axis: not GFLOP/s on one n=16384 problem, but solves/sec and
p50/p99 latency under thousands of small heterogeneous requests — the shape
of real serving traffic.  ``make_requests`` draws a seeded stream of small
gesv/posv/gels problems across ≥4 shape buckets (the JAX package's numpy
arrays, bit for bit, for a seed); ``run_mixed_workload`` pushes them through
the serving queue (warm-up pass first, so the measured pass exercises the
steady state: zero builds, warm cache) and reports throughput + latency
percentiles + cache and occupancy statistics.  ``chip_smoke.py``'s serve
phase runs it on the card.

``run_overload_workload`` is the chaos sibling: it first *measures* the
queue's capacity (a warm calibration burst), then drives seeded
heavy-tailed arrivals at ``capacity_factor``× that rate across the three
priority lanes, with deadlines on interactive traffic and an
:class:`~slate_tpu_torch.serve.admission.AdmissionPolicy` that bounds the
lanes; its contract: interactive p99 SLO non-breach, shedding lands on the
right lanes with typed errors, zero hung tickets, a flight record for every
rejection.

Every runner takes ``device`` (default ``cuda``; ``"cpu"`` serves on the
CPU) and passes it to the queue.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.exceptions import (DeadlineExceededError, NumericalError,
                               QueueOverloadError, SlateError)
from ..core.types import Options
from .admission import AdmissionPolicy, DEFAULT_LANE, LANES
from .cache import ExecutableCache
from .flight import FlightRecorder
from .queue import BucketPolicy, ServeQueue, solve_many

#: default mixed-traffic dimension pool — spans 4+ policy buckets
#: (<=16, <=32, <=64, <=96) with off-bucket sizes so padding really runs
DEFAULT_DIMS = (8, 13, 24, 30, 48, 60, 80)
DEFAULT_ROUTINES = ("gesv", "posv", "gels")


def make_requests(num: int = 1000, seed: int = 0,
                  dims: Sequence[int] = DEFAULT_DIMS,
                  routines: Sequence[str] = DEFAULT_ROUTINES,
                  nrhs_pool: Sequence[int] = (1, 4),
                  dtype=np.float32) -> List[Tuple[str, Any, Any]]:
    """A seeded stream of well-posed small solve requests.

    gesv: diagonally-dominant square systems; posv: SPD (Gram + shift);
    gels: tall (2n x n) least squares.  Returns ``(routine, a, b)`` triples
    in arrival order."""
    rng = np.random.default_rng(seed)
    reqs: List[Tuple[str, Any, Any]] = []
    for _ in range(num):
        routine = routines[rng.integers(len(routines))]
        n = int(dims[rng.integers(len(dims))])
        nrhs = int(nrhs_pool[rng.integers(len(nrhs_pool))])
        if routine == "gels":
            m = 2 * n
            a = rng.standard_normal((m, n)).astype(dtype)
        else:
            m = n
            a = rng.standard_normal((n, n)).astype(dtype)
            if routine == "posv":
                a = (a @ a.T + n * np.eye(n)).astype(dtype)
            else:
                a = a + n * np.eye(n, dtype=dtype)
        b = rng.standard_normal((m, nrhs)).astype(dtype)
        reqs.append((routine, a, b))
    return reqs


def _percentile_ms(lat_s: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(lat_s), q) * 1e3)


def _finite(x) -> bool:
    """All entries finite (one device->host read for a tensor on the card)."""
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.all(np.isfinite(np.asarray(x))))


def _pool_cache_stats(q: ServeQueue) -> Dict[str, int]:
    """Hit/miss/eviction totals summed across every executor's cache —
    the pool-wide version of ``ExecutableCache.stats()`` (identical to it
    at ``executors=1``, where the pool serves from the queue's own
    cache)."""
    agg = {"hits": 0, "misses": 0, "evictions": 0, "size": 0}
    for c in q.pool.caches():
        s = c.stats()
        for k in agg:
            agg[k] += s[k]
    return agg


def run_mixed_workload(num_requests: int = 1000, seed: int = 0,
                       policy: Optional[BucketPolicy] = None,
                       opts: Optional[Options] = None,
                       dims: Sequence[int] = DEFAULT_DIMS,
                       routines: Sequence[str] = DEFAULT_ROUTINES,
                       use_queue: bool = True,
                       warm: bool = True,
                       check: bool = True,
                       flight: Optional[FlightRecorder] = None,
                       return_tickets: bool = False,
                       executors: int = 1,
                       after_warmup: Optional[Callable[[ServeQueue], None]]
                       = None,
                       continuous: bool = False,
                       pace_rate: Optional[float] = None,
                       lane: str = DEFAULT_LANE,
                       device=None) -> Dict[str, Any]:
    """Generate, warm up, and serve a mixed workload; return the stats dict.

    Two passes over the same request stream: the warm-up pass prepares every
    (routine, shape bucket, batch bucket) program (via the queue's
    ``warmup`` sweep — deterministic, flush-split-independent), then the
    measured pass times steady-state serving.  ``use_queue=True`` routes
    through the async :class:`ServeQueue` (latency includes queue wait);
    False uses the synchronous :func:`solve_many` packer.  ``check=True``
    verifies every request's info == 0 and result finite.

    Telemetry hooks: ``flight`` hands the queue a specific
    :class:`FlightRecorder`; ``after_warmup(q)`` runs between the warm-up
    sweep and the measured pass (start a sampler / enable tracing / open a
    profiler there, so warm-up builds stay out of the steady-state windows);
    ``return_tickets=True`` adds the queue pass's tickets to the stats
    (trace-stitch checks need their trace ids and stage maps).

    ``executors=N`` serves through an N-executor pool (the serve_scale
    axis); cache stats and the zero-miss-after-warmup gate aggregate
    across every executor's cache.

    The continuous-batching A/B axis: ``continuous=True`` runs the queue
    with rolling admission (eager dispatch + slot joins); ``pace_rate``
    (requests/sec) replaces the closed-loop submit burst with seeded
    exponential inter-arrivals — the open-loop shape where queue_wait
    differences between the two flush disciplines are visible; ``lane``
    submits every request on that priority lane.  The stats then carry
    ``queue_wait_p50_ms``/``queue_wait_p99_ms`` (submit -> batch start)
    and ``slot_joins``/``slot_join_rate``."""
    policy = policy or BucketPolicy()
    opts = Options.make(opts)
    cache = ExecutableCache()
    reqs = make_requests(num_requests, seed, dims=dims, routines=routines)
    combos = sorted({(r, a.shape[0], a.shape[1], b.shape[1])
                     for r, a, b in reqs})

    q = ServeQueue(policy=policy, opts=opts, cache=cache, start=use_queue,
                   flight=flight, executors=executors,
                   continuous=continuous, device=device)
    warm_stats = None
    if warm:
        t0 = time.perf_counter()
        q.warmup(combos, dtype=reqs[0][1].dtype)
        warm_stats = {"seconds": round(time.perf_counter() - t0, 3),
                      **_pool_cache_stats(q)}
    pool0 = _pool_cache_stats(q)
    miss0, hit0 = pool0["misses"], pool0["hits"]
    if after_warmup is not None:
        after_warmup(q)

    t0 = time.perf_counter()
    latencies: List[float] = []
    tickets: List[Any] = []
    if use_queue:
        if pace_rate:
            # open-loop arrivals: seeded exponential gaps at the target
            # rate — closed-loop bursts hide flush-window waits because
            # every bucket fills instantly
            gap_rng = np.random.default_rng(seed + 1)
            gaps = gap_rng.exponential(1.0 / float(pace_rate),
                                       size=len(reqs))
            t_next = time.perf_counter()
            for (r, a, b), gap in zip(reqs, gaps):
                pause = t_next - time.perf_counter()
                if pause > 0:
                    time.sleep(pause)
                tickets.append(q.submit(r, a, b, lane=lane))
                t_next += gap
        else:
            tickets = [q.submit(r, a, b, lane=lane) for r, a, b in reqs]
        results = [t.result(timeout=300.0) for t in tickets]
        latencies = [t.latency_s for t in tickets]
    else:
        items = solve_many(reqs, opts=opts, policy=policy, cache=cache,
                           flight=flight, device=q.device)
        results = list(items)
    wall = time.perf_counter() - t0
    q.close()

    bad = 0
    for x, info in results:
        if int(info) != 0 or not _finite(x):
            bad += 1
    if check and bad:
        raise AssertionError(f"serve workload: {bad}/{len(results)} requests "
                             "returned nonzero info or non-finite results")

    buckets = sorted({"x".join(map(str, policy.bucket(r, a.shape[0],
                                                      a.shape[1], b.shape[1])))
                      for r, a, b in reqs})
    pool1 = _pool_cache_stats(q)
    stats: Dict[str, Any] = {
        "requests": len(reqs),
        "wall_s": round(wall, 4),
        "solves_per_sec": round(len(reqs) / wall, 1),
        "distinct_buckets": len(buckets),
        "buckets": buckets,
        "routines": sorted(set(r for r, _, _ in reqs)),
        "bad": bad,
        "executors": int(executors),
        "steals": q.pool.steals,
        "cache": pool1,
        "misses_after_warmup": pool1["misses"] - miss0,
        "hits_measured": pool1["hits"] - hit0,
        "warmup": warm_stats,
        "continuous": bool(continuous),
        "pace_rate": None if not pace_rate else round(float(pace_rate), 1),
    }
    if tickets:
        qw = [t.stages.get("queue_wait") for t in tickets]
        qw = [w for w in qw if w is not None]
        if qw:
            stats["queue_wait_p50_ms"] = round(_percentile_ms(qw, 50), 3)
            stats["queue_wait_p99_ms"] = round(_percentile_ms(qw, 99), 3)
        joins = sum(1 for t in tickets if t.slot_joined)
        stats["slot_joins"] = joins
        stats["slot_join_rate"] = round(joins / max(len(tickets), 1), 4)
    if latencies:
        stats["p50_ms"] = round(_percentile_ms(latencies, 50), 3)
        stats["p99_ms"] = round(_percentile_ms(latencies, 99), 3)
    else:
        # solve_many path: per-request latency is the packed batch's wall
        # time, recorded on each ticket by the runner — not collected here
        stats["p50_ms"] = stats["p99_ms"] = None
    if return_tickets:
        stats["tickets"] = tickets
    return stats


#: overload-mode lane mix: mostly interactive+batch, a best-effort tail —
#: the shape where the shed ladder must land on the right lanes
DEFAULT_LANE_MIX = (("interactive", 0.35), ("batch", 0.35),
                    ("best_effort", 0.30))


def default_overload_admission(capacity: float) -> AdmissionPolicy:
    """The overload contract the soak runs under, sized from *measured*
    capacity: shallow bounded lanes (deepest for batch, shallowest for
    best-effort) and a best-effort token bucket at 25% of capacity — under
    ``>=2x`` overload the best-effort lane MUST shed while interactive's
    demand share stays under what the queue can serve."""
    return AdmissionPolicy(
        max_depth={"interactive": 512, "batch": 1024, "best_effort": 64},
        max_in_flight=4096,
        rate={"best_effort": max(0.25 * capacity, 1.0)},
        burst={"best_effort": max(0.25 * capacity, 8.0)},
    )


def measure_capacity(q: ServeQueue, reqs: Sequence[Tuple[str, Any, Any]],
                     opts: Optional[Options] = None) -> float:
    """Warm-path solves/sec of this queue's policy+cache on ``reqs`` — the
    calibration burst the overload arrival rate is sized from (synchronous
    ``solve_many``: no queue waits, pure serve throughput)."""
    t0 = time.perf_counter()
    solve_many(reqs, opts=opts or q.opts, policy=q.policy, cache=q.cache,
               device=q.device)
    return len(reqs) / max(time.perf_counter() - t0, 1e-9)


def run_overload_workload(duration_s: float = 15.0, seed: int = 0,
                          policy: Optional[BucketPolicy] = None,
                          opts: Optional[Options] = None,
                          dims: Sequence[int] = (8, 13, 24),
                          routines: Sequence[str] = DEFAULT_ROUTINES,
                          admission: Optional[AdmissionPolicy] = None,
                          capacity_factor: float = 2.0,
                          lane_mix: Sequence[Tuple[str, float]]
                          = DEFAULT_LANE_MIX,
                          deadlines: Optional[Dict[str, float]] = None,
                          calibrate_requests: int = 150,
                          max_requests: int = 20_000,
                          pool: int = 400,
                          flight: Optional[FlightRecorder] = None,
                          after_warmup: Optional[Callable[[ServeQueue], None]]
                          = None,
                          drain_timeout_s: float = 60.0,
                          executors: int = 1,
                          continuous: bool = False,
                          device=None) -> Dict[str, Any]:
    """Drive the serving queue past its measured capacity; return the tally.

    Three phases: (1) warm up every executable and *measure* capacity with
    a synchronous burst; (2) replay a seeded, heavy-tailed (Pareto
    inter-arrival) open-loop arrival process at ``capacity_factor`` × that
    capacity for ``duration_s``, each request assigned a lane by
    ``lane_mix`` and a deadline by ``deadlines`` (default: interactive
    carries a budget, lower lanes run without); (3) drain, then classify
    every submitted request exactly once: served ok / numerically failed /
    shed (:class:`QueueOverloadError`, counted per lane+reason) / expired
    (:class:`DeadlineExceededError`) / worker-failed / hung (result still
    pending after the drain — the contract says this must be zero).

    ``after_warmup(q)`` runs between calibration and the overload pass
    (attach the SLO monitor / start the sampler there).  The returned stats
    carry the measured capacity, the offered rate, per-lane submit/shed/
    expire/ok counts, latency p50/p99 per lane, and ``hung``.

    ``executors=N`` serves through an N-executor pool; nominal capacity
    (and the offered rate sized from it) scales by N, and the arrival loop
    RE-calibrates mid-run when the pool shrinks — a chaos-killed executor
    drops :meth:`ServeQueue.capacity_fraction`, the offered rate follows,
    and ``recalibrations`` counts the adjustments.

    ``continuous=True`` runs the same soak under rolling admission — the
    overload contract (typed shedding, zero hung, deadline expiry) must
    hold regardless of flush discipline."""
    policy = policy or BucketPolicy()
    opts = Options.make(opts)
    cache = ExecutableCache()
    rng = np.random.default_rng(seed)
    reqs = make_requests(pool, seed, dims=dims, routines=routines)
    combos = sorted({(r, a.shape[0], a.shape[1], b.shape[1])
                     for r, a, b in reqs})

    warm_q = ServeQueue(policy=policy, opts=opts, cache=cache, start=False,
                        device=device)
    t0 = time.perf_counter()
    warm_q.warmup(combos, dtype=reqs[0][1].dtype)
    warmup_s = time.perf_counter() - t0
    warm_q.close()
    # single-executor warm throughput; the pool's nominal capacity scales
    # linearly with N (recalibrated live by capacity_fraction below)
    capacity1 = measure_capacity(warm_q, reqs[:calibrate_requests], opts=opts)
    capacity = capacity1 * int(executors)

    admission = admission or default_overload_admission(capacity)
    q = ServeQueue(policy=policy, opts=opts, cache=cache, flight=flight,
                   admission=admission, executors=executors,
                   continuous=continuous, device=device)
    if int(executors) > 1:
        # the extra executors' caches are cold — warm them too, before the
        # measured window opens (executor 0 re-warms as pure hits)
        q.warmup(combos, dtype=reqs[0][1].dtype)
    if after_warmup is not None:
        after_warmup(q)

    lanes, weights = zip(*lane_mix)
    weights = np.asarray(weights, float) / sum(w for _, w in lane_mix)
    deadlines = {"interactive": 5.0} if deadlines is None else deadlines
    target_rate = capacity_factor * capacity
    # Pareto(alpha) inter-arrivals: heavy-tailed bursts around a controlled
    # mean — E[gap] = xm * alpha/(alpha-1), solved for the target rate
    alpha = 1.8
    xm = (alpha - 1) / (alpha * target_rate)

    submitted: List[Tuple[str, Any]] = []        # (lane, ticket)
    shed: Dict[str, int] = {}
    shed_reasons: Dict[str, int] = {}
    per_lane_submit: Dict[str, int] = {lane: 0 for lane in LANES}
    aborted: Optional[str] = None
    frac = q.capacity_fraction()
    recalibrations = 0
    t_start = time.perf_counter()
    t_next = t_start
    n = 0
    try:
        while (time.perf_counter() - t_start) < duration_s \
                and n < max_requests:
            f = q.capacity_fraction()
            if f != frac:
                # the pool changed size under us (executor death): re-size
                # the offered load to the surviving capacity so the soak
                # keeps measuring overload, not a stampede on a half pool
                frac = f
                target_rate = max(capacity_factor * capacity * frac, 1.0)
                xm = (alpha - 1) / (alpha * target_rate)
                recalibrations += 1
            routine, a, b = reqs[int(rng.integers(len(reqs)))]
            lane = str(lanes[int(rng.choice(len(lanes), p=weights))])
            per_lane_submit[lane] = per_lane_submit.get(lane, 0) + 1
            n += 1
            try:
                t = q.submit(routine, a, b, lane=lane,
                             deadline=deadlines.get(lane))
                submitted.append((lane, t))
            except QueueOverloadError as e:
                shed[lane] = shed.get(lane, 0) + 1
                shed_reasons[e.reason] = shed_reasons.get(e.reason, 0) + 1
            except SlateError as e:
                # queue closed / worker died mid-run: stop offering but
                # KEEP the tally — the already-submitted tickets were
                # failed fast by the death handler and classify below
                aborted = f"{type(e).__name__}: {e}"
                break
            t_next += xm * (1.0 + rng.pareto(alpha))
            pause = t_next - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
        offered_s = time.perf_counter() - t_start

        # -- drain + classify every admitted ticket exactly once ------------
        try:
            q.flush(timeout=drain_timeout_s)
        except TimeoutError:
            pass                   # hung tickets are counted (and gated) below
        ok = bad = expired = worker_failed = capped = hung = 0
        expired_by_lane: Dict[str, int] = {}
        lat_by_lane: Dict[str, List[float]] = {}
        for lane, t in submitted:
            if not t.done():
                hung += 1
                continue
            try:
                _, info = t.result(timeout=0)
                ok += int(info == 0)
                bad += int(info != 0)
                lat_by_lane.setdefault(lane, []).append(t.latency_s)
            except DeadlineExceededError:
                expired += 1
                expired_by_lane[lane] = expired_by_lane.get(lane, 0) + 1
            except NumericalError:
                capped += 1        # typed numerical error (escalation cap)
            except SlateError:
                worker_failed += 1  # worker-death resolution (fail-fast)
            # tally, not a swallow: the
            # taxonomy classes are caught (and counted) explicitly above;
            # anything else is an unexpected worker error the stats
            # surface as worker_failed
            except Exception:      # unexpected driver error
                worker_failed += 1
    finally:
        q.close()

    stats: Dict[str, Any] = {
        "capacity_solves_per_sec": round(capacity, 1),
        "executors": int(executors),
        "continuous": bool(continuous),
        "capacity_fraction_final": round(q.capacity_fraction(), 3),
        "recalibrations": recalibrations,
        "target_rate": round(target_rate, 1),
        "offered": n,
        "offered_rate": round(n / max(offered_s, 1e-9), 1),
        "duration_s": round(offered_s, 2),
        "warmup_s": round(warmup_s, 3),
        "admitted": len(submitted),
        "ok": ok, "bad": bad, "capped": capped,
        "worker_failed": worker_failed,
        "expired": expired, "expired_by_lane": expired_by_lane,
        "shed": sum(shed.values()), "shed_by_lane": dict(shed),
        "shed_reasons": dict(shed_reasons),
        "aborted": aborted,
        "submitted_by_lane": {k: v for k, v in per_lane_submit.items() if v},
        "hung": hung,
        "cache": _pool_cache_stats(q),
    }
    for lane, lats in sorted(lat_by_lane.items()):
        stats[f"{lane}_p50_ms"] = round(_percentile_ms(lats, 50), 3)
        stats[f"{lane}_p99_ms"] = round(_percentile_ms(lats, 99), 3)
    return stats


def run_continuous_ab(num_requests: int = 300, seed: int = 0,
                      policy: Optional[BucketPolicy] = None,
                      opts: Optional[Options] = None,
                      dims: Sequence[int] = (8, 13, 24),
                      routines: Sequence[str] = DEFAULT_ROUTINES,
                      rounds: int = 2, executors: int = 2,
                      pace_factor: float = 0.2,
                      discard_rounds: int = 1,
                      device=None) -> Dict[str, Any]:
    """Interleaved continuous-vs-flush A/B — the continuous-batching
    measurement.

    Two phases, each alternating flush / continuous runs back-to-back
    (interleaving absorbs machine drift — neither mode gets the warm or
    the noisy half of the wall clock):

    1. **closed-loop** rounds (submit bursts): warm throughput per mode
       (best across rounds, see below), and ``warm_ratio`` = continuous /
       flush — the "within 0.9x" gate.
    2. **paced** rounds at ``pace_factor`` x the flush mode's measured
       closed-loop throughput, every request on the interactive lane:
       open-loop arrivals are where the flush window's fixed-wait tax is
       visible, so ``queue_wait_p50_ms`` per mode is the headline number
       (continuous must come in below flush), with the continuous mode's
       ``slot_join_rate`` alongside.  ``pace_factor`` deliberately sits
       well below saturation: the fixed-wait tax is the dominant latency
       term only while buckets go out underfilled (per-bucket
       inter-arrival above ``max_wait_ms``); near saturation queueing
       dominates BOTH modes and the comparison drowns in service-time
       noise.

    The first ``discard_rounds`` interleaved pairs are run and THROWN
    AWAY: the first serving runs in a fresh process are dominated by
    process-level warm-in (lazy kernel loading, library handles, host
    thread pools) that can dwarf any scheduler difference.  Only the
    post-transient rounds are recorded.
    """
    mode_kw = (("flush", False), ("continuous", True))
    for _ in range(max(int(discard_rounds), 0)):
        for m, cont in mode_kw:
            run_mixed_workload(num_requests=num_requests, seed=seed,
                               policy=policy, opts=opts, dims=dims,
                               routines=routines, executors=executors,
                               continuous=cont, device=device)
    closed: Dict[str, List[Dict[str, Any]]] = {m: [] for m, _ in mode_kw}
    for _ in range(max(int(rounds), 1)):
        for m, cont in mode_kw:
            s = run_mixed_workload(
                num_requests=num_requests, seed=seed, policy=policy,
                opts=opts, dims=dims, routines=routines,
                executors=executors, continuous=cont, device=device)
            closed[m].append(s)
    # per-mode BEST rate across rounds: co-tenant noise on a shared host is
    # one-sided (a stall can only slow a run, nothing makes one faster than
    # the machine allows), so the max is the low-variance estimator of each
    # scheduler's sustainable rate — medians of second-long runs still swung
    # 2x run-to-run under the same config
    warm = {m: float(max(s["solves_per_sec"] for s in v))
            for m, v in closed.items()}
    rate = max(pace_factor * warm["flush"], 1.0)
    paced: Dict[str, List[Dict[str, Any]]] = {m: [] for m, _ in mode_kw}
    for _ in range(max(int(rounds), 1)):
        for m, cont in mode_kw:
            s = run_mixed_workload(
                num_requests=num_requests, seed=seed, policy=policy,
                opts=opts, dims=dims, routines=routines,
                executors=executors, continuous=cont,
                pace_rate=rate, lane="interactive", device=device)
            paced[m].append(s)

    def _med(mode: str, key: str) -> Optional[float]:
        vals = [s[key] for s in paced[mode] if s.get(key) is not None]
        return round(float(np.median(vals)), 3) if vals else None

    return {
        "rounds": int(rounds), "executors": int(executors),
        "requests_per_run": int(num_requests),
        "offered_rate": round(rate, 1),
        "warm_solves_per_sec": {m: round(v, 1) for m, v in warm.items()},
        "warm_solves_per_sec_rounds": {
            m: [round(s["solves_per_sec"], 1) for s in v]
            for m, v in closed.items()},
        "warm_ratio": round(warm["continuous"]
                            / max(warm["flush"], 1e-9), 3),
        "queue_wait_p50_ms": {m: _med(m, "queue_wait_p50_ms")
                              for m, _ in mode_kw},
        "queue_wait_p99_ms": {m: _med(m, "queue_wait_p99_ms")
                              for m, _ in mode_kw},
        "latency_p50_ms": {m: _med(m, "p50_ms") for m, _ in mode_kw},
        # joins need pressure: the paced (open-loop) rate is the headline
        # companion to queue_wait, the closed-loop rate shows how hard the
        # staging slots work when buckets stay hot
        "slot_join_rate": round(float(np.mean(
            [s["slot_join_rate"] for s in paced["continuous"]])), 4),
        "slot_join_rate_closed_loop": round(float(np.mean(
            [s["slot_join_rate"] for s in closed["continuous"]])), 4),
    }


def run_scale_workload(executor_counts: Sequence[int] = (1, 2, 4),
                       num_requests: int = 600, seed: int = 0,
                       policy: Optional[BucketPolicy] = None,
                       opts: Optional[Options] = None,
                       **kwargs) -> Dict[str, Any]:
    """The serve_scale axis: the same warm mixed stream served at each
    pool size, so N=1 vs N=2 vs N=4 throughput is an apples-to-apples read
    (same seed, same policy, fresh caches per run).  Extra keyword args
    (``device`` among them) pass through to :func:`run_mixed_workload`.  Returns per-N stats
    plus a ``solves_per_sec`` summary keyed by executor count."""
    runs: Dict[str, Any] = {}
    for n in executor_counts:
        stats = run_mixed_workload(num_requests=num_requests, seed=seed,
                                   policy=policy, opts=opts,
                                   executors=int(n), **kwargs)
        stats.pop("tickets", None)       # not JSON-serializable
        runs[str(int(n))] = stats
    return {
        "executor_counts": [int(n) for n in executor_counts],
        "runs": runs,
        "solves_per_sec": {k: v["solves_per_sec"] for k, v in runs.items()},
    }
