"""Shape-bucketing + padding policy and the mixed-traffic serving queue.

The throughput problem: a million users submit *small* heterogeneous
solves — n=13 here, n=57 there, gesv next to gels — and the card wants
large, shape-static batches (one batched library call chain per batch, not
one launch chain per request).  The bridge is the classic serving recipe
(BLASX's scheduler over a software cache, PAPERS.md):

* **Bucket** every request's dims up to a small set of rounded shapes, so
  mixed traffic collapses onto a handful of prepared programs.
* **Pad** each operand into its bucket in a solution-preserving way:
  square solves extend A with an identity block (the padded subsystem is
  ``I z = 0`` — well-posed, SPD-preserving), least squares extends A with
  ``[[A, 0], [0, I]]`` so the padded normal equations stay block-diagonal
  and the true solution rides in the leading block.
* **Pack** requests of one (routine, bucket, dtype) into batches — flushed
  at ``max_batch`` or after ``max_wait_ms``, whichever first — and round
  the batch axis up to a pow-2 bucket (identity-system ghost slots) so
  batch sizes, too, come from a bounded set and the executable cache stays
  small.

Latency vs occupancy is the policy's one real tradeoff: larger
``max_batch``/``max_wait_ms`` raise solves/sec (better occupancy of the
card, fewer batched calls) and raise p99 (requests wait for the pack); the
knobs are per-queue so latency-sensitive traffic can run a smaller pack.
Every batch records its occupancy (real/padded) and every request its
queue-to-result latency in the obs registry (``slate_serve_*``).

Overload discipline (built on :mod:`.admission`):
``submit(..., lane=, deadline=)`` places each request in a priority lane
(``interactive`` > ``batch`` > ``best_effort``) with an optional deadline
budget.  Admission is bounded — per-lane depth, global in-flight, token
buckets, SLO-coupled shedding — and rejects with a typed
:class:`~slate_tpu_torch.core.exceptions.QueueOverloadError`.  The scheduler
serves ready buckets in (lane priority, earliest deadline) order, flushes a
bucket *early* when its oldest deadline is within the bucket's observed
execute-p99, and expires still-queued past-deadline tickets with
:class:`~slate_tpu_torch.core.exceptions.DeadlineExceededError` before they waste
a batch slot.  Every rejection leaves a flight record with its reason
(``shed`` / ``deadline`` / ``worker_death``).

Execution (:mod:`.executor`): the queue's scheduler thread does not run
batches itself — it pops one highest-priority bucket chunk per cycle and
routes it to an :class:`~slate_tpu_torch.serve.executor.ExecutorPool`
(``executors=N``): cache-residency-first routing with least-loaded fallback
and work-stealing, and a dispatch/resolve split inside each executor so
padding of batch k+1 overlaps device execution of batch k.  Admission
capacity scales with the live executor count (an executor death re-rates
the token buckets via
:meth:`~slate_tpu_torch.serve.admission.AdmissionController.scale_capacity`); a
dying executor fails only its in-flight batch and reroutes the rest, and
only the death of the LAST executor makes the whole queue fail-fast (every
queued ticket resolves with a typed error instead of hanging).

Device: a queue serves on ``device`` (default ``cuda``; without CUDA it
raises unless ``device="cpu"``), and ``Ticket.result()`` returns the
solution as a tensor on that device.  Operands may be numpy arrays (packed
on the host, one copy per batch) or tensors (left on their device and
copied into the batch there — a tensor on the card never visits the host).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.exceptions import (DeadlineExceededError, QueueOverloadError,
                               SlateError, slate_assert)
from ..core.matrix import resolve_device
from ..core.types import Options
from ..utils import trace
from . import batched as _batched
from .admission import AdmissionController, DEFAULT_LANE, LANE_PRIORITY
from .cache import ExecutableCache, default_cache, dtype_name
from .flight import FlightRecorder
# the batch machinery lives in .executor since the pool split; these are
# re-exported here because they are queue API surface (and tests/tools
# import them from this module)
from .executor import (  # noqa: F401 - re-exported queue API
    DRIVERS, SERVE_SITE, _OCCUPANCY_BUCKETS, _STAGE_BUCKETS, Chunk,
    Executor, ExecutorPool, Ticket, _Pending, _capped_error,
    _flight_record, _new_trace_id, _run_bucket_batch, _stage_hist,
    executable_key, pad_request, unpad_result)

#: execute-p99 lookups for the early-flush check are cached this long
_P99_TTL_S = 0.5


def _obs():
    from .. import obs

    return obs


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _merged_quantile(h, q: float, **labels) -> Optional[float]:
    """``q``-quantile of every series of ``h`` whose labels CONTAIN
    ``labels`` (subset match, vs :meth:`Histogram.quantile`'s exact match).
    The execute histogram carries per-executor series under the pool plus
    unlabeled series from the sync packer; the early-flush threshold wants
    the (routine, bucket) distribution across all of them."""
    want = set((str(k), str(v)) for k, v in labels.items())
    merged: Optional[List[int]] = None
    for key, state in h.series().items():
        if not want.issubset(set(key)):
            continue
        counts = state["counts"]
        merged = (list(counts) if merged is None
                  else [a + b for a, b in zip(merged, counts)])
    if merged is None:
        return None
    from ..obs.registry import quantile_from_counts

    return quantile_from_counts(h.buckets, merged, q)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Shape/batch rounding + flush knobs for one queue.

    dims:        matrix-dimension buckets (rounded up; beyond the last entry
                 rounding falls back to the next power of two).
    nrhs_dims:   right-hand-side count buckets.
    batch_dims:  batch-axis buckets (pow-2 by default); the largest is the
                 effective max batch.
    max_batch:   flush a bucket as soon as this many requests are pending.
    max_wait_ms: flush a non-empty bucket this long after its oldest request
                 arrived, even if underfull (the latency bound).
    """

    dims: Tuple[int, ...] = (16, 32, 64, 96, 128)
    nrhs_dims: Tuple[int, ...] = (1, 4, 8)
    # a sparse batch ladder: each extra rung is one more prepared program
    # per (routine, shape bucket) — 4 rungs keeps worst-case slot waste at
    # 4x on tiny flushes while bounding the warm-up build count
    batch_dims: Tuple[int, ...] = (1, 4, 16, 32)
    max_batch: int = 32
    max_wait_ms: float = 5.0

    def round_dim(self, n: int, dims: Optional[Sequence[int]] = None) -> int:
        dims = self.dims if dims is None else dims
        for d in dims:
            if n <= d:
                return int(d)
        return _pow2_at_least(n)

    def round_batch(self, b: int) -> int:
        return self.round_dim(min(b, self.max_batch), self.batch_dims)

    def bucket(self, routine: str, m: int, n: int, nrhs: int
               ) -> Tuple[int, int, int]:
        """(m', n', nrhs') padded dims for one request."""
        bn = self.round_dim(n)
        br = self.round_dim(nrhs, self.nrhs_dims)
        if routine in ("gesv", "posv"):
            slate_assert(m == n, f"{routine}: square systems only "
                                 f"(got {m}x{n})")
            return bn, bn, br
        bm = self.round_dim(m)
        # least squares: the identity block that carries the padded columns
        # (tall) or padded rows (wide) must fit — bump the larger side's
        # bucket until it does, preserving the request's shape class
        if m >= n:
            while bm - m < bn - n:
                bm = self.round_dim(bm + 1)
        else:
            while bn - n < bm - m:
                bn = self.round_dim(bn + 1)
        return bm, bn, br


def _operands(a, b) -> Tuple[Any, Any, Optional[torch.cuda.Event]]:
    """One request's operands as the packer takes them: numpy arrays, or —
    when either is a tensor — tensors on the device of ``a`` (a tensor is
    never copied back to the host).  For a CUDA tensor pair, the third
    value is an event recorded on the submitter's current stream, which the
    packer's stream waits for before it reads the operands."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return np.asarray(a), np.asarray(b), None
    dev = a.device if isinstance(a, torch.Tensor) else b.device
    a = torch.as_tensor(a, device=dev).detach()
    b = torch.as_tensor(b, device=dev).detach()
    if dev.type != "cuda":
        return a, b, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    return a, b, ready


def _normalize_request(policy: BucketPolicy, routine: str, a, b,
                       lane: str = DEFAULT_LANE,
                       deadline: Optional[float] = None
                       ) -> Tuple[tuple, _Pending]:
    """One request -> its group key + pending record.  The single
    normalization path both verbs share (async ``submit`` and sync
    ``solve_many``): numpy operands stay on the host until the packer's one
    copy per batch, tensor operands stay on their device (:func:`_operands`),
    1-D rhs promotion, bucket lookup, and the ``slate_serve_requests_total``
    sample.  No host sync."""
    t0 = time.perf_counter()
    if routine not in DRIVERS:
        raise SlateError(f"serve: unknown routine {routine!r}; "
                         f"expected one of {sorted(DRIVERS)}")
    a, b, ready = _operands(a, b)
    if b.ndim == 1:
        b = b[:, None]
    m, n = a.shape[-2:]
    bucket = policy.bucket(routine, m, n, b.shape[-1])
    _obs().counter("slate_serve_requests_total", "submitted requests").inc(
        routine=routine, bucket="x".join(str(d) for d in bucket), lane=lane)
    item = _Pending(Ticket(routine, (m, n, b.shape[-1]), lane=lane,
                           deadline=deadline), a, b,
                    n, b.shape[-1], ready=ready)
    t1 = time.perf_counter()
    item.ticket.stages["submit"] = t1 - t0
    trace.emit_span("serve.submit", t0, t1, trace_id=item.ticket.trace_id,
                    routine=routine,
                    bucket="x".join(str(d) for d in bucket))
    return (routine, bucket, dtype_name(a.dtype)), item


class ServeQueue:
    """Mixed-traffic serving queue over the batched drivers.

    ::

        q = serve.ServeQueue()
        t = q.submit("gesv", a, b)        # a (n, n), b (n,) or (n, nrhs)
        x, info = t.result()

        t = q.submit("gesv", a, b, lane="best_effort", deadline=0.5)

        q = serve.ServeQueue(executors=4)       # the multi-executor pool
        q = serve.ServeQueue(device="cpu")      # serve on the CPU

    A background scheduler packs pending requests per (lane, routine,
    bucket, dtype), flushes on ``max_batch`` / ``max_wait_ms`` (see
    :class:`BucketPolicy`) in (lane priority, earliest deadline) order —
    early when a deadline is within the bucket's observed execute-p99 —
    and routes each popped chunk to the
    :class:`~slate_tpu_torch.serve.executor.ExecutorPool` (``executors=N``
    backends, each with its own CUDA stream, residency-aware,
    work-stealing, each overlapping host pad with device execute).
    ``admission`` (an
    :class:`~slate_tpu_torch.serve.admission.AdmissionPolicy` or a pre-built
    controller) bounds what gets in — its capacity re-rates to the live
    executor fraction on an executor death; rejected submissions raise
    :class:`QueueOverloadError`, expired tickets resolve with
    :class:`DeadlineExceededError`.  ``close()`` drains and stops the
    scheduler + pool; the queue is also a context manager.

    ``continuous=True`` switches flush discipline to rolling admission
    (continuous batching): non-empty buckets dispatch
    eagerly instead of waiting out ``max_wait_ms``, and late arrivals to a
    hot bucket *join* the next staged dispatch — at submit time via the
    pool's :meth:`~slate_tpu_torch.serve.executor.ExecutorPool.try_join`, and at
    pop time by folding a popped chunk into a staged same-key chunk.  The
    slot ladder (``policy.batch_dims`` + identity-ghost fill) means any
    occupancy runs without a fresh build, so eager dispatch costs no
    builds, only pad slots — which the pad-waste metrics make visible.
    Per-element results are identical to flush mode at equal slot
    capacity (same program, ghost slots inert).

    ``device`` is where the queue serves (default ``cuda``; raises without
    CUDA unless ``device="cpu"``).
    """

    def __init__(self, policy: Optional[BucketPolicy] = None,
                 opts: Optional[Options] = None,
                 cache: Optional[ExecutableCache] = None,
                 start: bool = True,
                 flight: Optional[FlightRecorder] = None,
                 admission: Optional[object] = None,
                 executors: int = 1,
                 steal_threshold: int = 4,
                 continuous: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.policy = policy or BucketPolicy()
        self.opts = Options.make(opts)
        self.cache = default_cache() if cache is None else cache
        self.flight = FlightRecorder() if flight is None else flight
        if isinstance(admission, AdmissionController):
            self.admission = admission
        else:
            self.admission = AdmissionController(admission)
        if int(executors) < 1:
            raise SlateError(f"serve: executors must be >= 1, "
                             f"got {executors}")
        self.continuous = bool(continuous)
        self._slo_monitor = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: full key = (lane, routine, bucket, dtype)
        self._pending: Dict[tuple, List[_Pending]] = {}
        self._oldest: Dict[tuple, float] = {}
        self._min_deadline: Dict[tuple, float] = {}
        self._depths: Dict[str, int] = {}
        self._inflight = 0           # popped off _pending, not yet served
        self._early_ready: set = set()
        self._p99_cache: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._closed = False
        self._worker_died: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        # executor 0 serves from THIS queue's cache (so single-executor
        # queues keep the exact pre-pool cache identity); extra executors
        # get their own same-capacity caches — residency is the whole
        # routing signal, shared tables would erase it
        caches = [self.cache] + [ExecutableCache(capacity=self.cache.capacity)
                                 for _ in range(int(executors) - 1)]
        self.pool = ExecutorPool(
            int(executors), self.policy, self.opts, caches,
            flight=self.flight,
            esc_gate=self.admission.escalations.take,
            steal_threshold=steal_threshold,
            join_max=self.policy.max_batch if self.continuous else None,
            on_chunk_done=self._chunk_done,
            on_item_expired=self._expire_inflight,
            on_executor_death=self._on_executor_death,
            on_all_dead=self._on_pool_dead,
            device=self.device)
        if start:
            self.pool.start()
            self._worker = threading.Thread(target=self._loop, daemon=True,
                                            name="slate-serve-queue")
            self._worker.start()

    # -- submission ----------------------------------------------------------
    def submit(self, routine: str, a, b, lane: str = DEFAULT_LANE,
               deadline: Optional[float] = None) -> Ticket:
        """Submit one solve; returns its :class:`Ticket`.

        lane:     priority lane (:data:`~slate_tpu_torch.serve.admission.LANES`);
                  interactive outranks batch outranks best_effort.
        deadline: seconds of budget from now; the queue expires the ticket
                  with :class:`DeadlineExceededError` once it runs out and
                  flushes its bucket early when the budget nears the
                  bucket's observed execute-p99.

        Raises :class:`QueueOverloadError` when admission control sheds the
        request, and :class:`SlateError` immediately (never a hung ticket)
        when the queue is closed or its worker thread has died."""
        if lane not in LANE_PRIORITY:
            raise SlateError(f"serve: unknown lane {lane!r}; "
                             f"expected one of {sorted(LANE_PRIORITY)}")
        if deadline is not None and deadline <= 0:
            raise SlateError(f"serve: deadline must be positive seconds, "
                             f"got {deadline}")
        if self._slo_monitor is not None:
            # throttled: re-consume the SLO verdicts at most every
            # policy.slo_refresh_s — the admission decision itself reads a
            # cached shed set and stays O(1)
            self.admission.maybe_refresh(self.slo_verdicts)
        key, item = _normalize_request(self.policy, routine, a, b,
                                       lane=lane, deadline=deadline)
        overload: Optional[QueueOverloadError] = None
        with self._cv:
            self._check_alive()
            depth = self._depths.get(lane, 0)
            try:
                self.admission.admit(lane, depth, self._unresolved())
            except QueueOverloadError as e:
                overload = e
            else:
                if self.continuous:
                    # rolling admission: pre-count the request in-flight
                    # BEFORE offering it to a staged chunk — the staged
                    # chunk's chunk_done decrements per item, and counting
                    # after a successful join could race that decrement
                    # (flush() would then wait on a phantom forever)
                    self._inflight += 1
                else:
                    self._enqueue_locked(lane, key, item)
        if overload is not None:
            self._record_shed(item, key, overload)
            raise overload
        if self.continuous:
            ex = self.pool.try_join((lane,) + key, item)
            if ex is not None:
                self._note_slot_join(key, item, ex)
            else:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
                    try:
                        # the queue may have died between admit and here —
                        # inserting now would strand a ticket forever
                        self._check_alive()
                    except SlateError as e:
                        item.ticket._resolve(error=e)
                        raise
                    self._enqueue_locked(lane, key, item)
        return item.ticket

    def _enqueue_locked(self, lane: str, key: tuple,
                        item: _Pending) -> None:
        """Insert one admitted request into ``_pending`` and sync the
        per-key maps + lane depth (caller holds the lock)."""
        fk = (lane,) + key
        self._pending.setdefault(fk, []).append(item)
        self._depths[lane] = self._depths.get(lane, 0) + 1
        self._depth_gauge(lane)
        self._oldest.setdefault(fk, time.perf_counter())
        td = item.ticket.t_deadline
        if td is not None:
            cur = self._min_deadline.get(fk)
            if cur is None or td < cur:
                self._min_deadline[fk] = td
        self._cv.notify()

    def _note_slot_join(self, key: tuple, item: _Pending, ex) -> None:
        """One submit joined a staged dispatch: stamp the ticket (the
        flight record + chrome-trace attribution) and count it."""
        tk = item.ticket
        tk.slot_joined = True
        tk.stages["slot_join"] = time.perf_counter() - tk.t_submit
        routine, bucket, _ = key
        bucket_s = "x".join(str(d) for d in bucket)
        _obs().counter("slate_serve_slot_joins_total",
                       "requests that joined an already-staged dispatch "
                       "(continuous batching)").inc(
                           routine=routine, bucket=bucket_s,
                           executor=ex.name)
        trace.trace_event("slot_join", routine=routine, bucket=bucket_s,
                          executor=ex.name, trace_id=tk.trace_id)

    def _check_alive(self) -> None:
        """Raise (don't enqueue a ticket that can never resolve) when the
        queue is closed or the worker thread is gone.  Caller holds the
        lock.  ``start=False`` queues have no worker and stay usable for
        warm-up / inspection."""
        if self._closed:
            raise SlateError("serve: queue is closed")
        if self._worker_died is not None:
            raise SlateError(
                "serve: worker thread died "
                f"({type(self._worker_died).__name__}: {self._worker_died});"
                " queue is unusable — create a new ServeQueue")
        if self._worker is not None and not self._worker.is_alive():
            raise SlateError("serve: worker thread is not running")

    def _unresolved(self) -> int:
        """Admitted-but-unresolved count (pending + popped-for-execution);
        the admission controller's in-flight signal.  Caller holds the
        lock."""
        return sum(self._depths.values()) + self._inflight

    def _record_shed(self, item: _Pending, key: tuple,
                     err: QueueOverloadError) -> None:
        """A rejection is evidence: counter, trace event, flight record,
        and the ticket resolved with the error (anyone holding it sees the
        same typed failure the submitter caught)."""
        tk = item.ticket
        routine, bucket, _ = key
        bucket_s = "x".join(str(d) for d in bucket)
        _obs().counter("slate_serve_shed_total",
                       "requests rejected by admission control").inc(
                           lane=tk.lane, reason=err.reason, routine=routine)
        trace.trace_event("shed", routine=routine, lane=tk.lane,
                          reason=err.reason, trace_id=tk.trace_id)
        tk._resolve(error=err)
        self.flight.record(_flight_record(
            item, routine, bucket_s, 0, 0,
            error=f"{type(err).__name__}: {err}", reason="shed"))

    def warmup(self, combos: Sequence[Tuple[str, int, int, int]],
               dtype=np.float32) -> int:
        """Prepare every program the given traffic can need.

        ``combos`` is ``(routine, m, n, nrhs)`` request shapes; each maps to
        its bucket and is prepared at *every* batch bucket — in EVERY
        executor's cache, on that executor's device and stream, so
        subsequent mixed traffic takes zero misses regardless of how
        flushes split or which executor the router picks.  ``dtype`` is a
        numpy or torch dtype.  Returns the number of distinct entries now
        warm (per cache)."""
        # dedupe first: many request shapes share a bucket, and each
        # (routine, bucket, batch-rung) is one build
        buckets = sorted({(routine, self.policy.bucket(routine, m, n, nrhs))
                          for routine, m, n, nrhs in combos})
        slots = [nb for nb in self.policy.batch_dims
                 if nb <= self.policy.max_batch]
        seen = 0
        for routine, (bm, bn, br) in buckets:
            # the drivers' own program factory: a local copy could drift and the
            # cache key would not notice (it excludes function identity);
            # the slot ladder rides the cache's own warmup API — one
            # entry per (routine, bucket, slot) per cache
            for cache in self.pool.caches():
                cache.warmup(
                    routine + "_batched",
                    _batched.batched_build(routine + "_batched"),
                    [((bm, bn), dtype), ((bm, br), dtype)],
                    self.opts, slots=slots)
            seen += len(slots)
        return seen

    # -- scheduler -----------------------------------------------------------
    def _exec_p99(self, routine: str, bucket_s: str, now: float) -> float:
        """Observed execute-stage p99 for one (routine, bucket) — the
        early-flush threshold — merged across every executor's series of
        the stage histogram, cached for ``_P99_TTL_S`` so the flush
        loop stays O(pending keys)."""
        ent = self._p99_cache.get((routine, bucket_s))
        if ent is not None and now - ent[1] < _P99_TTL_S:
            return ent[0]
        h = _obs().REGISTRY.get("slate_serve_execute_seconds")
        q = _merged_quantile(h, 0.99, routine=routine, bucket=bucket_s) \
            if h is not None else None
        q = float(q) if q is not None else 0.0
        self._p99_cache[(routine, bucket_s)] = (q, now)
        return q

    def _key_order(self, key: tuple) -> tuple:
        """(lane priority, earliest deadline, oldest arrival) sort key."""
        return (LANE_PRIORITY.get(key[0], len(LANE_PRIORITY)),
                self._min_deadline.get(key, float("inf")),
                self._oldest.get(key, float("inf")))

    def _ready_keys(self, now: float) -> List[tuple]:
        if self.continuous and self.pool.has_starved():
            # continuous batching: while some executor STARVES (idle, no
            # staged or in-flight chunk), every non-empty bucket is ready
            # NOW — the fixed-wait tax is gone and any occupancy is
            # build-free on the slot ladder.  Once the whole pool is
            # busy, fall through to the flush rules below: eager flushing
            # a saturated pool only shreds buckets into ghost-padded
            # slivers (throughput loss with no latency win — queueing
            # dominates), while held buckets keep filling and late
            # arrivals still join the chunks already staged.  Deadline
            # sweeps and pool backpressure (can_accept) apply unchanged.
            ready = [k for k, v in self._pending.items() if v]
            ready.sort(key=self._key_order)
            self._early_ready = set()
            return ready
        ready = []
        early = set()
        for key, items in self._pending.items():
            if not items:
                continue
            age_ms = (now - self._oldest[key]) * 1e3
            if len(items) >= self.policy.max_batch \
                    or age_ms >= self.policy.max_wait_ms:
                ready.append(key)
                continue
            md = self._min_deadline.get(key)
            if md is None:
                continue
            # deadline-aware: flush early when the tightest budget in the
            # bucket is within the bucket's observed execute-p99 (or has
            # already expired and must be swept out of the queue)
            _, routine, bucket, _d = key
            bucket_s = "x".join(str(d) for d in bucket)
            if md - now <= self._exec_p99(routine, bucket_s, now):
                if md > now:
                    early.add(key)       # counted at pop time, not per scan
                ready.append(key)
        ready.sort(key=self._key_order)
        self._early_ready = early
        return ready

    def _depth_gauge(self, lane: str) -> None:
        """Publish one lane's pending depth (caller holds the lock — every
        mutation of ``_depths`` refreshes the gauge, so it never goes
        stale)."""
        _obs().gauge("slate_serve_lane_depth",
                     "pending tickets per priority lane").set(
                         self._depths.get(lane, 0), lane=lane)

    def _requeue_locked(self, key: tuple,
                        remaining: List[_Pending]) -> None:
        """Re-point one key's pending/oldest/min-deadline state at
        ``remaining`` (possibly empty) after some items were taken out —
        the ONE place the three per-key maps are kept in sync (caller
        holds the lock)."""
        if remaining:
            self._pending[key] = remaining
            self._oldest[key] = remaining[0].ticket.t_submit
            mds = [it.ticket.t_deadline for it in remaining
                   if it.ticket.t_deadline is not None]
            if mds:
                self._min_deadline[key] = min(mds)
            else:
                self._min_deadline.pop(key, None)
        else:
            self._pending.pop(key, None)
            self._oldest.pop(key, None)
            self._min_deadline.pop(key, None)

    def _sweep_expired_locked(self, now: float) -> List[Tuple[tuple,
                                                              _Pending]]:
        """Pull every past-deadline ticket out of EVERY lane's pending
        lists (caller holds the lock; resolution happens outside it).
        Runs each scheduler cycle regardless of which bucket wins the pop,
        so an expired low-lane ticket never waits behind sustained
        higher-lane traffic — expiry costs no batch slot.  (Chunks already
        routed to an executor get the same sweep at dispatch time, see
        :meth:`Executor._dispatch`.)"""
        out: List[Tuple[tuple, _Pending]] = []
        for key in [k for k, md in list(self._min_deadline.items())
                    if md <= now]:
            items = self._pending.get(key)
            if not items:
                continue
            live = []
            for it in items:
                td = it.ticket.t_deadline
                if td is not None and now >= td:
                    out.append((key, it))
                else:
                    live.append(it)
            self._requeue_locked(key, live)
            lane = key[0]
            self._depths[lane] = max(
                self._depths.get(lane, 0) - (len(items) - len(live)), 0)
            self._depth_gauge(lane)
        return out

    def _next_wait(self, now: float) -> Optional[float]:
        """Seconds the scheduler may sleep before some bucket could become
        ready (None = nothing pending).  Caller holds the lock."""
        wait = None
        for key, items in self._pending.items():
            if not items:
                continue
            w = self._oldest[key] + self.policy.max_wait_ms / 1e3 - now
            md = self._min_deadline.get(key)
            if md is not None:
                lane, routine, bucket, _ = key
                bucket_s = "x".join(str(d) for d in bucket)
                w = min(w, md - self._exec_p99(routine, bucket_s, now) - now)
            wait = w if wait is None else min(wait, w)
        return None if wait is None else max(wait, 1e-4)

    def _loop(self):
        try:
            self._serve_loop()
        # not a swallow: this is the worker-death boundary; the exception
        # (taxonomy included) is re-surfaced on every queued ticket by
        # _on_worker_death, and no solve runs inside this frame after it
        except BaseException as e:  # noqa: BLE001 - resurfaced on tickets
            self._on_worker_death(e)

    def _serve_loop(self):
        # one highest-priority bucket chunk per cycle: lane priority and
        # deadlines are re-evaluated BETWEEN chunks, so a deep low-lane
        # backlog cannot capture the scheduler while interactive traffic
        # queues behind it.  The chunk itself executes on the pool — the
        # scheduler never blocks on a device.
        while True:
            with self._cv:
                while True:
                    if self._worker_died is not None:
                        return           # pool death handler failed tickets
                    now = time.perf_counter()
                    ready = self._ready_keys(now)
                    if self._closed:
                        break
                    if ready:
                        if self.pool.can_accept():
                            break
                        # backpressure: every live executor is at its bound
                        # — hold the chunk HERE, where lane priority and
                        # deadline expiry still apply, until a chunk_done
                        # notify (timeout guards depth read staleness)
                        self._cv.wait(timeout=0.005)
                        continue
                    wait = self._next_wait(now)
                    if wait is not None:
                        self._cv.wait(timeout=wait)
                    else:
                        self._cv.wait()
                if self._closed and not any(self._pending.values()):
                    return
                # sweep past-deadline tickets out of EVERY lane first —
                # expiry must not queue behind the pop choice below
                now = time.perf_counter()
                expired = self._sweep_expired_locked(now)
                candidates = [
                    k for k in (ready or sorted(
                        (k for k, v in self._pending.items() if v),
                        key=self._key_order))
                    if self._pending.get(k)]
                key = candidates[0] if candidates else None
                live: List[_Pending] = []
                if key is not None:
                    items = self._pending.get(key, [])
                    live = items[:self.policy.max_batch]
                    self._requeue_locked(key, items[self.policy.max_batch:])
                    lane = key[0]
                    self._depths[lane] = max(
                        self._depths.get(lane, 0) - len(live), 0)
                    self._depth_gauge(lane)
                    if key in self._early_ready:
                        # one sample per ACTUAL deadline-driven flush (the
                        # ready scan may re-flag a waiting bucket many times)
                        self._early_ready.discard(key)
                        _obs().counter(
                            "slate_serve_early_flush_total",
                            "deadline-driven flushes ahead of max_wait").inc(
                                routine=key[1], lane=lane)
                    # popped-but-unserved requests are invisible in
                    # _pending; _inflight keeps flush() honest about them
                    # until the pool's chunk_done callback
                    self._inflight += len(live)
            for k, it in expired:
                self._expire(k, it)
            if not live:
                continue
            try:
                self.pool.dispatch(Chunk(key, live))
            # not a swallow: the routed-but-undelivered chunk's tickets are
            # failed fast right here, then the exception re-raises into the
            # worker-death boundary
            except BaseException as e:  # noqa: BLE001 - resurfaced
                err = SlateError(f"serve: worker thread died: "
                                 f"{type(e).__name__}: {e}")
                with self._cv:
                    self._inflight -= len(live)
                    self._cv.notify_all()
                for it in live:
                    if not it.ticket.done():
                        it.ticket._resolve(error=err)
                raise

    # -- pool callbacks ------------------------------------------------------
    def _chunk_done(self, chunk: Chunk) -> None:
        """An executor finished (or failed) one routed chunk: drop it from
        the in-flight count ``flush()``/admission watch."""
        with self._cv:
            # clamped: a chunk that finishes after the last executor's death
            # zeroed the count must not drive it negative
            self._inflight = max(self._inflight - len(chunk.items), 0)
            self._cv.notify_all()

    def _expire_inflight(self, key: tuple, it: _Pending) -> None:
        """A routed chunk's item crossed its deadline while queued behind
        other chunks in an executor — same typed expiry as the in-queue
        sweep (the executor already took it out of its chunk)."""
        with self._cv:
            self._inflight = max(self._inflight - 1, 0)
            self._cv.notify_all()
        self._expire(key, it)

    def _on_executor_death(self, alive: int, total: int,
                           exc: BaseException) -> None:
        """One executor (not the last) died: re-rate admission to the
        surviving fraction and wake the scheduler (its routing set just
        changed)."""
        self.admission.scale_capacity(alive / total)
        _obs().gauge("slate_serve_executors_alive",
                     "live executors in the serving pool").set(alive)
        with self._cv:
            self._p99_cache.clear()
            self._cv.notify_all()

    def _on_pool_dead(self, exc: BaseException,
                      stranded: List[_Pending]) -> None:
        """The LAST executor died: the whole queue fails fast — every
        queued ticket plus the chunks stranded inside the pool resolve with
        the typed error now."""
        self._on_worker_death(exc, extra=stranded)

    def _expire(self, key: tuple, it: _Pending) -> None:
        """Resolve one past-deadline ticket with its typed error — before
        it wastes a batch slot — and leave the evidence trail."""
        tk = it.ticket
        _, routine, bucket, _ = key
        # the ticket's own lane, not the chunk key's: a continuous-mode
        # join puts (say) an interactive item inside a batch-lane chunk,
        # and its expiry must be attributed to ITS lane
        lane = tk.lane
        bucket_s = "x".join(str(d) for d in bucket)
        elapsed = time.perf_counter() - tk.t_submit
        err = DeadlineExceededError(lane=lane, deadline_s=tk.deadline_s or 0.0,
                                    elapsed_s=elapsed)
        _obs().counter("slate_serve_deadline_expired_total",
                       "tickets expired in-queue past their deadline").inc(
                           lane=lane, routine=routine)
        trace.trace_event("deadline_expired", routine=routine, lane=lane,
                          trace_id=tk.trace_id)
        tk._resolve(error=err)
        self.flight.record(_flight_record(
            it, routine, bucket_s, 0, 0,
            error=f"{type(err).__name__}: {err}", reason="deadline"))

    def _on_worker_death(self, exc: BaseException,
                         extra: Optional[List[_Pending]] = None) -> None:
        """The serving path is gone (scheduler crash, or the pool's last
        executor died): fail every queued and in-flight ticket *now* with
        a typed error instead of letting ``result()`` hang to its timeout,
        and leave counters + flight records behind.  ``extra`` carries
        tickets stranded inside the pool (chunks no survivor could take)."""
        obs = _obs()
        obs.counter("slate_serve_worker_deaths_total",
                    "serving worker threads lost to exceptions").inc(
                        error=type(exc).__name__)
        trace.trace_event("worker_death", error=type(exc).__name__)
        with self._cv:
            self._worker_died = exc
            stranded: List[Tuple[tuple, _Pending]] = []
            for k, items in self._pending.items():
                stranded.extend((k, it) for it in items)
            self._pending.clear()
            self._oldest.clear()
            self._min_deadline.clear()
            for lane in list(self._depths):
                self._depths[lane] = 0
                self._depth_gauge(lane)
            self._depths.clear()
            self._inflight = 0
            self._cv.notify_all()
        err = SlateError(f"serve: worker thread died: "
                         f"{type(exc).__name__}: {exc}")
        last_rec = None
        victims = [it for _, it in stranded] + list(extra or [])
        for it in victims:
            if not it.ticket.done():
                it.ticket._resolve(error=err)
            routine = it.ticket.routine
            m, n, nrhs = it.ticket.shape
            bucket = self.policy.bucket(routine, m, n, nrhs)
            last_rec = _flight_record(
                it, routine, "x".join(str(d) for d in bucket), 0, 0,
                error=f"{type(exc).__name__}: {exc}", reason="worker_death")
            self.flight.record(last_rec)
        if last_rec is not None:
            self.flight.on_exhaustion(last_rec, reason="worker_death")

    # -- telemetry -----------------------------------------------------------
    def capacity_fraction(self) -> float:
        """Live executors / configured executors — 1.0 while healthy; the
        overload harness re-derives its offered-load target from this when
        chaos shrinks the pool mid-run."""
        return self.pool.alive_count() / max(self.pool.size(), 1)

    def executor_depths(self) -> Dict[str, int]:
        """Queued + in-flight chunk count per executor (point-in-time)."""
        return {ex.name: ex.depth() for ex in self.pool.executors}

    def dump_flight(self, path: Optional[str] = None) -> str:
        """Write the flight recorder's ring as JSON (on-demand postmortem);
        returns the path."""
        return self.flight.dump(path)

    def attach_slo(self, monitor) -> None:
        """Attach an :class:`~slate_tpu_torch.obs.slo.SLOMonitor`; its verdicts
        become this queue's admission-control signal: the controller
        consumes them (throttled) on every submit, shedding lanes per the
        :class:`~slate_tpu_torch.serve.admission.AdmissionPolicy` ladder."""
        self._slo_monitor = monitor

    def slo_verdicts(self):
        """Evaluate the attached monitor now ([] when none attached); also
        refreshes the ``slate_slo_*`` gauges."""
        return self._slo_monitor.evaluate() if self._slo_monitor else []

    def slo_status(self) -> Dict[str, int]:
        """The last published SLO verdict codes, straight from the registry
        gauges (``{slo name: 0 ok / 1 warning / 2 breach / -1 no data}``) —
        readable whether this queue, another queue, or an external monitor
        evaluated them."""
        g = _obs().REGISTRY.get("slate_slo_status")
        if g is None:
            return {}
        return {dict(key).get("slo", "?"): int(val)
                for key, val in g.series().items()}

    def lane_depths(self) -> Dict[str, int]:
        """Current pending-ticket count per lane (a point-in-time read)."""
        with self._cv:
            return {lane: d for lane, d in self._depths.items() if d}

    # -- lifecycle -----------------------------------------------------------
    def flush(self, timeout: float = 30.0) -> None:
        """Block until everything pending at call time has been SERVED —
        not merely routed to an executor (tickets resolved, metrics
        recorded)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._cv.notify_all()  # wake the scheduler for age-based flushes
            while any(self._pending.values()) or self._inflight:
                if self._worker_died is not None:
                    return             # death handler already failed tickets
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("serve: flush timed out")
                self._cv.wait(timeout=min(left, 0.05))

    def close(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        # the scheduler drained _pending into the pool before exiting; the
        # pool drains each executor's queued + in-flight chunks
        self.pool.close(max(deadline - time.monotonic(), 0.1))

    def __enter__(self) -> "ServeQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def solve_many(requests: Sequence[Tuple[str, Any, Any]],
               opts: Optional[Options] = None,
               policy: Optional[BucketPolicy] = None,
               cache: Optional[ExecutableCache] = None,
               flight: Optional[FlightRecorder] = None,
               device=None) -> List[Tuple[torch.Tensor, int]]:
    """Synchronous mixed-traffic verb: bucket, pack, and solve ``requests``
    (``(routine, a, b)`` triples) in one pass on ``device`` (default
    ``cuda``; raises without CUDA unless ``device="cpu"``), returning
    ``(x, info)`` per request *in submission order*, x a tensor on
    ``device``.  The deterministic sibling of :class:`ServeQueue` — same
    bucketing/padding/batching policy, no worker thread, no admission
    control (every request runs), on the caller's current stream."""
    device = resolve_device(device)
    policy = policy or BucketPolicy()
    opts = Options.make(opts)
    cache = default_cache() if cache is None else cache
    groups: Dict[tuple, List[Tuple[int, _Pending]]] = {}
    results: List[Optional[Tuple[torch.Tensor, int]]] = [None] * len(requests)
    for i, (routine, a, b) in enumerate(requests):
        key, item = _normalize_request(policy, routine, a, b)
        groups.setdefault(key, []).append((i, item))
    for (routine, bucket, _), pairs in groups.items():
        for c0 in range(0, len(pairs), policy.max_batch):
            chunk = pairs[c0:c0 + policy.max_batch]
            _run_bucket_batch(routine, bucket, [it for _, it in chunk],
                              opts, cache, policy, flight=flight,
                              device=device)
            for i, it in chunk:
                results[i] = it.ticket.result(timeout=0)
    return results  # type: ignore[return-value]
