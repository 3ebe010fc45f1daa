"""Executor pool: the multi-executor serving data path.

The JAX package's pool, on CUDA streams.  Without it, one worker thread
would serialize pad -> lookup -> execute -> resolve for every batch, and
one backend would cap throughput.  This module is the BLASX half of the
design (PAPERS.md — a software cache plus a scheduler routing tasks by cache
residency over heterogeneous executors, stealing across them when one backs
up):

* :class:`Executor` — one serving backend: its own
  :class:`~slate_tpu_torch.serve.cache.ExecutableCache`, a device
  (``cuda:i % device_count``; on one card every executor shares it), its own
  CUDA stream, and TWO threads splitting the batch lifecycle.  The
  **dispatch** thread pads/packs a chunk on the host into pinned memory,
  copies it to the device with ``non_blocking=True`` on the executor's
  stream (tensor operands are copied into their slots on the device
  instead), probes the cache, launches the batch
  (:func:`~slate_tpu_torch.serve.batched.start_batched`, no host sync) and
  records an event; the **resolver** thread waits on that event, runs the
  verdict/escalation half on the same stream and completes tickets
  (:func:`~slate_tpu_torch.serve.batched.finish_batched`).  Host-side
  padding of batch k+1 therefore overlaps device execution of batch k — the
  stage histograms (pad vs execute, both ``executor``-labeled) make the
  overlap directly measurable.
* :class:`ExecutorPool` — N executors behind one
  :class:`~slate_tpu_torch.serve.queue.ServeQueue`.  Each popped bucket
  chunk is routed by **cache residency first** (an executor already holding
  the prepared program for that (routine, bucket, batch, dtype, options)
  key wins), falling back to least-loaded, and **work-stolen** to the
  globally least-loaded executor when the resident home's depth passes
  ``steal_threshold`` (``slate_serve_steals_total`` counts them).
* **Drain-and-reroute death**: a dying executor fails only the batch it
  was dispatching (typed ``worker thread died`` error, ``worker_death``
  flight records, ``slate_serve_worker_deaths_total{executor=}``), its
  already-dispatched batches drain through its resolver, its undispatched
  chunks reroute to survivors (``slate_serve_requeued_chunks_total``), and
  the pool fails-all only when the LAST executor dies — at which point the
  queue's fail-fast contract takes over.

Stream discipline (what rules out the cross-stream races the caching
allocator does not see): every tensor of a batch — the operands copied in,
the outputs, the escalation re-runs — is allocated and used on the
executor's own stream, by both of its threads (the current stream is
per-thread in PyTorch; each thread enters the stream itself).  The pinned
host buffers stay referenced by the in-flight record until the batch is
resolved.  A tensor operand handed in by a caller is read on the executor's
stream only after that stream waits for the event recorded on the caller's
stream at submit, and is ``record_stream``-ed there.  The one tensor that leaves the stream is the solution handed to
the caller: it is recorded on the device's default stream
(``record_stream``), so its memory is not reused for a later batch while
work the caller queued there may still read it.  A caller that reads
results on a stream of its own records them there itself.

The batch machinery itself (padding, ghost slots, stage decomposition,
escalation gating, flight records) lives here too — :mod:`.queue` imports
it for the synchronous :func:`~slate_tpu_torch.serve.queue.solve_many`
packer and re-exports the public names (``pad_request`` et al.) unchanged.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

import numpy as np
import torch

from ..core.exceptions import (NumericalError, SingularMatrixError,
                               SlateError)
from ..core.matrix import resolve_device, torch_dtype
from ..core.types import Options
from ..robust.faults import inject_serve
from ..utils import trace
from . import batched as _batched
from .admission import DEFAULT_LANE
from .cache import ExecutableCache, TensorSpec, dtype_name, stream_ctx
from .flight import FlightRecord, FlightRecorder

#: queue-able routines -> batched driver.  This dict is ALSO the override
#: hook (tests monkeypatch entries): the executors run the overlapped
#: start/finish split only while an entry is the stock driver, and fall
#: back to calling the (possibly patched) entry synchronously otherwise.
DRIVERS = {
    "gesv": _batched.gesv_batched,
    "posv": _batched.posv_batched,
    "gels": _batched.gels_batched,
}

#: pristine snapshot — identity comparison detects patched DRIVERS entries
_STOCK_DRIVERS = dict(DRIVERS)

_OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

#: stage-latency histogram bounds — serving stages live in the us..s range,
#: far below the registry default's multi-minute top end
_STAGE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)

#: the serving-fault injection site (robust.FaultSpec(driver=SERVE_SITE,
#: kind="slow_executor" | "worker_crash" | "cache_flush"[, executor=k]))
SERVE_SITE = "serve_batch"

_TRACE_SEQ = itertools.count(1)


def _new_trace_id(routine: str) -> str:
    """Process-unique request trace id (stitches one request's spans,
    ladder events, and flight record across the chrome-trace)."""
    return f"{routine}-{os.getpid():x}-{next(_TRACE_SEQ):06d}"


def _obs():
    from .. import obs

    return obs


def pad_request(routine: str, a, b, bucket: Tuple[int, int, int]):
    """Embed one request into its bucket shape, solution-preserving.

    Square solves: ``A' = [[A, 0], [0, I]]``, ``b' = [b; 0]`` — the padded
    block solves ``I z = 0`` (SPD-preserving for posv).  Least squares: the
    same block embedding, with the identity carried on the padded rows x
    padded cols corner so the padded normal equations are block-diagonal
    (tall) / the padded minimum-norm system fixes z = 0 (wide).  Host-side
    numpy in and out."""
    bm, bn, br = bucket
    a = np.asarray(a)
    b = np.asarray(b)
    m, n = a.shape[-2:]
    nrhs = b.shape[-1]
    ap = np.zeros((bm, bn), dtype=a.dtype)
    bp = np.zeros((bm, br), dtype=b.dtype)
    _embed(ap, bp, a, b, m, n, nrhs)
    return ap, bp


def _embed(ap: np.ndarray, bp: np.ndarray, a: Optional[np.ndarray],
           b: Optional[np.ndarray], m: int, n: int, nrhs: int) -> None:
    """Write one request into zeroed bucket-shaped slots ``ap``/``bp``: the
    operands in the leading corner (skipped when ``a`` is None: the packer
    copies tensor operands on their device), the identity on the padded
    diagonal."""
    if a is not None:
        ap[:m, :n] = a
        bp[:m, :nrhs] = b
    k = min(ap.shape[0] - m, ap.shape[1] - n)
    if k:
        # the identity block at (m, n); leftover padded rows (tall LS) or
        # cols (wide LS) stay zero — the Gram/QR stays nonsingular because
        # the identity covers the smaller padding side exactly
        ap[m + np.arange(k), n + np.arange(k)] = 1


def unpad_result(x, n: int, nrhs: int):
    return x[..., :n, :nrhs]


class Ticket:
    """Async handle for one submitted request.

    ``result()`` returns ``(x, info)``: x a tensor on the queue's device
    (the unpadded solution), info a python int.  Beyond the result, a
    ticket carries the request's telemetry: a process-unique ``trace_id``
    (every span/event of this request in the chrome-trace carries it),
    per-stage latencies in ``stages`` (submit / queue_wait / pad / cache /
    execute / resolve, seconds), the cache verdict (``cache_hit``), the
    serving executor (``executor``), and the escalation-ladder rungs taken
    (``ladder`` / ``exhausted``) — the same fields the flight recorder
    persists.  The overload contract adds ``lane`` (priority lane) and
    ``deadline_s`` / ``t_deadline`` (the submitted budget and its absolute
    ``perf_counter`` expiry; None = no deadline).  Continuous batching adds
    ``slot_joined``: the request was appended to an already-staged dispatch
    instead of waiting for its own flush window (``stages["slot_join"]`` is
    the submit->join latency; ``queue_wait`` stays the full
    submit->batch-start wait, so joined vs flushed waits are directly
    comparable).
    """

    __slots__ = ("routine", "shape", "_event", "_value", "_error",
                 "t_submit", "t_submit_unix", "latency_s", "trace_id",
                 "stages", "cache_hit", "ladder", "exhausted",
                 "lane", "deadline_s", "t_deadline", "executor",
                 "slot_joined")

    def __init__(self, routine: str, shape, lane: str = DEFAULT_LANE,
                 deadline: Optional[float] = None):
        self.routine = routine
        self.shape = shape
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_submit_unix = time.time()
        self.latency_s: Optional[float] = None
        self.trace_id = _new_trace_id(routine)
        self.stages: Dict[str, float] = {}
        self.cache_hit: Optional[bool] = None
        self.ladder: Tuple[str, ...] = ()
        self.exhausted = False
        self.lane = lane
        self.deadline_s = None if deadline is None else float(deadline)
        self.t_deadline = (None if deadline is None
                           else self.t_submit + float(deadline))
        self.executor = ""
        self.slot_joined = False

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until solved; returns ``(x, info)`` (x unpadded)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.routine} request not served within "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def _resolve(self, value=None, error: Optional[BaseException] = None):
        if self._event.is_set():
            return                       # first resolution wins (death races)
        self.latency_s = time.perf_counter() - self.t_submit
        self._value, self._error = value, error
        self._event.set()


class _Pending:
    """One admitted request: its ticket and operands — numpy arrays, or
    tensors that stay on their device until the packer copies them into
    the batch (``ready``: the event recorded on the submitter's stream after
    a CUDA operand was produced, None otherwise)."""

    __slots__ = ("ticket", "a", "b", "n", "nrhs", "ready")

    def __init__(self, ticket, a, b, n, nrhs, ready=None):
        self.ticket, self.a, self.b = ticket, a, b
        self.n, self.nrhs = n, nrhs
        self.ready = ready


class Chunk:
    """One popped (lane, routine, bucket, dtype) batch of pending requests
    — the routing unit between the queue's scheduler and the pool."""

    __slots__ = ("key", "items")

    def __init__(self, key: tuple, items: Sequence[_Pending]):
        self.key = key
        self.items = list(items)

    @property
    def lane(self) -> str:
        return self.key[0]

    @property
    def routine(self) -> str:
        return self.key[1]

    @property
    def bucket(self) -> Tuple[int, int, int]:
        return self.key[2]

    @property
    def dtype(self) -> str:
        return self.key[3]


def executable_key(policy, opts: Options, routine: str,
                   bucket: Tuple[int, int, int], dtype, n_items: int
                   ) -> tuple:
    """The exact :meth:`ExecutableCache.make_key` a chunk will prepare/hit
    — the residency-routing signal.  Computed host-side from the bucket
    and the rounded batch, no tensors touched."""
    nb = policy.round_batch(n_items)
    bm, bn, br = bucket
    dt = np.dtype(dtype)
    args = [TensorSpec((nb, bm, bn), dt), TensorSpec((nb, bm, br), dt)]
    return ExecutableCache.make_key(routine + "_batched", args, opts, False)


def _stage_hist(obs, name: str, help: str):
    return obs.histogram(name, help, buckets=_STAGE_BUCKETS)


def _flight_record(it: _Pending, routine: str, bucket_s: str, nb: int,
                   n_real: int, error: Optional[str] = None,
                   reason: Optional[str] = None,
                   executor: str = "") -> FlightRecord:
    tk = it.ticket
    info = None
    if error is None and tk._value is not None:
        info = int(tk._value[1])
    return FlightRecord(
        trace_id=tk.trace_id, routine=routine, bucket=bucket_s,
        dtype=dtype_name(it.a.dtype), t_submit_unix=tk.t_submit_unix,
        stages=dict(tk.stages), info=info, cache_hit=tk.cache_hit,
        batch=nb, occupancy=n_real / max(nb, 1), ladder=tk.ladder,
        exhausted=tk.exhausted, error=error, lane=tk.lane, reason=reason,
        deadline_s=tk.deadline_s, executor=executor or tk.executor,
        slot_joined=tk.slot_joined)


def _capped_error(routine: str, info: int) -> NumericalError:
    """The typed error a capped-escalation element resolves with: its own
    numerical failure class, annotated with why no ladder ran (``info==0``
    means the verdict tripped on a non-finite payload, not a pivot)."""
    what = f"info={info}" if info else "non-finite result"
    msg = (f"serve: {routine} element failed ({what}) and the per-window "
           "escalation budget was exhausted — no ladder re-run")
    if info > 0:
        return SingularMatrixError(msg, info=info)
    return NumericalError(msg)


def _pack_batch(routine: str, bucket: Tuple[int, int, int],
                items: Sequence[_Pending], nb: int,
                device: torch.device) -> Tuple[Any, Any, tuple]:
    """Pad + pack one chunk into its (nb, bm, *) operands on ``device`` —
    ghost slots are well-posed identity systems (I x = 0; SPD, full-rank —
    valid for all three routines), NOT copies of the last request: a failing
    real element must not multiply its own failure across the pad and burn
    escalation budget / ladder re-runs on ghosts.

    Numpy requests are written straight into one host buffer per operand
    (pinned on a CUDA device), which also carries every identity pad; each
    buffer goes to the device in one ``non_blocking`` copy on the current
    stream.  Tensor requests never pass through the host: their operands
    are copied slot by slot from where they lie into the batch on the
    device, on the current stream (:func:`_copy_operands`).  Returns ``(A,
    B, host_buffers)``; the caller keeps the host buffers alive until the
    batch is resolved."""
    bm, bn, br = bucket
    dt = torch_dtype(dtype_name(items[0].a.dtype))
    pin = device.type == "cuda"
    A_h = torch.zeros((nb, bm, bn), dtype=dt, pin_memory=pin)
    B_h = torch.zeros((nb, bm, br), dtype=dt, pin_memory=pin)
    an, bnp = A_h.numpy(), B_h.numpy()
    tensors = []
    for i, it in enumerate(items):
        m, n = it.a.shape[-2:]
        if isinstance(it.a, torch.Tensor):
            tensors.append((i, it))
            _embed(an[i], bnp[i], None, None, m, n, it.nrhs)
        else:
            _embed(an[i], bnp[i], it.a, it.b, m, n, it.nrhs)
    if len(items) < nb:
        g = np.arange(min(bm, bn))
        an[len(items):, g, g] = 1
    if device.type == "cpu":
        A, B, host = A_h, B_h, ()
    else:
        A, B = (A_h.to(device, non_blocking=True),
                B_h.to(device, non_blocking=True))
        host = (A_h, B_h)
    for i, it in tensors:
        _copy_operands(A[i], B[i], it)
    return A, B, host


def _copy_operands(a_slot: torch.Tensor, b_slot: torch.Tensor,
                   it: _Pending) -> None:
    """Copy one tensor request into its batch slots on the current stream
    of the slots' device.  That stream first waits for the submitter's
    ``ready`` event, and each operand is recorded on it, so the caching
    allocator does not hand the operand's memory out while the copy may
    still read it."""
    m, n = it.a.shape[-2:]
    cuda = a_slot.is_cuda
    if cuda:
        stream = torch.cuda.current_stream(a_slot.device)
        if it.ready is not None:
            stream.wait_event(it.ready)
        for t in (it.a, it.b):
            if t.device == a_slot.device:
                t.record_stream(stream)
    elif it.ready is not None:
        it.ready.synchronize()           # a card's operand served on the CPU
    a_slot[:m, :n].copy_(it.a, non_blocking=cuda)
    b_slot[:m, :it.nrhs].copy_(it.b, non_blocking=cuda)


def _host_verdict(x: torch.Tensor, info: torch.Tensor
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-element info codes and all-finite flags of a batch, read back
    in one device->host copy: ``(infos, finite)`` as numpy arrays."""
    finite = torch.isfinite(x).flatten(1).all(dim=1)
    both = torch.stack([info.to(torch.int64), finite.to(torch.int64)]).cpu()
    return both[0].numpy(), both[1].numpy().astype(bool)


def _hand_over(x: torch.Tensor) -> None:
    """Record a result produced on a side stream on its device's default
    stream, where callers read it (see the module docstring)."""
    if x.is_cuda:
        default = torch.cuda.default_stream(x.device)
        if torch.cuda.current_stream(x.device) != default:
            x.record_stream(default)


def _deliver_batch(items: Sequence[_Pending], routine: str, bucket_s: str,
                   nb: int, xs: torch.Tensor, infos: np.ndarray,
                   finite: np.ndarray,
                   escal: Dict[int, Dict[str, Any]],
                   cache_info: Optional[Dict[str, Any]],
                   stage_times: Dict[str, float],
                   flight: Optional[FlightRecorder],
                   executor: str = "") -> None:
    """Unpad + resolve every ticket of one executed batch and leave the
    per-request evidence (stage maps, latency histogram, retrospective
    trace spans, flight records).  Shared by the single-thread packer and
    the executors' resolver threads.  ``xs`` stays on the device (each
    ticket gets a view of it); ``infos``/``finite`` are the host verdict."""
    obs = _obs()
    cache_s = (cache_info or {}).get("seconds", 0.0)
    t_pad0, t_pad1 = stage_times["pad0"], stage_times["pad1"]
    t_exec1, exec_s = stage_times["exec1"], stage_times["exec_s"]
    t0 = stage_times["t0"]
    res_spans: List[Tuple[float, float]] = []
    t_res = time.perf_counter()           # stage: unpad + resolve
    for i, it in enumerate(items):
        tk = it.ticket
        tk.stages["pad"] = t_pad1 - t_pad0
        tk.stages["cache"] = cache_s
        tk.stages["execute"] = exec_s
        tk.cache_hit = (cache_info or {}).get("hit")
        tk.executor = executor
        capped = False
        e = escal.get(i)
        if e is not None:
            tk.ladder = tuple(e["rungs"])
            tk.exhausted = not e["recovered"]
            capped = bool(e.get("capped"))
        if int(infos[i]) != 0:
            tk.exhausted = True
        # per-request interval: this request's OWN unpad, stamped before
        # delivery so the waiter sees a complete stage map (only the
        # Event.set itself falls outside the measured interval)
        value = (unpad_result(xs[i], it.n, it.nrhs), int(infos[i]))
        now = time.perf_counter()
        tk.stages["resolve"] = now - t_res
        res_spans.append((t_res, now))
        t_res = now
        # a capped element is bad by info OR by finiteness (the same
        # verdict that queued it for escalation — an overflowed payload
        # can carry info==0)
        if capped and (int(infos[i]) != 0 or not finite[i]):
            # the graceful-degradation contract: a failed element whose
            # ladder re-run the budget refused resolves with its typed
            # error (recovered=False), not a silent bad payload
            tk.exhausted = True
            tk._resolve(error=_capped_error(routine, int(infos[i])))
        else:
            tk._resolve(value)
    exhausted_rec = None
    for i, it in enumerate(items):
        tk = it.ticket
        # the lane label is what lane-level latency SLOs filter on;
        # per-routine SLOs still subset-match on routine alone
        _stage_hist(obs, "slate_serve_latency_seconds",
                    "submit-to-result latency per request").observe(
                        tk.latency_s, routine=routine, lane=tk.lane)
        if trace.recording():
            # retrospective per-request stage spans: one request's lifeline,
            # stitchable from the interleaved timeline by args.trace_id
            common = {"trace_id": tk.trace_id, "routine": routine,
                      "bucket": bucket_s}
            if executor:
                common["executor"] = executor
            trace.emit_span("serve.queue_wait", tk.t_submit, t0, **common)
            trace.emit_span("serve.pad", t_pad0, t_pad1, **common)
            trace.emit_span("serve.cache", t_pad1, t_pad1 + cache_s,
                            hit=tk.cache_hit, **common)
            trace.emit_span("serve.execute", t_pad1 + cache_s, t_exec1,
                            **common)
            trace.emit_span("serve.resolve", *res_spans[i], **common)
        if flight is not None:
            err_s = (f"{type(tk._error).__name__}: {tk._error}"
                     if tk._error is not None else None)
            rec = _flight_record(it, routine, bucket_s, nb, len(items),
                                 error=err_s, executor=executor)
            flight.record(rec)
            if tk.exhausted:
                exhausted_rec = rec
    if flight is not None and exhausted_rec is not None:
        # one dump per batch, after every record is in the ring — a batch of
        # 32 failing elements must not rewrite the ring file 32 times on the
        # serving worker thread (the worker-error path dedupes the same way)
        flight.on_exhaustion(exhausted_rec)


def _fail_batch(items: Sequence[_Pending], routine: str, bucket_s: str,
                nb: int, exc: BaseException,
                flight: Optional[FlightRecorder],
                reason: str = "worker_error",
                resolve_error: Optional[BaseException] = None,
                executor: str = "") -> None:
    """One batch died on a worker exception: surface it on every ticket,
    in the registry, the timeline, and the flight recorder — not only
    through whichever ticket happens to be awaited first."""
    obs = _obs()
    labels = {"routine": routine, "bucket": bucket_s}
    if reason == "worker_error":
        obs.counter("slate_serve_worker_errors_total",
                    "worker-thread exceptions while serving a batch").inc(
                        error=type(exc).__name__, **labels)
        trace.trace_event("worker_error", error=type(exc).__name__, **labels)
    err = resolve_error if resolve_error is not None else exc
    last_rec = None
    for it in items:
        if not it.ticket.done():
            it.ticket._resolve(error=err)
        if flight is not None:
            last_rec = _flight_record(it, routine, bucket_s, nb,
                                      len(items),
                                      error=f"{type(exc).__name__}: {exc}",
                                      reason=reason, executor=executor)
            flight.record(last_rec)
    if flight is not None and last_rec is not None:
        flight.on_exhaustion(last_rec, reason=reason)


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(x.size)


def _record_pad_waste(obs, bucket: Tuple[int, int, int],
                      items: Sequence[_Pending], nb: int,
                      labels: Dict[str, str]) -> None:
    """Dispatch-time padding-waste evidence (the signal a bucket-boundary
    tuner needs): operand elements carrying no real data — shape pad inside
    each real slot plus whole ghost slots — as a counter plus a per-batch
    pad fraction.  Host-side arithmetic only."""
    bm, bn, br = bucket
    slot_elems = bm * bn + bm * br
    real = sum(_numel(it.a) + _numel(it.b) for it in items)
    waste = nb * slot_elems - real
    obs.counter("slate_serve_pad_waste_elems_total",
                "padded operand elements carrying no real data "
                "(shape pad + ghost slots), counted at dispatch").inc(
                    waste, **labels)
    obs.histogram("slate_serve_pad_fraction",
                  "padded-but-not-real fraction of each dispatched batch",
                  buckets=_OCCUPANCY_BUCKETS).observe(
                      waste / max(nb * slot_elems, 1), **labels)


def _batch_counters(obs, labels: Dict[str, str], n_items: int, nb: int,
                    t0: float) -> None:
    obs.counter("slate_serve_batches_total",
                "executed batches").inc(**labels)
    obs.histogram("slate_serve_batch_occupancy",
                  "real requests / padded batch slots",
                  buckets=_OCCUPANCY_BUCKETS).observe(
                      n_items / max(nb, 1), **labels)
    obs.histogram("slate_serve_batch_seconds",
                  "wall time per executed batch").observe(
                      time.perf_counter() - t0, **labels)


def _run_bucket_batch(routine: str, bucket: Tuple[int, int, int],
                      items: Sequence[_Pending], opts: Options,
                      cache: ExecutableCache, policy,
                      flight: Optional[FlightRecorder] = None,
                      esc_gate: Optional[Callable[[int], int]] = None,
                      device: Optional[torch.device] = None) -> None:
    """Pad + pack one bucket's requests onto ``device``, run the batched
    driver on the current stream, distribute — the single-thread
    composition the synchronous :func:`solve_many` packer runs (the
    executors split the same stages across their dispatch/resolve threads
    instead).

    Stage decomposition (per request, into ``ticket.stages`` + the
    ``slate_serve_*_seconds`` histograms + synthesized chrome-trace spans):
    queue_wait (submit -> batch start, per request), pad (host-side pack +
    copy), cache (lookup + possible build, from the cache's per-call probe),
    execute (launch + compute + verdict sync, the driver call with the
    cache share subtracted), resolve (unpad + ticket delivery).

    ``esc_gate`` (the queue's escalation budget) caps how many failed
    elements may ladder-re-run; capped elements resolve with their typed
    numerical error.  Serving chaos (an active
    :class:`~slate_tpu_torch.robust.FaultPlan` with ``serve``-point specs at
    :data:`SERVE_SITE`) fires here, before the batch executes:
    ``slow_executor`` stalls, ``cache_flush`` wipes the cache,
    ``worker_crash`` raises — which in the pool kills that executor and
    exercises drain-and-reroute (fail-fast when it was the last one).
    """
    obs = _obs()
    device = resolve_device(device)
    bucket_s = "x".join(str(d) for d in bucket)
    labels = {"routine": routine, "bucket": bucket_s}
    for spec in inject_serve(SERVE_SITE):
        if spec.kind == "slow_executor":
            time.sleep(spec.delay_s)
        elif spec.kind == "cache_flush":
            cache.drop()
            obs.counter("slate_serve_cache_flushes_total",
                        "chaos-injected executable-cache wipes").inc(**labels)
        elif spec.kind == "worker_crash":
            # deliberately NOT a SlateError: simulates an unexpected crash
            # (the class the worker-death handler must survive)
            raise RuntimeError("chaos: injected worker crash")
    t0 = time.perf_counter()
    nb = policy.round_batch(len(items))
    _record_pad_waste(obs, bucket, items, nb, labels)
    for it in items:                      # stage: queue wait (per request)
        wait = t0 - it.ticket.t_submit
        it.ticket.stages["queue_wait"] = wait
        _stage_hist(obs, "slate_serve_queue_wait_seconds",
                    "submit-to-batch-start wait per request").observe(
                        wait, routine=routine)
    prev_gate = _batched.set_escalation_gate(esc_gate)
    try:
        t_pad0 = time.perf_counter()      # stage: pad + pack
        A, B, _host = _pack_batch(routine, bucket, items, nb, device)
        t_pad1 = time.perf_counter()
        _stage_hist(obs, "slate_serve_pad_seconds",
                    "host-side pad+pack time per batch").observe(
                        t_pad1 - t_pad0, **labels)
        # stage: cache + execute.  The batch-level span waits for the
        # device before closing (device_sync) so asynchronous launches
        # cannot masquerade as compute time; the per-element escalation
        # below the driver sees the owning request ids via the batch scope.
        with trace.batch_request_scope([it.ticket.trace_id for it in items]):
            # ("routine" is scope()'s span-name slot; the serving routine
            # rides as the "driver" label instead)
            with obs.scope("serve.execute_batch", device_sync=True,
                           driver=routine, bucket=bucket_s) as sp:
                drv = DRIVERS[routine]
                # ghost-slot accounting (n_real) is a stock-driver contract;
                # a monkeypatched driver keeps the pre-continuous signature
                kw = ({"n_real": len(items)}
                      if drv is _STOCK_DRIVERS.get(routine) else {})
                out = drv(A, B, opts, cache=cache, **kw)
                x, info = out[0], out[-1]
                sp.set_result(x)
            escal = _batched.last_escalations()
        t_exec1 = time.perf_counter()
        cache_info = cache.last_lookup()
        cache_s = (cache_info or {}).get("seconds", 0.0)
        exec_s = max(t_exec1 - t_pad1 - cache_s, 0.0)
        _stage_hist(obs, "slate_serve_execute_seconds",
                    "device execute time per batch (cache share "
                    "subtracted, result waited for)").observe(
                        exec_s, **labels)
        infos, finite = _host_verdict(x, info)
    # the exception (taxonomy included) is re-surfaced on every pending
    # ticket, whose result() call re-raises it in the submitter's thread;
    # raising here would instead kill the queue worker and strand the other
    # buckets
    except BaseException as e:  # noqa: BLE001 - surfaced on every ticket
        _fail_batch(items, routine, bucket_s, nb, e, flight)
        return
    finally:
        _batched.set_escalation_gate(prev_gate)
        _batch_counters(obs, labels, len(items), nb, t0)
    _deliver_batch(items, routine, bucket_s, nb, x, infos, finite, escal,
                   cache_info,
                   {"t0": t0, "pad0": t_pad0, "pad1": t_pad1,
                    "exec1": t_exec1, "exec_s": exec_s}, flight)


class _InFlight:
    """One dispatched-but-unresolved batch riding between an executor's
    dispatch and resolver threads."""

    __slots__ = ("chunk", "nb", "bucket_s", "labels", "t0", "t_pad0",
                 "t_pad1", "t_exec1", "pending", "sync_out", "sync_escal",
                 "cache_info", "error", "event", "host")

    def __init__(self, chunk: Chunk, nb: int, bucket_s: str,
                 labels: Dict[str, str], t0: float):
        self.chunk, self.nb = chunk, nb
        self.bucket_s, self.labels, self.t0 = bucket_s, labels, t0
        self.t_pad0 = self.t_pad1 = self.t_exec1 = t0
        self.pending: Optional[_batched.PendingBatch] = None
        self.sync_out: Optional[Tuple[Any, Any]] = None
        self.sync_escal: Optional[Dict[int, Dict[str, Any]]] = None
        self.cache_info: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        #: recorded on the executor's stream after the launch; the resolver
        #: waits on it before reading anything back
        self.event: Optional[torch.cuda.Event] = None
        #: the pinned host buffers of the operands' copy (kept until resolve)
        self.host: tuple = ()


def _executor_device(pool_device: torch.device, index: int) -> torch.device:
    """Executor ``index``'s device: round-robin over the visible CUDA cards
    (``cuda:i % device_count``; on one card all executors share it), or the
    pool's device itself when that is not CUDA."""
    if pool_device.type != "cuda":
        return pool_device
    if pool_device.index is not None:
        return pool_device
    count = torch.cuda.device_count()
    if count < 1:
        raise SlateError("serve: no CUDA device is visible")
    return torch.device("cuda", index % count)


class Executor:
    """One serving backend of the pool: its own cache, device, CUDA stream,
    and the dispatch/resolve thread pair (see module docstring).

    ``depth()`` — queued + in-flight chunks — is the pool's load signal
    for least-loaded routing and work-stealing, published live as
    ``slate_serve_executor_depth{executor=}``.
    """

    def __init__(self, index: int, pool: "ExecutorPool",
                 cache: ExecutableCache, policy, opts: Options,
                 flight: Optional[FlightRecorder],
                 esc_gate: Optional[Callable[[int], int]] = None,
                 inflight_limit: int = 2,
                 device: Optional[torch.device] = None):
        self.index = int(index)
        self.name = f"ex{index}"
        self.pool = pool
        self.cache = cache
        self.policy = policy
        self.opts = opts
        self.flight = flight
        self.esc_gate = esc_gate
        #: dispatched-but-unresolved bound: how far ahead of the resolver
        #: the dispatcher may run (the pad/execute overlap window)
        self.inflight_limit = max(int(inflight_limit), 1)
        self.device = _executor_device(resolve_device(device), self.index)
        #: this executor's stream (None on the CPU); the device error, if
        #: the card cannot be reached, kills the dispatcher on its first
        #: step — a typed executor death the pool handles
        self.stream = None
        self._device_error: Optional[BaseException] = None
        if self.device.type == "cuda":
            try:
                self.stream = torch.cuda.Stream(device=self.device)
            except Exception as e:  # noqa: BLE001 - raised typed at start
                self._device_error = SlateError(
                    f"serve: executor {self.name} cannot reach "
                    f"{self.device}: {type(e).__name__}: {e}")
        cache.device, cache.stream = self.device, self.stream
        self.dead: Optional[BaseException] = None
        self.closed = False
        self._cv = threading.Condition()
        self._work: "deque[Chunk]" = deque()
        self._resolve_q: "deque[_InFlight]" = deque()
        self._depth = 0                  # queued + in-flight chunks
        self._current: Optional[Chunk] = None
        self._dispatch_done = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"slate-serve-{self.name}-dispatch")
        self._resolver = threading.Thread(
            target=self._resolve_loop, daemon=True,
            name=f"slate-serve-{self.name}-resolve")
        self._started = False

    # -- pool-facing surface -------------------------------------------------
    def start(self) -> None:
        if not self._started:
            self._started = True
            self._dispatcher.start()
            self._resolver.start()

    def alive(self) -> bool:
        return self.dead is None and not self.closed

    def depth(self) -> int:
        with self._cv:
            return self._depth

    def enqueue(self, chunk: Chunk) -> None:
        with self._cv:
            if self.dead is not None or self.closed:
                raise SlateError(f"serve: executor {self.name} is not "
                                 "accepting work")
            self._work.append(chunk)
            self._depth += 1
            self._cv.notify_all()
        self._publish_depth()

    def try_join(self, key: tuple, item: _Pending, join_max: int) -> bool:
        """Continuous batching: append ``item`` to a staged chunk —
        queued in ``_work`` but not yet dispatched — whose
        (routine, bucket, dtype) matches ``key`` and whose occupancy is
        below ``join_max``.  Lanes may differ (a batch-lane staged chunk
        absorbs an interactive arrival; the joined ticket keeps its own
        lane for SLOs and expiry).  Returns False when nothing here is
        joinable; ``_depth`` counts chunks, so a join changes nothing."""
        with self._cv:
            if self.dead is not None or self.closed:
                return False
            for chunk in self._work:
                if (chunk.key[1:] == key[1:]
                        and len(chunk.items) < join_max):
                    chunk.items.append(item)
                    return True
        return False

    def close(self) -> None:
        """Stop accepting work; the dispatcher drains ``_work`` and the
        resolver drains the in-flight queue before the threads exit."""
        with self._cv:
            self.closed = True
            self._cv.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._started:
            deadline = None if timeout is None else \
                time.monotonic() + timeout
            self._dispatcher.join(timeout)
            left = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            self._resolver.join(left)

    def _publish_depth(self) -> None:
        _obs().gauge("slate_serve_executor_depth",
                     "queued + in-flight chunks per executor").set(
                         self.depth(), executor=self.name)

    # -- dispatch thread -----------------------------------------------------
    def _dispatch_loop(self) -> None:
        try:
            if self._device_error is not None:
                raise self._device_error
            while True:
                with self._cv:
                    while self.dead is None and (
                            (not self._work and not self.closed)
                            or (self._work and len(self._resolve_q)
                                >= self.inflight_limit)):
                        self._cv.wait()
                    if self.dead is not None:
                        return
                    if not self._work:
                        return           # closed and drained
                    chunk = self._work.popleft()
                    self._current = chunk
                inf = self._dispatch(chunk)
                with self._cv:
                    self._current = None
                    if inf is not None:
                        self._resolve_q.append(inf)
                    else:
                        # every item expired at dispatch time: nothing to
                        # resolve, close out the chunk here
                        self._depth -= 1
                    self._cv.notify_all()
                if inf is None:
                    self._publish_depth()
                    self.pool.chunk_done(self, chunk)
        # the death boundary: _die fails the in-flight batch's tickets with
        # the typed error and reroutes pending chunks; no solve runs after
        except BaseException as e:  # noqa: BLE001 - drain-and-reroute
            self._die(e)
        finally:
            with self._cv:
                self._dispatch_done = True
                self._cv.notify_all()

    def _sweep_deadlines(self, chunk: Chunk) -> bool:
        """Expire chunk items whose deadline has passed (same typed expiry
        as the queue's in-_pending sweep).  Returns False when the chunk
        emptied — nothing left worth a batch slot."""
        now = time.perf_counter()
        expired = [it for it in chunk.items
                   if it.ticket.t_deadline is not None
                   and now >= it.ticket.t_deadline
                   and not it.ticket.done()]
        if expired:
            chunk.items = [it for it in chunk.items if it not in expired]
            for it in expired:
                self.pool.item_expired(chunk.key, it)
        return bool(chunk.items)

    def _dispatch(self, chunk: Chunk) -> Optional[_InFlight]:
        """Host half of one batch: deadline sweep, chaos hook, pad/pack,
        the copy to the device, cache probe, and the launch — no sync; the
        resolver owns completion.  Returns None when every item expired."""
        obs = _obs()
        routine, bucket = chunk.routine, chunk.bucket
        # dispatch-time deadline sweep: a chunk can sit behind others in
        # this executor's queue past some items' deadlines — they get the
        # same typed expiry as the queue's in-_pending sweep, and never
        # waste a batch slot
        if not self._sweep_deadlines(chunk):
            return None
        bucket_s = "x".join(str(d) for d in bucket)
        labels = {"routine": routine, "bucket": bucket_s}
        # the chaos hook fires OUTSIDE the try: worker_crash is an executor
        # death (drain-and-reroute), not a per-batch worker_error
        for spec in inject_serve(SERVE_SITE, executor=self.index):
            if spec.kind == "slow_executor":
                time.sleep(spec.delay_s)
            elif spec.kind == "cache_flush":
                self.cache.drop()
                obs.counter("slate_serve_cache_flushes_total",
                            "chaos-injected executable-cache wipes").inc(
                                **labels)
            elif spec.kind == "worker_crash":
                raise RuntimeError("chaos: injected worker crash")
        # re-sweep: a chaos stall (slow_executor) may have carried us past
        # deadlines that were live at pop time — expire, don't serve late
        if not self._sweep_deadlines(chunk):
            return None
        items = chunk.items
        t0 = time.perf_counter()
        nb = self.policy.round_batch(len(items))
        ex_labels = dict(labels, executor=self.name)
        _record_pad_waste(obs, bucket, items, nb, ex_labels)
        for it in items:                  # stage: queue wait (per request)
            wait = t0 - it.ticket.t_submit
            it.ticket.stages["queue_wait"] = wait
            _stage_hist(obs, "slate_serve_queue_wait_seconds",
                        "submit-to-batch-start wait per request").observe(
                            wait, routine=routine)
        inf = _InFlight(chunk, nb, bucket_s, labels, t0)
        try:
            inf.t_pad0 = time.perf_counter()
            with stream_ctx(self.stream):
                A, B, inf.host = _pack_batch(routine, bucket, items, nb,
                                             self.device)
                inf.t_pad1 = time.perf_counter()
                _stage_hist(obs, "slate_serve_pad_seconds",
                            "host-side pad+pack time per batch").observe(
                                inf.t_pad1 - inf.t_pad0, executor=self.name,
                                **labels)
                drv = DRIVERS.get(routine)
                if drv is not None and drv is _STOCK_DRIVERS.get(routine):
                    # the overlapped path: launch the batch and hand the
                    # pending batch to the resolver thread
                    inf.pending = _batched.start_batched(
                        routine + "_batched", A, B, opts=self.opts,
                        cache=self.cache, n_real=len(items))
                    if self.stream is not None:
                        inf.event = torch.cuda.Event()
                        inf.event.record(self.stream)
                else:
                    # patched/custom driver (DRIVERS is the override hook):
                    # run it synchronously here — no split available for an
                    # arbitrary callable
                    prev_gate = _batched.set_escalation_gate(self.esc_gate)
                    try:
                        with trace.batch_request_scope(
                                [it.ticket.trace_id for it in items]):
                            out = drv(A, B, self.opts, cache=self.cache)
                            inf.sync_escal = _batched.last_escalations()
                    finally:
                        _batched.set_escalation_gate(prev_gate)
                    inf.sync_out = (out[0], out[-1])
                    inf.t_exec1 = time.perf_counter()
            # the cache probe is thread-local: read it HERE, on the thread
            # that did the lookup, before handing off to the resolver
            inf.cache_info = self.cache.last_lookup()
        # the error rides the in-flight record to the resolver, which
        # re-surfaces it on every ticket of this batch (worker_error path);
        # the executor survives
        except BaseException as e:  # noqa: BLE001 - surfaced per ticket
            inf.error = e
        return inf

    # -- resolver thread -----------------------------------------------------
    def _resolve_loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while (not self._resolve_q and not self._dispatch_done
                           and self.dead is None):
                        self._cv.wait()
                    if not self._resolve_q:
                        # dead or closed+drained; either way nothing more
                        # will be dispatched (already-dispatched batches
                        # above were drained first)
                        return
                    inf = self._resolve_q.popleft()
                    self._cv.notify_all()     # free the dispatcher's slot
                self._resolve(inf)
                with self._cv:
                    self._depth -= 1
                    self._cv.notify_all()
                self._publish_depth()
                self.pool.chunk_done(self, inf.chunk)
        # the death boundary: _die re-surfaces the exception on the
        # stranded tickets
        except BaseException as e:  # noqa: BLE001 - drain-and-reroute
            self._die(e)

    def _resolve(self, inf: _InFlight) -> None:
        """Device half of one batch: wait for the launch's event, verdict/
        escalate on the executor's stream, deliver tickets.  Never raises —
        a failure is the worker_error path (this batch's tickets fail, the
        executor survives)."""
        obs = _obs()
        chunk, items, nb = inf.chunk, inf.chunk.items, inf.nb
        routine, bucket_s = chunk.routine, inf.bucket_s
        try:
            if inf.error is not None:
                raise inf.error
            with stream_ctx(self.stream):
                if inf.sync_out is not None:
                    x, info = inf.sync_out
                    escal = inf.sync_escal or {}
                    t_exec1 = inf.t_exec1
                else:
                    if inf.event is not None:
                        inf.event.synchronize()
                    prev_gate = _batched.set_escalation_gate(self.esc_gate)
                    try:
                        with trace.batch_request_scope(
                                [it.ticket.trace_id for it in items]):
                            payload, info, _reports = \
                                _batched.finish_batched(inf.pending)
                            x = payload[0]
                            escal = _batched.last_escalations()
                    finally:
                        _batched.set_escalation_gate(prev_gate)
                    t_exec1 = time.perf_counter()
                    inf.t_exec1 = t_exec1
                infos, finite = _host_verdict(x, info)
                _hand_over(x)
            inf.host = ()
            cache_s = (inf.cache_info or {}).get("seconds", 0.0)
            exec_s = max(t_exec1 - inf.t_pad1 - cache_s, 0.0)
            _stage_hist(obs, "slate_serve_execute_seconds",
                        "device execute time per batch (cache share "
                        "subtracted, result waited for)").observe(
                            exec_s, executor=self.name, **inf.labels)
            if trace.recording():
                trace.emit_span("serve.execute_batch", inf.t_pad1, t_exec1,
                                driver=routine, bucket=bucket_s,
                                executor=self.name)
        # re-surfaced on every ticket of this batch (worker_error), the
        # executor keeps serving
        except BaseException as e:  # noqa: BLE001 - surfaced per ticket
            _fail_batch(items, routine, bucket_s, nb, e, self.flight,
                        executor=self.name)
            return
        finally:
            _batch_counters(obs, inf.labels, len(items), nb, inf.t0)
        _deliver_batch(items, routine, bucket_s, nb, x, infos, finite, escal,
                       inf.cache_info,
                       {"t0": inf.t0, "pad0": inf.t_pad0,
                        "pad1": inf.t_pad1, "exec1": t_exec1,
                        "exec_s": exec_s},
                       self.flight, executor=self.name)

    # -- death ---------------------------------------------------------------
    def _die(self, exc: BaseException) -> None:
        """Drain-and-reroute: fail ONLY the batch this executor was
        actively working (typed error), hand undispatched chunks back to
        the pool for surviving executors, and let already-dispatched
        batches drain through whichever of the two threads is still
        alive."""
        with self._cv:
            if self.dead is not None:
                return                    # one death per executor
            self.dead = exc
            pending = list(self._work)
            self._work.clear()
            failed = self._current
            self._current = None
            self._depth = len(self._resolve_q)
            self._cv.notify_all()
        self._publish_depth()
        obs = _obs()
        obs.counter("slate_serve_worker_deaths_total",
                    "serving worker threads lost to exceptions").inc(
                        error=type(exc).__name__, executor=self.name)
        trace.trace_event("worker_death", error=type(exc).__name__,
                          executor=self.name)
        self.pool.on_executor_died(self, exc, pending, failed)


class ExecutorPool:
    """N executors behind one serving queue: residency-aware routing,
    least-loaded fallback, work-stealing, drain-and-reroute death (see
    module docstring).

    The pool owns the residency index — every executor cache reports
    inserts/evictions/wipes through the :class:`ExecutableCache` hooks —
    and three callbacks wire it to the queue: ``on_chunk_done(chunk)``
    (accounting), ``on_executor_death(alive, total, exc)`` (capacity
    recalibration), ``on_all_dead(exc, stranded_items)`` (the fail-fast
    endgame).  ``device`` is where the executors serve (default ``cuda``,
    executor i on ``cuda:i % device_count``; raises without CUDA unless
    ``device="cpu"``).
    """

    def __init__(self, n: int, policy, opts: Options,
                 caches: Sequence[ExecutableCache],
                 flight: Optional[FlightRecorder] = None,
                 esc_gate: Optional[Callable[[int], int]] = None,
                 steal_threshold: int = 4,
                 inflight_limit: int = 2,
                 join_max: Optional[int] = None,
                 on_chunk_done: Optional[Callable[[Chunk], None]] = None,
                 on_item_expired: Optional[
                     Callable[[tuple, _Pending], None]] = None,
                 on_executor_death: Optional[
                     Callable[[int, int, BaseException], None]] = None,
                 on_all_dead: Optional[
                     Callable[[BaseException, List[_Pending]], None]] = None,
                 device=None):
        if n < 1:
            raise SlateError(f"serve: executor pool needs >= 1 executor, "
                             f"got {n}")
        if len(caches) != n:
            raise SlateError(f"serve: {n} executors need {n} caches, "
                             f"got {len(caches)}")
        self.policy = policy
        self.opts = opts
        self.device = resolve_device(device)
        #: continuous batching: when set (the policy's max_batch), staged
        #: chunks are joinable — submit-time arrivals via :meth:`try_join`,
        #: scheduler pops merged into a staged same-key chunk at dispatch
        self.join_max = None if join_max is None else max(int(join_max), 1)
        self.steal_threshold = max(int(steal_threshold), 1)
        #: per-executor work acceptance bound: deep enough for imbalance to
        #: trigger steals, shallow enough that lane priority is re-decided
        #: at the queue, not buried in executor deques
        self.queue_bound = self.steal_threshold + 2
        self._on_chunk_done = on_chunk_done
        self._on_item_expired = on_item_expired
        self._on_executor_death = on_executor_death
        self._on_all_dead = on_all_dead
        self._lock = threading.Lock()
        #: executable key -> executor indices holding the prepared program
        self._residency: Dict[tuple, set] = {}
        self.executors: List[Executor] = []
        for i in range(n):
            self._wire_cache(caches[i], i)
            self.executors.append(Executor(
                i, self, caches[i], policy, opts, flight,
                esc_gate=esc_gate, inflight_limit=inflight_limit,
                device=self.device))
        self.steals = 0

    # -- residency index -----------------------------------------------------
    def _wire_cache(self, cache: ExecutableCache, index: int) -> None:
        cache.owner = f"ex{index}"
        cache.on_insert = lambda key, i=index: self._note_insert(key, i)
        cache.on_evict = lambda key, i=index: self._note_evict(key, i)
        cache.on_drop = lambda i=index: self._note_drop(i)

    def _note_insert(self, key: tuple, index: int) -> None:
        with self._lock:
            self._residency.setdefault(key, set()).add(index)

    def _note_evict(self, key: tuple, index: int) -> None:
        with self._lock:
            holders = self._residency.get(key)
            if holders is not None:
                holders.discard(index)
                if not holders:
                    del self._residency[key]

    def _note_drop(self, index: int) -> None:
        with self._lock:
            for key in [k for k, holders in self._residency.items()
                        if index in holders]:
                self._residency[key].discard(index)
                if not self._residency[key]:
                    del self._residency[key]

    def residency(self, key: tuple) -> Tuple[int, ...]:
        """Executor indices currently holding ``key`` (diagnostics + the
        routing tests)."""
        with self._lock:
            return tuple(sorted(self._residency.get(key, ())))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        for ex in self.executors:
            ex.start()

    def caches(self) -> List[ExecutableCache]:
        return [ex.cache for ex in self.executors]

    def alive(self) -> List[Executor]:
        return [ex for ex in self.executors if ex.dead is None]

    def alive_count(self) -> int:
        return len(self.alive())

    def size(self) -> int:
        return len(self.executors)

    def has_starved(self) -> bool:
        """Whether some live executor is fully idle (nothing staged,
        nothing in flight) — continuous batching's eager-flush gate: while
        an executor starves, any occupancy is worth dispatching NOW; once
        the whole pool is busy, eager flushing would only shred buckets
        into ghost-padded slivers that a staged join must then repair."""
        return any(ex.depth() == 0 for ex in self.executors
                   if ex.dead is None and not ex.closed)

    def can_accept(self) -> bool:
        """Whether some live executor has room — the scheduler's gate for
        popping the next chunk (keeps executor deques shallow so lane
        priority stays a queue-level decision)."""
        return any(ex.depth() < self.queue_bound for ex in self.executors
                   if ex.dead is None and not ex.closed)

    def close(self, timeout: float = 30.0) -> None:
        for ex in self.executors:
            ex.close()
        deadline = time.monotonic() + timeout
        for ex in self.executors:
            ex.join(max(deadline - time.monotonic(), 0.0))

    # -- routing -------------------------------------------------------------
    def try_join(self, key: tuple, item: _Pending) -> Optional[Executor]:
        """Continuous batching's submit path: offer ``item`` to every live
        executor's staged (queued-not-dispatched) chunks; the first with a
        matching (routine, bucket, dtype) chunk below ``join_max`` takes
        it.  Returns the joining executor, or None when no staged slot is
        open (the caller falls back to the pending queue)."""
        if self.join_max is None:
            return None
        for ex in self.executors:
            if ex.dead is None and not ex.closed \
                    and ex.try_join(key, item, self.join_max):
                return ex
        return None

    def _merge_staged(self, chunk: Chunk) -> Optional[Executor]:
        """Continuous batching's scheduler path: fold a freshly popped
        chunk into a staged same-(routine, bucket, dtype) chunk with room
        for ALL its items — one bigger dispatch instead of two small ones
        (no new chunk, no depth change).  Partial merges are deliberately
        not attempted: splitting a chunk would split its completion
        accounting."""
        for ex in self.executors:
            if ex.dead is not None or ex.closed:
                continue
            with ex._cv:
                if ex.dead is not None or ex.closed:
                    continue
                for staged in ex._work:
                    if (staged.key[1:] == chunk.key[1:]
                            and len(staged.items) + len(chunk.items)
                            <= self.join_max):
                        staged.items.extend(chunk.items)
                        _obs().counter(
                            "slate_serve_staged_merges_total",
                            "popped chunks folded into a staged same-key "
                            "dispatch (continuous batching)").inc(
                                routine=chunk.routine, executor=ex.name)
                        return ex
        return None

    def dispatch(self, chunk: Chunk) -> Executor:
        """Route one chunk: staged-merge first (continuous mode), then
        residency, least-loaded fallback, steal past the threshold.
        Raises :class:`SlateError` when no executor is live."""
        if self.join_max is not None:
            ex = self._merge_staged(chunk)
            if ex is not None:
                return ex
        ex = self._route(chunk)
        if ex is None:
            raise SlateError("serve: no live executors")
        ex.enqueue(chunk)
        return ex

    def _route(self, chunk: Chunk) -> Optional[Executor]:
        alive = [ex for ex in self.executors
                 if ex.dead is None and not ex.closed]
        if not alive:
            return None
        if len(alive) == 1:
            return alive[0]
        by_load = min(alive, key=lambda ex: (ex.depth(), ex.index))
        key = executable_key(self.policy, self.opts, chunk.routine,
                             chunk.bucket, chunk.dtype, len(chunk.items))
        with self._lock:
            holders = set(self._residency.get(key, ()))
        resident = [ex for ex in alive if ex.index in holders]
        if not resident:
            return by_load               # cold key: least-loaded builds it
        home = min(resident, key=lambda ex: (ex.depth(), ex.index))
        home_depth = home.depth()
        if home_depth >= self.steal_threshold and by_load is not home \
                and by_load.depth() < home_depth:
            # the residency win is not worth the line: steal to the
            # least-loaded executor (it builds/receives the program)
            self.steals += 1
            _obs().counter("slate_serve_steals_total",
                           "chunks stolen from a backed-up resident "
                           "executor").inc(routine=chunk.routine,
                                           src=home.name, dst=by_load.name)
            trace.trace_event("work_steal", routine=chunk.routine,
                              src=home.name, dst=by_load.name)
            return by_load
        return home

    # -- executor callbacks --------------------------------------------------
    def chunk_done(self, ex: Executor, chunk: Chunk) -> None:
        if self._on_chunk_done is not None:
            self._on_chunk_done(chunk)

    def item_expired(self, key: tuple, it: _Pending) -> None:
        """An executor swept one past-deadline item out of a routed chunk
        at dispatch time — forward to the queue's expiry path (typed
        error + evidence trail)."""
        if self._on_item_expired is not None:
            self._on_item_expired(key, it)

    def on_executor_died(self, ex: Executor, exc: BaseException,
                         pending: List[Chunk],
                         failed: Optional[Chunk]) -> None:
        """One executor down: fail its in-flight batch, reroute its
        pending chunks to survivors (fail-all only when none remain).

        When it was the last executor, the queue turns fail-fast BEFORE the
        dying batch's tickets fail: a caller whose ``result()`` raised sees
        its next ``submit`` refused, with no window in which a fresh ticket
        is still admitted and then stranded."""
        survivors = self.alive()
        if not survivors:
            self._strand(exc, pending)
        if failed is not None:
            bucket_s = "x".join(str(d) for d in failed.bucket)
            err = SlateError(
                f"serve: executor {ex.name} worker thread died "
                f"({type(exc).__name__}: {exc})")
            _fail_batch(failed.items, failed.routine, bucket_s,
                        self.policy.round_batch(len(failed.items)), exc,
                        ex.flight, reason="worker_death",
                        resolve_error=err, executor=ex.name)
            self.chunk_done(ex, failed)
        if survivors:
            rerouted = 0
            for chunk in pending:
                try:
                    self.dispatch(chunk)
                    rerouted += 1
                except SlateError:
                    # the survivor died between alive() and enqueue: the
                    # recursive death handling reroutes or fails-all
                    self._strand(exc, [chunk])
            if rerouted:
                _obs().counter(
                    "slate_serve_requeued_chunks_total",
                    "chunks rerouted off a dying executor").inc(
                        executor=ex.name)
            if self._on_executor_death is not None:
                self._on_executor_death(len(survivors),
                                        len(self.executors), exc)

    def _strand(self, exc: BaseException, chunks: List[Chunk]) -> None:
        items = [it for ch in chunks for it in ch.items]
        if self._on_all_dead is not None:
            self._on_all_dead(exc, items)
