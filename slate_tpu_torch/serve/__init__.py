"""slate_tpu_torch.serve — the batched solver service (throughput tier).

The "millions of small solves" tier of the JAX package, on CUDA.  Three
layers (BLASX, PAPERS.md, is the exemplar: a software cache + scheduler over
heterogeneous executors):

* **Batched drivers** (:mod:`.batched`): ``gesv_batched`` / ``posv_batched``
  / ``gels_batched`` — the cores (``linalg.gesv_core`` et al.) on torch's
  leading batch axis with per-request ``info`` /
  :class:`~slate_tpu_torch.robust.SolveReport` extraction and
  element-granular escalation ladders (only failed batch elements re-run;
  siblings keep their results).  ``start_batched`` launches with no host
  sync; ``finish_batched`` reads the verdict back once.
* **Prepared-program cache** (:mod:`.cache`): entries keyed by
  ``(routine, shape bucket, batch size, dtype, Options.cache_key())`` — the
  JAX package's keys — each built on its device by one run on identity
  systems, with warm-up API and hit/miss/evict counters in the obs
  registry: zero misses in steady state.
* **Serving queue** (:mod:`.queue`, :mod:`.executor`, :mod:`.admission`):
  :class:`BucketPolicy` (shape bucketing + solution-preserving padding),
  :class:`ServeQueue` (async mixed-traffic packing on max-batch /
  max-wait-ms, admission control, an :class:`ExecutorPool` of executors
  with one CUDA stream each), the synchronous :func:`solve_many` packer,
  the :class:`FlightRecorder`, and :mod:`.workload`'s synthetic traffic and
  solves/sec + p50/p99 measurements.

Every queue, packer and driver serves on ``cuda`` unless given
``device="cpu"`` (numpy operands; a tensor handed to a batched driver keeps
its device), and raises when CUDA is missing and no device was named.

Verb-style usage (the simplified_api.hh idiom)::

    from slate_tpu_torch import serve
    t = serve.submit("gesv", a, b)          # async, default queue (cuda)
    x, info = t.result(timeout=10.0)        # x: a tensor on the card
    results = serve.solve_many([("posv", a1, b1), ("gels", a2, b2)])
    serve.shutdown()

The batch-sharded drivers (``gesv_batched_distributed``,
``posv_batched_distributed``, :mod:`slate_tpu_torch.parallel.batched`) are
re-exported here for bulk offline batches over a process grid.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..core.exceptions import DeadlineExceededError, QueueOverloadError
from .admission import (AdmissionController, AdmissionPolicy, DEFAULT_LANE,
                        EscalationBudget, LANES, TokenBucket,
                        shed_lanes_from_verdicts)
from .batched import (PendingBatch, finish_batched, gels_batched,
                      gesv_batched, last_escalations, posv_batched,
                      set_escalation_gate, start_batched)
from .cache import ExecutableCache, TensorSpec, default_cache, reset_cache
from .executor import Chunk, Executor, ExecutorPool, executable_key
from .flight import FlightRecord, FlightRecorder, validate_flight
from .queue import (BucketPolicy, SERVE_SITE, ServeQueue, Ticket,
                    pad_request, solve_many, unpad_result)
from ..parallel.batched import gesv_batched_distributed, posv_batched_distributed
from .workload import (make_requests, run_continuous_ab,
                       run_mixed_workload, run_overload_workload,
                       run_scale_workload)

__all__ = [
    "gesv_batched", "posv_batched", "gels_batched", "last_escalations",
    "set_escalation_gate", "start_batched", "finish_batched", "PendingBatch",
    "ExecutableCache", "TensorSpec", "default_cache", "reset_cache",
    "Executor", "ExecutorPool", "Chunk", "executable_key",
    "FlightRecord", "FlightRecorder", "validate_flight",
    "BucketPolicy", "ServeQueue", "Ticket", "pad_request", "unpad_result",
    "solve_many", "make_requests", "run_mixed_workload",
    "run_overload_workload", "run_scale_workload", "run_continuous_ab",
    "AdmissionController", "AdmissionPolicy", "DEFAULT_LANE",
    "EscalationBudget", "LANES", "TokenBucket", "shed_lanes_from_verdicts",
    "QueueOverloadError", "DeadlineExceededError", "SERVE_SITE",
    "submit", "default_queue", "shutdown",
    "gesv_batched_distributed", "posv_batched_distributed",
]

_QUEUE: Optional[ServeQueue] = None
_QUEUE_LOCK = threading.Lock()


def default_queue() -> ServeQueue:
    """The process-wide serving queue (created on first use, on ``cuda``)."""
    global _QUEUE
    with _QUEUE_LOCK:
        if _QUEUE is None:
            _QUEUE = ServeQueue()
        return _QUEUE


def submit(routine: str, a, b, lane: str = DEFAULT_LANE,
           deadline: Optional[float] = None) -> Ticket:
    """Submit one solve to the default queue; returns a :class:`Ticket`
    (``.result()`` blocks for ``(x, info)``).  ``lane`` / ``deadline``
    follow :meth:`ServeQueue.submit` (priority lane; seconds of budget)."""
    return default_queue().submit(routine, a, b, lane=lane,
                                  deadline=deadline)


def shutdown() -> None:
    """Drain and stop the default queue (tests / process teardown)."""
    global _QUEUE
    with _QUEUE_LOCK:
        if _QUEUE is not None:
            _QUEUE.close()
        _QUEUE = None
