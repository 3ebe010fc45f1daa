"""The solver-resilience layer.

* **Fault injection** (:mod:`.faults`): :class:`FaultPlan` / :class:`FaultSpec`
  — seeded, deterministic corruption of driver operands/factors/outputs,
  addressed by driver name, call index and tile coordinate, plus the serving
  faults (``POINT_SERVE``: ``slow_executor`` / ``worker_crash`` /
  ``cache_flush``, fired through :func:`inject_serve`).
* **Health propagation** (:mod:`.report`): :class:`SolveReport` plus the shared
  info kernels :func:`first_bad_index` / :func:`reduce_info`.
* **Escalation policies** (:mod:`.policy`): :class:`RetryPolicy`,
  :class:`Rung` / :func:`run_ladder` (declared ladders: mixed→full,
  RBT→partial-pivot, nopiv→partial-pivot), :func:`guard_shards`, and the
  :data:`LADDERS` registry of every driver's escalation order.
"""

from .faults import (FaultPlan, FaultSpec, POINT_FACTOR, POINT_INPUT,
                     POINT_OUTPUT, POINT_SERVE, active, inject, inject_serve)
from .policy import LADDERS, RetryPolicy, Rung, guard_shards, run_ladder
from .report import (SolveReport, first_bad_index, first_bad_index_batched,
                     reduce_info)

__all__ = [
    "FaultPlan", "FaultSpec", "POINT_FACTOR", "POINT_INPUT", "POINT_OUTPUT",
    "POINT_SERVE", "active", "inject", "inject_serve", "LADDERS", "RetryPolicy", "Rung", "guard_shards",
    "run_ladder", "SolveReport", "first_bad_index", "first_bad_index_batched",
    "reduce_info",
]
