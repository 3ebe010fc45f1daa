"""The solver-resilience layer.

* **Fault injection** (:mod:`.faults`): :class:`FaultPlan` / :class:`FaultSpec`
  — seeded, deterministic corruption of driver operands/factors/outputs,
  addressed by driver name, call index and tile coordinate.
* **Health propagation** (:mod:`.report`): :class:`SolveReport` plus the shared
  info kernels :func:`first_bad_index` / :func:`reduce_info`.
* **Escalation policies** (:mod:`.policy`): :class:`RetryPolicy`,
  :class:`Rung` / :func:`run_ladder` (declared ladders: mixed→full,
  RBT→partial-pivot, nopiv→partial-pivot), :func:`guard_shards`, and the
  :data:`LADDERS` registry of every driver's escalation order.

The serving faults (``POINT_SERVE``, ``inject_serve``) arrive with the serving
tier (ROADMAP.md queue A item 9).
"""

from .faults import (FaultPlan, FaultSpec, POINT_FACTOR, POINT_INPUT,
                     POINT_OUTPUT, active, inject)
from .policy import LADDERS, RetryPolicy, Rung, guard_shards, run_ladder
from .report import (SolveReport, first_bad_index, first_bad_index_batched,
                     reduce_info)

__all__ = [
    "FaultPlan", "FaultSpec", "POINT_FACTOR", "POINT_INPUT", "POINT_OUTPUT",
    "active", "inject", "LADDERS", "RetryPolicy", "Rung", "guard_shards",
    "run_ladder", "SolveReport", "first_bad_index", "first_bad_index_batched",
    "reduce_info",
]
