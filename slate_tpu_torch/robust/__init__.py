"""The solver-resilience basics the Cholesky family needs.

* **Fault injection** (:mod:`.faults`): :class:`FaultPlan` / :class:`FaultSpec`
  — seeded, deterministic corruption of driver operands/factors/outputs,
  addressed by driver name, call index and tile coordinate.
* **Health propagation** (:mod:`.report`): :class:`SolveReport` plus the shared
  info kernels :func:`first_bad_index` / :func:`reduce_info`.

Escalation ladders (``policy.py``) and the serving faults are not ported yet
(ROADMAP.md queue A).
"""

from .faults import (FaultPlan, FaultSpec, POINT_FACTOR, POINT_INPUT,
                     POINT_OUTPUT, active, inject)
from .report import (SolveReport, first_bad_index, first_bad_index_batched,
                     reduce_info)

__all__ = [
    "FaultPlan", "FaultSpec", "POINT_FACTOR", "POINT_INPUT", "POINT_OUTPUT",
    "active", "inject", "SolveReport", "first_bad_index",
    "first_bad_index_batched", "reduce_info",
]
