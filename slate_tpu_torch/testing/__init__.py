"""Routine tester / parameter-sweep harness (≅ test/ + TestSweeper, SURVEY.md §4).

Run as ``python -m slate_tpu_torch.testing <routine> [flags]`` — the analogue of
the reference's single ``tester`` binary with its routine dispatch table
(test/test.cc:117-320).  Rows run on ``cuda`` unless ``--device`` (or the
``device=`` keyword of ``run_sweep``/``run_routine``) names another device.
"""

from .sweeper import ParamSweep, TestResult, format_table, parse_dims, parse_list
from .routines import ROUTINES, run_routine


def cost_analysis_dict(run) -> dict:
    """The counted analogue of XLA's ``Compiled.cost_analysis()``: a run
    counted by ``obs.costaudit.counted`` as ``{"flops": ..., "bytes
    accessed": ...}``, in XLA's key spelling, so cost pins read the same
    keys in both packages."""
    return {"flops": float(run.flops), "bytes accessed": float(run.bytes_accessed)}


__all__ = ["ParamSweep", "TestResult", "format_table", "parse_dims", "parse_list",
           "ROUTINES", "run_routine", "cost_analysis_dict"]
