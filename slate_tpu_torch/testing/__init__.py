"""Routine tester / parameter-sweep harness (≅ test/ + TestSweeper, SURVEY.md §4).

Run as ``python -m slate_tpu_torch.testing <routine> [flags]`` — the analogue of
the reference's single ``tester`` binary with its routine dispatch table
(test/test.cc:117-320).  Rows run on ``cuda`` unless ``--device`` (or the
``device=`` keyword of ``run_sweep``/``run_routine``) names another device.
"""

from .sweeper import ParamSweep, TestResult, format_table, parse_dims, parse_list
from .routines import ROUTINES, run_routine

__all__ = ["ParamSweep", "TestResult", "format_table", "parse_dims", "parse_list",
           "ROUTINES", "run_routine"]
