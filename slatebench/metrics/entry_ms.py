"""entry_ms: host time a solve spends in the entry layer before the library
LU starts: from the program's ``gesv`` span opening to its ``getrf.factor``
span opening (Options, the wrappers, getrf's dispatch), mean over the
window's solves."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import mean_ms  # noqa: E402


def read(run, spec):
    return mean_ms(run, lambda s: 1e3 * (s["getrf.factor"]["t_open"]
                                         - s["gesv"]["t_open"]))
