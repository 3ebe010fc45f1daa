"""factor_ms: the card's time in the library LU (``torch.linalg.lu_factor_ex``,
cuSOLVER's dgetrf), from the events of the program's ``getrf.factor`` span,
mean over the window's solves."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import mean_ms  # noqa: E402


def read(run, spec):
    return mean_ms(run, lambda s: s["getrf.factor"]["device_ms"])
