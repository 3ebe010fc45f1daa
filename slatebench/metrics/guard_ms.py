"""guard_ms: the card's time in the NaN guard of the LU factorization
(``linalg/lu.py::_mark_lost_nan``), from the events of the program's
``getrf.guard`` span, mean over the window's solves."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import mean_ms  # noqa: E402


def read(run, spec):
    return mean_ms(run, lambda s: s["getrf.guard"]["device_ms"])
