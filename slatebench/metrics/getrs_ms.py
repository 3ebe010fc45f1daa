"""getrs_ms: the card's time in the solve from the factor (the row gather and
the two triangular solves), from the events of the program's ``getrs`` span,
mean over the window's solves."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import mean_ms  # noqa: E402


def read(run, spec):
    return mean_ms(run, lambda s: s["getrs"]["device_ms"])
