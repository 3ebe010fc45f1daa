"""lu_stall_ms: the time inside a solve in which the card had none of the
call's work left to run while the host held it: the device time of the
program's ``gesv`` span less those of ``getrf.factor``, ``getrf.guard`` and
``getrs`` (the entry before the factor is queued, the ipiv copy's return,
the swap loop, the permutation's copy to the card, the info kernels), mean
over the window's solves."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import mean_ms  # noqa: E402


def read(run, spec):
    return mean_ms(run, lambda s: s["gesv"]["device_ms"]
                   - s["getrf.factor"]["device_ms"]
                   - s["getrf.guard"]["device_ms"]
                   - s["getrs"]["device_ms"])
