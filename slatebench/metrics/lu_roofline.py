"""lu_roofline: the library LU and solve kernels under ``linalg/lu.py``
(getrf, the pivot gather, getrs) against their roofline: HPL's model
operations over the card's busy time inside the solves (the regeneration of
A between solves left out)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _roofline import share  # noqa: E402


def read(run, spec):
    if not run.solves:
        return None
    return share(run, busy_label="solve")
