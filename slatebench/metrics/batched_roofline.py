"""batched_roofline: the batched cores (``serve/batched.py`` over
``lu.gesv_core``, ``chol.posv_core``, ``qr.gels_core``) against their
roofline: the requests' own unpadded model operations and bytes, of every
request completed in the traced window, over the card's busy time."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _roofline import share  # noqa: E402


def read(run, spec):
    if len(run.latency_s) == 0:
        return None
    return share(run)
