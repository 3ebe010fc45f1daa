"""pivots_ms: host time of the LU driver's pivot conversion (ipiv to a
permutation, ``linalg/lu.py::_ipiv_perm``), mean over the window's solves,
from the program's ``pivots`` phase (``utils.trace.last_phases("getrf")``)."""


def read(run, spec):
    vals = [s["pivots_s"] for s in run.solves if s.get("pivots_s") is not None]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
