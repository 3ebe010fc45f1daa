"""serve_p95_ms: the 95th percentile, over every request of the window, of
the time from when it was due to when the client held its result (host
clock).  A request that never came in counts as infinitely late.  Above the
knee the same tail is a per-layer metric (``serve_p95_ms.<suffix>``)."""

import numpy as np


def read(run, spec):
    if len(run.latency_s) == 0:
        return None
    return float(np.percentile(np.asarray(run.latency_s), 95)) * 1e3
