"""model_gflops: HPL's model operations (2N³/3 + 3N²/2) of every solve in the
window over the window's wall time, in GFLOP/s (host clock)."""


def read(run, spec):
    if not run.solves or not run.window_s:
        return None
    return run.flops / run.window_s / 1e9
