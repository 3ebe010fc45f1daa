"""serve_solves_per_s: requests completed inside the window over the window's
length (host clock)."""


def read(run, spec):
    if not run.window_s or len(run.latency_s) == 0:
        return None
    return run.completed_in_window / run.window_s
