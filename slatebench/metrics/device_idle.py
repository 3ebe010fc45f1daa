"""device_idle: the share of the traced window in which nothing ran on the
card: 1 − (union of every kernel, copy and memset interval) / window."""


def read(run, spec):
    dt = run.device_trace
    if not dt or dt["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])
