"""mfu: the whole window's share of the card's peak: the model operations
completed in the window over its wall time and the peak FLOP/s of the
configuration's precision (``peaks.json``)."""


def read(run, spec):
    if not run.peaks or not run.window_s or run.flops <= 0:
        return None
    return 100.0 * run.flops / run.window_s / run.peaks["flops_per_s"][run.dtype]
