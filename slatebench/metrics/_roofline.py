"""The share of its roofline that the work of a window reached: the least
time the card could take for the model operations and bytes (the larger of
operations over peak FLOP/s and bytes over peak bytes/s, the peaks of
``peaks.json`` for the configuration's precision), over the card's busy
time (``busy_label``: only the busy time under that harness span)."""


def share(run, busy_label=None):
    dt = run.device_trace
    if not dt or not run.peaks or run.flops <= 0:
        return None
    busy = dt["busy_s"] if busy_label is None else dt["busy_by_label"].get(busy_label, 0.0)
    if busy <= 0:
        return None
    least = max(run.flops / run.peaks["flops_per_s"][run.dtype],
                run.bytes / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / busy
