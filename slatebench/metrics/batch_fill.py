"""batch_fill: real requests over batch slots, mean over the window's
batches, from the program's ``slate_serve_batch_occupancy`` histogram."""


def read(run, spec):
    total, count = run.counters.get("slate_serve_batch_occupancy", (0.0, 0))
    if count <= 0:
        return None
    return 100.0 * total / count
