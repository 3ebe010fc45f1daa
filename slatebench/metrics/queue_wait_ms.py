"""queue_wait_ms: the serving queue's wait (``serve/queue.py``), mean over
the window's requests of the program's ``Ticket.stages["queue_wait"]``
(submit to the start of its batch)."""


def read(run, spec):
    vals = run.stages.get("queue_wait")
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
