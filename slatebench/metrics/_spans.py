"""The program's own spans of a run's window, one group per solve.

``slate_tpu_torch.utils.trace.spans()`` hands over the spans the program
recorded while the run's profiler window was open (a span records whenever a
profiler records) and forgets them, so the first reader keeps them on the
run for the others.  The spans of one solve share the id of their root, the
``gesv`` call.  A program without ``spans()``, the control's run (no
``gesv`` call), a run without a profiler window, or a window whose ``gesv``
roots do not number the run's solves gives nothing to read: None.
"""

import sys

ROOT_SPAN = "gesv"


def _recorded(run):
    if not hasattr(run, "program_spans"):
        trace = sys.modules.get("slate_tpu_torch.utils.trace")
        take = getattr(trace, "spans", None)
        run.program_spans = list(take()) if take is not None else []
    return run.program_spans


def solves(run):
    """``[{span name: record}]``, one dict per ``gesv`` root opened inside the
    window, its own record under ``"gesv"``; None unless they number
    ``run.attempted``."""
    if run.setup_s is None or run.window_s is None or not run.attempted:
        return None
    t0 = run.t_process + run.setup_s
    t1 = t0 + run.window_s
    groups = {}
    for rec in _recorded(run):
        if rec["name"] == ROOT_SPAN and rec["parent"] is None \
                and t0 <= rec["t_open"] <= t1:
            groups[rec["id"]] = {}
    if len(groups) != run.attempted:
        return None
    for rec in _recorded(run):
        group = groups.get(rec["root"])
        if group is not None:
            group[rec["name"]] = rec
    return list(groups.values())


def mean_ms(run, value):
    """The mean over the window's solves of ``value(solve)`` (ms); None when
    there is nothing to read or a solve lacks a span or a device time."""
    groups = solves(run)
    if groups is None:
        return None
    try:
        vals = [float(value(g)) for g in groups]
    except (KeyError, TypeError):
        return None
    return sum(vals) / len(vals)
