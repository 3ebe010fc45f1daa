"""Metric readers: ``metrics/<name>.py`` (or ``<stem>.py`` for
``<stem>.<suffix>``), each ``read(run, spec)`` -> a number or None."""
