"""Entries: how a configuration's system is driven, named by the
configuration's ``entry`` key (``entries/<entry>.py``, ``run(run, device)``)."""
