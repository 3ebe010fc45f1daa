"""setup_s: process start to the window's opening (imports, inputs, warm-up),
on the host's clock."""


def read(run, spec):
    return run.setup_s
