"""Jobs for the gloo rank pools of the port's tests (torch only: the ranks
import this module, never the JAX package)."""


def counted_call(name, args, kwargs, spec):
    """``name(*args, **kwargs)`` (a dotted path) with the grid ``spec`` built
    first on this rank; returns the result as numpy (gathered after the
    count) and how many collectives the call made here (all-reduces,
    all-gathers and point-to-point exchanges, counted by wrapping the
    collectives module's primitives for this call)."""
    from slate_tpu_torch.parallel import collectives as C
    from slate_tpu_torch.parallel.launch import _resolve, grid_of, to_host

    grid_of(spec)
    calls = [0]
    names = ("_all_reduce", "_all_gather", "_send_recv", "_exchange")
    saved = {n: getattr(C, n) for n in names}

    def counting(fn):
        def wrapped(*a):
            calls[0] += 1
            return fn(*a)
        return wrapped

    for n in names:
        setattr(C, n, counting(saved[n]))
    try:
        out = _resolve(name)(*args, **kwargs)
    finally:
        for n in names:
            setattr(C, n, saved[n])
    return to_host(out), calls[0]
