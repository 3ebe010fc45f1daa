"""Jobs for the gloo rank pools of the cost-audit and analysis tests (torch
only: the ranks import this module, never the JAX package)."""


def audit_pass_under_comm_debug(nproc):
    """Every spec of the scaling registry once on this rank, each under
    ``CommDebugMode`` as well as the collective log: the audit entry plus
    the collectives CommDebugMode counted, by op name (``allreduce_``,
    ``all_gather_into_tensor`` ...), and the point-to-point batches the
    collectives module ran (``p2p``: its ``_send_recv`` / ``_exchange``
    calls, counted by wrapping them for the pass)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from slate_tpu_torch.obs import scaling
    from slate_tpu_torch.parallel import collectives as C

    grid = scaling.make_grid(nproc, "cpu")
    calls = [0]
    saved = (C._send_recv, C._exchange)

    def counting(fn):
        def wrapped(*a):
            calls[0] += 1
            return fn(*a)
        return wrapped

    C._send_recv, C._exchange = map(counting, saved)
    out = []
    try:
        for spec in scaling.specs():
            calls[0] = 0
            with CommDebugMode() as cm:
                entry = scaling.audit_entry(spec, grid)
            entry["comm"] = {str(k).split(".", 1)[1]: int(v)
                             for k, v in cm.get_comm_counts().items()}
            entry["p2p"] = calls[0]
            out.append(entry)
    finally:
        C._send_recv, C._exchange = saved
    return out


def logged_reduce_scatter():
    """One ``axis_reduce_scatter`` over the 1x2 grid's q axis, logged; the
    log and what CommDebugMode counted."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from slate_tpu_torch.parallel import axis_reduce_scatter, collectives
    from slate_tpu_torch.parallel.launch import grid_of

    grid = grid_of((1, 2))
    with CommDebugMode() as cm, collectives.recording() as log:
        out = axis_reduce_scatter(torch.ones(4, 3), grid, "q")
    return (list(log), {str(k).split(".", 1)[1]: int(v)
                        for k, v in cm.get_comm_counts().items()},
            out.numpy(), collectives.is_recording())


def launched_pass(names):
    """``scaling.rank_passes`` called on every rank of a world that already
    has the pass's size (as under a launcher): each rank runs its own pass
    and gets every rank's entries."""
    from slate_tpu_torch.obs import scaling

    return scaling.rank_passes(2, names, "cpu")
