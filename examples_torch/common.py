"""What every example of the port shares: the ``--device`` switch and, for
the distributed examples, a world of ranks to run on.

An example runs on ``cuda`` unless ``--device`` names another device.  A
distributed example runs its job on every rank of a world: on the CPU a pool
of gloo ranks (``parallel.launch.RankPool``, one intra-op thread each), on a
card the one NCCL rank of a world of one, where its grids are 1x1."""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def run(main) -> None:
    """Parse ``--device`` and call ``main(device)``."""
    ap = argparse.ArgumentParser(description=(sys.modules["__main__"].__doc__ or "")
                                 .splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(torch.device(ap.parse_args().device))


def tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array as a tensor on ``device``."""
    import numpy as np

    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)


def host(t):
    """numpy of a tensor (or of a wrapper's array)."""
    if hasattr(t, "array"):
        t = t.array
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def grid(p: int, q: int, device):
    """The p x q grid of this rank's world, or a 1x1 grid where the world is
    smaller (one card); None on a rank outside the grid."""
    import torch.distributed as dist

    from slate_tpu_torch.parallel import ProcessGrid

    world = dist.get_world_size() if dist.is_initialized() else 1
    g = ProcessGrid.cached(p, q, device=device) if p * q <= world \
        else ProcessGrid.cached(1, 1, device=device)
    return g if g.rank >= 0 else None


def on_ranks(job, device, world: int = 8, *args):
    """``job(device, *args)`` on every rank of a world; rank 0's result.  On
    the CPU the world is ``world`` gloo ranks; on a card it is this process
    alone (one NCCL rank), ended after the job."""
    if device.type == "cpu":
        from slate_tpu_torch.parallel.launch import RankPool

        with RankPool(world, threads=1, timeout=300) as pool:
            return pool.run(job, str(device), *args)[0]
    from slate_tpu_torch.parallel import mesh

    try:
        return job(str(device), *args)
    finally:
        torch.cuda.synchronize(device)
        mesh.destroy()
