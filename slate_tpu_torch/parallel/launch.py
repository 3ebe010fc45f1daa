"""A pool of gloo ranks on the CPU: the p×q world runner for the distributed
tier's tests and CPU runs (the counterpart of the JAX package's
``tools/run_multiprocess.py``).

``RankPool(world)`` spawns ``world`` processes once, joins them into one gloo
group and keeps them; :meth:`RankPool.run` sends every rank the same function
(picklable by module path) and returns each rank's result.  A rank's error, or
a job that outlives its timeout, tears the pool down (the next job starts a
fresh one) and raises here instead of hanging.

:func:`call` is the generic job: it builds the grid (cached per rank), turns
numpy arguments into tensors, calls a ``slate_tpu_torch.parallel`` function
with the grid in place of :data:`GRID`, and brings every distributed result
back as numpy::

    with RankPool(8) as pool:
        L = pool.call("potrf_distributed", a, GRID, nb=16, grid=(2, 4, "col"))

On a card the same drivers run one rank per GPU under
``torchrun --nproc-per-node=<cards>``.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import queue
import traceback
from datetime import timedelta

import numpy as np

GRID = "<grid>"            # stands for the ProcessGrid in :func:`call` arguments

def _worker(rank: int, world: int, port: int, inq, outq, threads: int,
            timeout: float) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout))
    outq.put((rank, "ready", None))
    while True:
        job = inq.get()
        if job is None:
            break
        fn, args, kwargs = job
        try:
            outq.put((rank, "ok", fn(*args, **kwargs)))
        except BaseException:                  # noqa: BLE001 - sent to the parent
            outq.put((rank, "err", traceback.format_exc()))
    from .mesh import destroy

    destroy()


class RankPool:
    """``world`` gloo ranks, each on ``threads`` intra-op threads."""

    def __init__(self, world: int = 8, threads: int = 1, timeout: float = 120.0,
                 collective_timeout: float = 60.0):
        self.world, self.threads = int(world), int(threads)
        self.timeout, self.collective_timeout = timeout, collective_timeout
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _start(self) -> None:
        from .mesh import free_port

        ctx = mp.get_context("spawn")
        self._out = ctx.Queue()
        self._ins = [ctx.Queue() for _ in range(self.world)]
        port = free_port()
        for r in range(self.world):
            p = ctx.Process(target=_worker, daemon=True,
                            args=(r, self.world, port, self._ins[r], self._out,
                                  self.threads, self.collective_timeout))
            p.start()
            self._procs.append(p)      # close() joins only started ranks
        self._collect("ready", self.timeout)

    def _collect(self, what: str, timeout: float):
        got = {}
        while len(got) < self.world:
            try:
                rank, status, value = self._out.get(timeout=timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"rank pool: no {what} from ranks "
                                   f"{sorted(set(range(self.world)) - set(got))} "
                                   f"within {timeout} s") from None
            if status == "err":
                self.close()
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.world)]

    def run(self, fn, *args, timeout=None, **kwargs):
        """Run ``fn(*args, **kwargs)`` on every rank; the list of results."""
        if not self._procs:
            self._start()
        for q in self._ins:
            q.put((fn, args, kwargs))
        return self._collect("result", timeout or self.timeout)

    def call(self, name: str, *args, grid=(2, 4, "col"), timeout=None, **kwargs):
        """Rank 0's result of :func:`call` (every rank runs it)."""
        return self.run(call, name, args, kwargs, grid, timeout=timeout)[0]

    def close(self) -> None:
        for q in getattr(self, "_ins", []):
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self._procs = []


def grid_of(spec):
    """The cached CPU grid ``(p, q, order)`` of this rank."""
    from .mesh import ProcessGrid

    return ProcessGrid.cached(spec[0], spec[1], device="cpu",
                              order=spec[2] if len(spec) > 2 else "col")


def _resolve(name: str):
    if "." not in name:
        from slate_tpu_torch import parallel
        return getattr(parallel, name)
    mod, attr = name.rsplit(".", 1)
    return getattr(importlib.import_module(mod), attr)


def to_host(x):
    """numpy of a result, distributed results gathered; tuples and lists map."""
    import torch
    from .distribute import gather, is_dist

    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    if is_dist(x):
        x = gather(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def to_device(x):
    import torch

    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v) for v in x)
    return x


def call(name: str, args, kwargs, spec):
    """The generic job: ``name(*args, **kwargs)`` on grid ``spec`` with numpy
    in and out.  Ranks outside the grid build it and return None."""
    grid = grid_of(spec)
    if grid.rank < 0:
        return None
    args = [grid if isinstance(a, str) and a == GRID else to_device(a)
            for a in args]
    kwargs = {k: to_device(v) for k, v in kwargs.items()}
    return to_host(_resolve(name)(*args, **kwargs))
