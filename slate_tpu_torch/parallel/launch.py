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

    if hasattr(x, "_fields"):                     # a NamedTuple of results
        return type(x)(*(to_host(v) for v in x))
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


def _dryrun(n_ranks: int, n, device) -> dict:
    """The dry run's steps on this rank (every rank of the world runs them)."""
    import torch

    from ..core.grid import grid_size
    from . import (ProcessGrid, cholqr_distributed, dense_to_band_lower,
                   gather, gemm_allgather, gemm_ring, geqrf_distributed,
                   gesv_distributed, getrf_tall_distributed, heev_distributed,
                   hesv_distributed, norm_distributed, pbsv_distributed,
                   posv_distributed, posv_mixed_distributed, potri_distributed,
                   svd_distributed, tsqr_distributed)

    p, q = grid_size(n_ranks)
    grid = ProcessGrid.cached(p, q, device=device)
    if grid.rank < 0:
        return None
    n = n or 8 * max(p, q)
    nb, nrhs = 2 * max(p, q), 2 * q
    gen = torch.Generator().manual_seed(0)
    f32 = torch.float32

    def rand(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, dtype=dtype).to(grid.device)

    def rel(x, y):
        return float(torch.linalg.norm(gather(x) - y) / torch.linalg.norm(y))

    M = rand(n, n)
    Af = M @ M.T + n * torch.eye(n, dtype=f32, device=grid.device)
    B, G = rand(n, nrhs), rand(n, n)
    H = (Af + Af.T) / 2
    err = {}
    X = posv_distributed(Af, B, grid, nb=nb)                # factor + both sweeps
    err["posv"] = rel(gemm_allgather(Af, gather(X), grid), B)   # SUMMA residual
    if p == q and p > 1:
        err["gemm_ring"] = rel(gemm_ring(Af, gather(X), grid), B)
    Xg, info = gesv_distributed(G, B, grid, nb=nb)
    err["gesv"] = rel(G @ gather(Xg), B) + int(info)
    Xm, _, ok = posv_mixed_distributed(Af.double(), B.double(), grid, nb=nb)
    err["posv_mixed"] = rel(Af.double() @ gather(Xm), B.double()) + (0 if ok else 1)
    T = rand(8 * n_ranks, 4)
    Qc, Rc = cholqr_distributed(T, grid)
    err["cholqr"] = rel(gather(Qc) @ gather(Rc), T)
    Qt, Rt = tsqr_distributed(T, grid)
    err["tsqr"] = rel(gather(Qt) @ Rt, T)
    Q2, R2 = geqrf_distributed(Af, grid, nb=nb)
    err["geqrf"] = rel(gather(Q2) @ gather(R2), Af)
    lam, Z = heev_distributed(H, grid, nb=max(2, nb // 2))
    Z = gather(Z)
    err["heev"] = rel(H @ Z, Z * lam[None, :])
    S, U, VT = svd_distributed(G, grid, nb=max(2, nb // 2))
    err["svd"] = rel((gather(U) * S[None, :]) @ gather(VT), G)
    err["norm"] = abs(float(norm_distributed("fro", G, grid))
                      - float(torch.linalg.norm(G))) / float(torch.linalg.norm(G))
    tall = rand(4 * n, max(2, n // 4))
    LU, perm, info_t = getrf_tall_distributed(tall, grid, nb=nb)
    LU = gather(LU)
    k = tall.shape[1]
    L = torch.tril(LU, -1)[:, :k] + torch.eye(4 * n, k, dtype=f32, device=grid.device)
    err["getrf_tall"] = rel(L @ torch.triu(LU[:k]), tall[torch.as_tensor(perm)]) + int(info_t)
    kd = max(1, nb // 2)
    ii = torch.arange(n, device=grid.device)
    band = torch.where((ii[:, None] - ii[None, :]).abs() <= kd, Af, 0.0) \
        + n * torch.eye(n, dtype=f32, device=grid.device)
    Xb, info_b = pbsv_distributed(dense_to_band_lower(torch.tril(band), kd), B, grid, kd,
                                  nb=nb)
    err["pbsv"] = rel(band @ gather(Xb), B) + int(info_b)
    Xh, info_h = hesv_distributed(H, B, grid, nb=max(2, nb // 2))
    err["hesv"] = rel(H @ gather(Xh), B) + int(info_h)
    Li = torch.linalg.cholesky(Af)
    inv = gather(potri_distributed(Li, grid))
    inv = torch.tril(inv) + torch.tril(inv, -1).T
    err["potri"] = rel(Af @ inv, torch.eye(n, dtype=f32, device=grid.device))
    return {"grid": (p, q), "n": n, "errors": err,
            "ok": {k: bool(v < 1e-2) for k, v in err.items()}}


def dryrun_multichip(n_ranks: int, pool=None, n=None, device=None) -> dict:
    """One dry run of the distributed tier on a ``grid_size(n_ranks)`` grid —
    the counterpart of ``__graft_entry__.dryrun_multichip``: the SPD factor
    and solve, the SUMMA residual (and Cannon's ring on square grids), the
    tournament-pivoted LU, the mixed-precision solve, CholQR / TSQR / CAQR,
    heev / svd / norm, the tall TSLU, the band Cholesky, Aasen and the SPD
    inverse, each against a plain check.  Returns rank 0's ``{"grid", "n",
    "errors", "ok"}``.

    It runs on ``device``, ``cuda`` unless the caller asks for the CPU.  On
    the card, under a launcher (``torchrun --nproc-per-node=<cards>``, one
    rank per card) every rank calls it in the launcher's world; without one,
    ``n_ranks=1`` runs in a world of one NCCL rank that ends with the call,
    and more ranks raise (they need the launcher).  With ``device="cpu"`` it
    runs on a pool of ``n_ranks`` gloo ranks (``pool``, or a new one), or in
    the launcher's world when there is one."""
    import os

    import torch.distributed as dist

    from ..core.matrix import resolve_device
    from .mesh import destroy

    device = resolve_device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _dryrun(n_ranks, n, device)
    if device.type == "cpu":
        if pool is not None:
            return pool.run(_dryrun, n_ranks, n, "cpu")[0]
        with RankPool(n_ranks) as own:
            return own.run(_dryrun, n_ranks, n, "cpu")[0]
    own_world = not dist.is_initialized()
    try:
        return _dryrun(n_ranks, n, device)   # a world of one, or it raises
    finally:
        if own_world:
            destroy()
