"""Process grid over ``torch.distributed`` ranks.

Reference analogue: the p×q MPI/BLACS process grid every SLATE matrix carries
(``BaseMatrix.hh:161-164`` ``gridinfo()``, ``func.hh:178-186`` 2D block-cyclic
maps).  The grid is a 2-D :class:`~torch.distributed.device_mesh.DeviceMesh`
with dims ``("p", "q")`` over the world's ranks, one process per rank (the
multi-controller form PyTorch runs on several GPUs): rank r of the world is
grid rank r, and ranks past ``p*q`` hold no part of the grid.

``GridOrder.Col`` puts ranks down columns first (rank = i + j*p, the ScaLAPACK
default); ``GridOrder.Row`` puts them along rows (rank = i*q + j).  The mesh
tensor is built in the grid's order, so ``tile_rank``, :meth:`coords` and the
mesh coordinates always agree.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core import grid as grid_funcs
from ..core.exceptions import SlateError, slate_assert
from ..core.matrix import resolve_device
from ..core.types import GridOrder

ROW_AXIS = "p"
COL_AXIS = "q"
FLAT = (ROW_AXIS, COL_AXIS)      # both dims flattened, p-major (rank i*q + j)

_CACHE = {}
_TIMEOUT = timedelta(seconds=300)     # a collective that waits longer fails


class Sharding(NamedTuple):
    """A placement of a 2-D operand on a grid: the mesh and the two
    placements, the counterpart of a ``NamedSharding``."""

    mesh: object
    placements: tuple


def free_port() -> int:
    """A free TCP port on the local host for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ensure_world(device: torch.device, size: int) -> None:
    """Join the process group that exists, or start one.

    Under a launcher (``RANK``/``WORLD_SIZE`` in the environment) the group
    comes from ``env://``; with no launcher a grid of one rank starts a world
    of one by itself.  NCCL serves ``cuda``, gloo the CPU; a group of the
    other kind is refused rather than used."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend, init_method="env://", timeout=_TIMEOUT)
        elif size == 1:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                world_size=1, rank=0, timeout=_TIMEOUT)
        else:
            raise SlateError(f"a {size}-rank grid needs a process group: start "
                             "the ranks with a launcher (torchrun) or "
                             "torch.distributed.init_process_group")
    have = dist.get_backend()
    if backend not in str(have):
        raise SlateError(f"grid on {device.type} needs the {backend} backend, "
                         f"the process group runs {have}")


class ProcessGrid:
    """A p×q grid of ranks playing the role of the reference's MPI process grid.

    ``device`` is where the grid's shards live: ``cuda`` (NCCL, one card per
    rank) unless the caller asks for the CPU (gloo).  Without a process group,
    ``ProcessGrid(1, 1)`` starts a world of one; a larger grid joins the group
    a launcher started and raises when ``p*q`` exceeds its world size.
    """

    def __init__(self, p: Optional[int] = None, q: Optional[int] = None,
                 device=None, order: GridOrder = GridOrder.Col):
        from torch.distributed.device_mesh import DeviceMesh

        self.device = resolve_device(device)
        want = (p or 1) * (q or 1) if (p or q) else 1
        _ensure_world(self.device, want)
        world = dist.get_world_size()
        if p is None and q is None:
            p, q = grid_funcs.grid_size(world)
        elif p is None:
            p = world // q
        elif q is None:
            q = world // p
        slate_assert(p >= 1 and q >= 1 and p * q <= world,
                     f"grid {p}x{q} needs p, q >= 1 and p*q <= {world} ranks")
        self.p, self.q = int(p), int(q)
        self.order = GridOrder.from_string(order)
        ranks = torch.arange(self.p * self.q)
        if self.order == GridOrder.Col:
            ranks = ranks.reshape(self.q, self.p).T
        else:
            ranks = ranks.reshape(self.p, self.q)
        self.mesh = DeviceMesh(self.device.type, ranks, mesh_dim_names=FLAT)
        self.tile_rank = grid_funcs.process_2d_grid(self.order, self.p, self.q)
        me = dist.get_rank()
        self.rank = me if me < self.p * self.q else -1
        self.my_coords = self.coords(self.rank) if self.rank >= 0 else None

    @classmethod
    def cached(cls, p: Optional[int] = None, q: Optional[int] = None, device=None,
               order: GridOrder = GridOrder.Col) -> "ProcessGrid":
        """One grid per (p, q, device, order) and process.  Building a grid
        creates process groups, a collective step: every rank must ask for
        the same grids in the same order.  Without p and q the grid spans
        the world, as :class:`ProcessGrid` does."""
        if p is None and q is None:
            _ensure_world(resolve_device(device), 1)
            p, q = grid_funcs.grid_size(dist.get_world_size())
        key = (int(p), int(q), str(resolve_device(device)),
               GridOrder.from_string(order))
        if key not in _CACHE:
            _CACHE[key] = cls(p, q, device=device, order=order)
        return _CACHE[key]

    # -- reference gridinfo() ------------------------------------------------
    @property
    def size(self) -> int:
        return self.p * self.q

    def gridinfo(self) -> Tuple[GridOrder, int, int]:
        return self.order, self.p, self.q

    def coords(self, rank: int) -> Tuple[int, int]:
        """(row, col) coordinate of a grid rank (BLACS pcoord analogue)."""
        if self.order == GridOrder.Col:
            return rank % self.p, rank // self.p
        return rank // self.q, rank % self.q

    # -- placements ----------------------------------------------------------
    def spec(self, row_shard: bool = True, col_shard: bool = True) -> Sharding:
        """Placement of a 2-D operand: rows over p, cols over q (either
        optional)."""
        from torch.distributed.tensor import Replicate, Shard

        return Sharding(self.mesh, (Shard(0) if row_shard else Replicate(),
                                    Shard(1) if col_shard else Replicate()))

    def replicated(self) -> Sharding:
        from torch.distributed.tensor import Replicate

        return Sharding(self.mesh, (Replicate(), Replicate()))

    def row_spec(self) -> Sharding:
        """1-D row distribution over the whole flattened grid for tall panels
        (the reference's 1D grids, func.hh process_1d_grid)."""
        from torch.distributed.tensor import Shard

        return Sharding(self.mesh, (Shard(0), Shard(0)))

    def __repr__(self) -> str:
        return (f"ProcessGrid({self.p}x{self.q}, order={self.order}, "
                f"device={self.device.type}, rank={self.rank})")


def destroy() -> None:
    """End this process's process group and forget the grids built on it, so
    a later grid starts a new world instead of reusing a dead one."""
    _CACHE.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
