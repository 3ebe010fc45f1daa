"""Tile-grid distribution functions (reference: include/slate/func.hh, 339 LoC).

The reference makes data distribution a first-class lambda: ``tileRank(i, j)``,
``tileDevice(i, j)``, ``tileMb(i)``, ``tileNb(j)`` are ``std::function`` members of
``MatrixStorage`` (MatrixStorage.hh:339-342), with 2D block-cyclic as the default
(func.hh:100-217).  We keep exactly that design: plain Python callables over tile indices,
with the same factories.  The "rank" is a flattened (p, q) grid coordinate; the port runs on one device
and keeps the maps as metadata until the distributed tier is ported.

Everything here is host-side metadata — cheap and device-free.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

from .types import GridOrder

TileIndexFunc = Callable[[int], int]          # i -> mb(i)  (func.hh uniform_blocksize)
TileRankFunc = Callable[[int, int], int]      # (i, j) -> rank


def uniform_blocksize(n: int, nb: int) -> TileIndexFunc:
    """Uniform tile size with ragged last tile (func.hh:39-42)."""

    def mb(i: int) -> int:
        return nb if (i + 1) * nb <= n else max(0, n - i * nb)

    return mb


def num_tiles(n: int, nb: int) -> int:
    """ceil(n / nb), the reference's mt()/nt() computation (BaseMatrix.hh)."""
    return -(-n // nb) if n > 0 else 0


def process_2d_grid(order: GridOrder, p: int, q: int) -> TileRankFunc:
    """2D block-cyclic tile→rank map over a p×q grid (func.hh:178-186).

    Col order: rank = (i%p) + (j%q)*p.  Row order: rank = (i%p)*q + (j%q).
    """
    order = GridOrder.from_string(order)
    if order == GridOrder.Col:
        return lambda i, j: (i % p) + (j % q) * p
    elif order == GridOrder.Row:
        return lambda i, j: (i % p) * q + (j % q)
    raise ValueError(f"unsupported grid order {order}")


def process_1d_grid(order: GridOrder, size: int) -> TileRankFunc:
    """1D block-cyclic map (func.hh process_1d_grid)."""
    order = GridOrder.from_string(order)
    if order == GridOrder.Col:
        return lambda i, j: i % size
    return lambda i, j: j % size


def device_2d_grid(order: GridOrder, p: int, q: int) -> TileRankFunc:
    """Device map analogue (func.hh:100-118); tileDevice == tileRank."""
    return process_2d_grid(order, p, q)

def device_1d_grid(order: GridOrder, size: int) -> TileRankFunc:
    return process_1d_grid(order, size)


def transpose_grid(func: TileRankFunc) -> TileRankFunc:
    """Swap tile indices (func.hh:229-237); used when transposing a matrix view."""
    return lambda i, j: func(j, i)


def grid_size(nranks: int) -> Tuple[int, int]:
    """Pick the squarest p×q with p*q == nranks (tester's default grid choice)."""
    p = int(math.isqrt(nranks))
    while nranks % p != 0:
        p -= 1
    return p, nranks // p


def is_2d_cyclic_grid(mt: int, nt: int, func: TileRankFunc) -> Tuple[bool, GridOrder, int, int]:
    """Detect whether ``func`` is a 2D block-cyclic grid over the mt×nt tile space and
    recover (order, p, q) (func.hh:265-334).  Returns (ok, order, p, q).
    """
    if mt <= 0 or nt <= 0:
        return True, GridOrder.Col, 1, 1
    # p = number of distinct ranks down the first column before repeating
    p = 1
    while p < mt and func(p, 0) != func(0, 0):
        p += 1
    q = 1
    while q < nt and func(0, q) != func(0, 0):
        q += 1
    for order in (GridOrder.Col, GridOrder.Row):
        cand = process_2d_grid(order, p, q)
        if all(func(i, j) == cand(i, j)
               for i in range(min(mt, 2 * p + 1))
               for j in range(min(nt, 2 * q + 1))):
            return True, order, p, q
    return False, GridOrder.Unknown, p, q
