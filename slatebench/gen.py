"""The one generator of the benchmark's inputs, driven by a traffic file.

Everything is made from ``--seed``, so a seed gives the same inputs, and
every seed gives a cell the same amount of work: the same set of request
shapes and of arrival gaps, in another order.

* HPL's system: A and b uniform in (−0.5, 0.5), as HPL's ``HPL_pdmatgen``
  draws them, made on the card in place from (seed, solve index).
* Served requests, after ``slate_tpu_torch.serve.workload.make_requests``
  (copied here, so the yardstick does not move with the program):
  ``gesv`` a Gaussian n×n plus n·I, ``posv`` a aᵀ + n·I, ``gels`` a tall
  Gaussian 2n×n; each b Gaussian m×nrhs.  Where ``make_requests`` draws each
  request's routine, size and right-hand sides at random, here every
  (routine, n, nrhs) of the mix takes an equal share, shuffled by the seed.
  Operands are drawn on the card, one call per shape, and handed to the
  program where the traffic file puts them (``"operands"``: ``host`` numpy
  arrays or ``device`` tensors).
* Arrivals: an open loop at ``rate_per_s``.  The gaps are the exponential
  distribution's quantiles at that rate, shuffled by the seed and scaled so
  that the last request is due when the window closes.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number ≥ 0)."""
    ss = np.random.SeedSequence([int(seed)] + [int(t) for t in tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *tags))


# -- HPL ----------------------------------------------------------------------

def hpl_fill(A: torch.Tensor, b: torch.Tensor, g: torch.Generator,
             seed: int, index: int) -> None:
    """Draw solve ``index``'s A and b in place."""
    g.manual_seed(subseed(seed, 1, index))
    A.uniform_(-0.5, 0.5, generator=g)
    b.uniform_(-0.5, 0.5, generator=g)


# -- served requests -------------------------------------------------------------

def combos(traffic: Dict[str, Any]) -> List[Tuple[str, int, int]]:
    """Every (routine, n, nrhs) of the mix, in a fixed order."""
    return list(itertools.product(traffic["routines"],
                                  [int(d) for d in traffic["dims"]],
                                  [int(r) for r in traffic["nrhs"]]))


def rows(routine: str, n: int) -> int:
    return 2 * n if routine == "gels" else n


def mix(kinds: int, count: int, seed: int) -> np.ndarray:
    """``count`` kind indices, each of ``kinds`` kinds ⌊count/kinds⌋ or one
    more times (the same multiset for every seed), in the seed's order."""
    order = np.arange(count) % kinds
    rng(seed, 2).shuffle(order)
    return order


def arrivals(count: int, seconds: float, seed: int) -> np.ndarray:
    """Due times (seconds after the window opens) of ``count`` requests."""
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q)
    rng(seed, 3).shuffle(gaps)
    due = np.cumsum(gaps)
    return due * (seconds / due[-1])


def make_operands(routine: str, n: int, nrhs: int, count: int,
                  dtype: torch.dtype, g: torch.Generator,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``count`` requests of one shape as two batched tensors on ``device``."""
    m = rows(routine, n)
    a = torch.randn((count, m, n), generator=g, dtype=dtype, device=device)
    if routine == "posv":
        a = torch.baddbmm(torch.eye(n, dtype=dtype, device=device).mul_(n),
                          a, a.mT)
    elif routine == "gesv":
        a.diagonal(dim1=-2, dim2=-1).add_(n)
    b = torch.randn((count, m, nrhs), generator=g, dtype=dtype, device=device)
    return a, b


class Requests:
    """The cell's request stream: ``pool`` distinct requests (or one for
    each arrival), request ``k`` being ``pool[k % len(pool)]``."""

    def __init__(self, traffic: Dict[str, Any], seconds: float, seed: int,
                 dtype: torch.dtype, device: torch.device):
        self.combos = combos(traffic)
        self.count = max(1, int(round(float(traffic["rate_per_s"]) * seconds)))
        self.due = arrivals(self.count, seconds, seed)
        size = int(traffic.get("pool") or self.count)
        self.kind = mix(len(self.combos), size, seed)
        self.host = traffic.get("operands", "host") == "host"
        g = torch.Generator(device=device)
        self.a: List[Any] = [None] * size
        self.b: List[Any] = [None] * size
        for c, (routine, n, nrhs) in enumerate(self.combos):
            idx = np.nonzero(self.kind == c)[0]
            if idx.size == 0:
                continue
            g.manual_seed(subseed(seed, 4, c))
            A, B = make_operands(routine, n, nrhs, idx.size, dtype, g, device)
            if self.host:
                A, B = A.cpu().numpy(), B.cpu().numpy()
            for j, k in enumerate(idx.tolist()):
                self.a[k], self.b[k] = A[j], B[j]

    def __len__(self) -> int:
        return self.count

    def shape(self, k: int) -> Tuple[str, int, int, int]:
        """(routine, m, n, nrhs) of request ``k``."""
        routine, n, nrhs = self.combos[self.kind[k % len(self.kind)]]
        return routine, rows(routine, n), n, nrhs

    def operands(self, k: int):
        j = k % len(self.kind)
        return self.a[j], self.b[j]

    def first_of_each(self) -> List[int]:
        """One pool index of every kind the pool holds."""
        seen: Dict[int, int] = {}
        for j, c in enumerate(self.kind.tolist()):
            seen.setdefault(c, j)
        return sorted(seen.values())


def sample(candidates: Sequence[int], size: int, seed: int,
           must: Sequence[int] = ()) -> List[int]:
    """``size`` of ``candidates`` drawn from the seed, with ``must`` in."""
    pick = set(int(k) for k in must if k in set(candidates))
    rest = [k for k in candidates if k not in pick]
    take = max(0, min(size - len(pick), len(rest)))
    if take:
        chosen = rng(seed, 5).choice(len(rest), size=take, replace=False)
        pick.update(rest[i] for i in chosen.tolist())
    return sorted(pick)
