"""Deterministic fault injection for solver chaos testing (numerical faults).

Reference motivation: SLATE's drivers *detect* numerical failure (info codes
reduced across ranks, internal_reduce_info.cc) and *recover* (gesv_mixed.cc's
full-precision fallback) — but nothing in the reference can *exercise* those
paths on demand.  A :class:`FaultPlan` is a seeded, declarative list of
corruptions addressed by driver name, call index and tile coordinate, applied
at driver boundaries through :func:`inject`.

Design constraints:

* **out of place** — a corruption returns a new tensor and never writes into
  the operand it was given (the caller's data stays intact).
* **deterministic** — the only randomness is a ``torch.Generator`` seeded from
  the plan's seed and the spec's call index (the ``ir_stall`` perturbation).
  Its bits differ from the JAX package's ``jax.random`` stream; the contract is
  the same distribution and the same replay-identical behaviour.
* **host-level addressing** — drivers call ``inject(name, x, point=...)`` at
  their entry/factor/output boundaries; the plan counts calls per
  ``(driver, point)`` site so a fault can target "the third potrf".

Fault classes: ``nan_tile`` / ``inf_tile`` (one nb×nb tile NaN/Inf),
``zero_pivot`` (zero row+column ``index``), ``ir_stall`` (multiplicative
perturbation of a factor, point="factor") and ``shard_fail`` (NaN rows of shard
``index`` of ``world`` at a solve's output).  The serving faults arrive with the
serving tier.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.trace import trace_event


def count_event(name: str, **labels) -> None:
    """Labeled robust-event counter on the obs registry, lazily imported and
    exception-proof — telemetry must never break (or import-couple) a solve."""
    try:
        from ..obs import counter
        counter(name).inc(**labels)
    except Exception:  # pragma: no cover - telemetry never breaks a solve
        pass


# injection points: where along a driver's lifetime a fault lands
POINT_INPUT = "input"      # operand at driver entry
POINT_FACTOR = "factor"    # low-precision / intermediate factor
POINT_OUTPUT = "output"    # solve result (distributed shard failures)

_KIND_POINT = {
    "nan_tile": POINT_INPUT,
    "inf_tile": POINT_INPUT,
    "zero_pivot": POINT_INPUT,
    "ir_stall": POINT_FACTOR,
    "shard_fail": POINT_OUTPUT,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declared corruption.

    driver:     the site name drivers pass to :func:`inject` ("potrf", ...).
    kind:       one of ``nan_tile | inf_tile | zero_pivot | ir_stall |
                shard_fail``.
    call_index: which invocation of that (driver, point) site to hit
                (0 = first).
    tile:       (i, j) tile coordinate for the tile corruptions.
    nb:         tile edge for the tile corruptions.
    index:      pivot index (zero_pivot) / failed shard id (shard_fail).
    world:      shard count for shard_fail (rows split evenly).
    scale:      multiplicative magnitude for ir_stall.
    """

    driver: str
    kind: str
    call_index: int = 0
    tile: Tuple[int, int] = (0, 0)
    nb: int = 32
    index: int = 0
    world: int = 8
    scale: float = 1e3

    def __post_init__(self):
        if self.kind not in _KIND_POINT:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {sorted(_KIND_POINT)}")

    @property
    def point(self) -> str:
        return _KIND_POINT[self.kind]


# active-plan stack (plans nest; innermost wins the call accounting)
_ACTIVE: List["FaultPlan"] = []


class FaultPlan:
    """A seeded, context-manager-driven set of :class:`FaultSpec`\\ s.

    ::

        plan = FaultPlan([FaultSpec("potrf", "nan_tile", tile=(1, 1), nb=16)],
                         seed=7)
        with plan:
            L, info = slate.potrf(A)     # tile (1,1) arrives as NaN
        assert plan.fired == (("potrf", "nan_tile", 0),)

    Entering the context resets the per-site call counters, so the same plan
    object replays identically.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._counts = {}
        self._fired: List[Tuple[str, str, int]] = []

    def __enter__(self) -> "FaultPlan":
        self.reset()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def reset(self) -> None:
        """Clear call counters and the fired log (replay from the top)."""
        self._counts = {}
        self._fired = []

    @property
    def fired(self) -> Tuple[Tuple[str, str, int], ...]:
        """(driver, kind, call_index) triples of faults that actually fired."""
        return tuple(self._fired)

    def _take(self, driver: str, point: str) -> List[FaultSpec]:
        idx = self._counts.get((driver, point), 0)
        self._counts[(driver, point)] = idx + 1
        hits = [s for s in self.specs
                if s.driver == driver and s.point == point and s.call_index == idx]
        for s in hits:
            self._fired.append((driver, s.kind, idx))
        return hits


def active() -> Optional[FaultPlan]:
    """The innermost active plan, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _tile_mask(x: torch.Tensor, tile: Tuple[int, int], nb: int) -> torch.Tensor:
    i, j = tile
    r = torch.arange(x.shape[-2], device=x.device)
    c = torch.arange(x.shape[-1], device=x.device)
    rm = (r >= i * nb) & (r < (i + 1) * nb)
    cm = (c >= j * nb) & (c < (j + 1) * nb)
    return rm[:, None] & cm[None, :]


def _apply(spec: FaultSpec, x: torch.Tensor, seed: int) -> torch.Tensor:
    if spec.kind in ("nan_tile", "inf_tile"):
        val = float("nan") if spec.kind == "nan_tile" else float("inf")
        return x.masked_fill(_tile_mask(x, spec.tile, spec.nb), val)
    if spec.kind == "zero_pivot":
        k = spec.index
        r = torch.arange(x.shape[-2], device=x.device)
        c = torch.arange(x.shape[-1], device=x.device)
        return x.masked_fill((r == k)[:, None] | (c == k)[None, :], 0)
    if spec.kind == "ir_stall":
        # seeded multiplicative perturbation of the factor: scale · U[0.5,1.5)
        # — finite, so a stalled refinement loop runs its full budget
        gen = torch.Generator().manual_seed(seed * 1_000_003 + spec.call_index)
        u = torch.rand(x.shape, generator=gen, dtype=torch.float32) + 0.5
        return x * (spec.scale * u).to(device=x.device, dtype=x.dtype)
    if spec.kind == "shard_fail":
        rows = x.shape[-2] if x.ndim >= 2 else x.shape[-1]
        per = -(-rows // max(spec.world, 1))
        r = torch.arange(rows, device=x.device)
        dead = (r >= spec.index * per) & (r < (spec.index + 1) * per)
        shape = ((1,) * (x.ndim - 2) + (rows, 1)) if x.ndim >= 2 else dead.shape
        return x.masked_fill(dead.reshape(shape), float("nan"))
    raise AssertionError(spec.kind)  # unreachable (validated in __post_init__)


def inject(driver: str, x, point: str = POINT_INPUT):
    """Driver-boundary hook: pass ``x`` through the active plan.

    Returns ``x`` itself when no plan is active or no spec matches this
    (driver, point, call) site.  Matching specs corrupt out of place, emit a
    ``fault_inject`` trace event, and are logged on the plan.
    """
    plan = active()
    if plan is None:
        return x
    for spec in plan._take(driver, point):
        x = _apply(spec, x, plan.seed)
        trace_event("fault_inject", driver=driver, kind=spec.kind,
                    point=point, call=spec.call_index)
        count_event("slate_robust_faults_injected_total",
                    routine=driver, kind=spec.kind, point=point)
    return x
