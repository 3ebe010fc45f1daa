"""Admission control: priority lanes, token buckets, SLO-coupled shedding.

The serving queue *sees* overload through its SLO verdicts and stage
histograms; this module is how it *acts* on it — without it ``ServeQueue``
would admit unboundedly, and under overload every request would degrade
together.  It is the overload-survival discipline of an LLM inference server
applied to the solve tier (a copy of the JAX package's module: pure host
logic):

* **Priority lanes** — every request targets one of :data:`LANES`
  (``interactive`` > ``batch`` > ``best_effort``); the flush loop serves
  ready buckets in (lane priority, earliest deadline) order, so a backlog
  of best-effort work cannot starve interactive traffic.
* **Bounded admission** — an :class:`AdmissionPolicy` declares per-lane
  queue-depth bounds, a global in-flight cap, and per-lane token-bucket
  rate limits; :class:`AdmissionController` enforces them at ``submit``
  time, rejecting with a typed
  :class:`~slate_tpu_torch.core.exceptions.QueueOverloadError` that carries the
  lane, depth, reason, and a retry-after hint.
* **SLO-coupled shedding** — the controller consumes the queue's SLO
  verdicts (``ServeQueue.slo_verdicts()``): on ``warning`` it sheds the
  ``shed_on_warning`` lanes (default ``best_effort``); on ``breach`` it
  sheds every lane *below* the breaching SLO's protected lane.  The ladder
  degrades traffic from the bottom up — exactly the "brown-out, don't
  black-out" contract.
* **Escalation budget** — :class:`EscalationBudget` caps element-granular
  ladder re-runs per window, so a poisoned workload's retry storm cannot
  starve fresh traffic (capped elements resolve with their typed
  numerical error and ``recovered=False``).

Everything takes an injected clock (``clock=`` callable) so the unit tests
pin token-bucket and window math deterministically — no wall-clock sleeps.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from ..core.exceptions import QueueOverloadError, SlateError

#: priority lanes, highest first (index = priority; lower is better)
LANES = ("interactive", "batch", "best_effort")
LANE_PRIORITY: Dict[str, int] = {lane: i for i, lane in enumerate(LANES)}

#: the lane a request lands in when ``submit`` names none
DEFAULT_LANE = "interactive"


def lane_priority(lane: str) -> int:
    """Priority index of ``lane`` (0 = most important).  Unknown lanes are
    a *configuration* error (ValueError) — never an overload verdict."""
    try:
        return LANE_PRIORITY[lane]
    except KeyError:
        raise ValueError(f"unknown lane {lane!r}; "
                         f"expected one of {LANES}") from None


class TokenBucket:
    """Deterministic token bucket: ``rate`` tokens/s, ``burst`` capacity.

    Starts full.  ``try_take(now=...)`` is the whole API — refill is lazy
    from the elapsed clock, so there is no background thread and the math
    is exactly replayable with an injected clock."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"token bucket needs positive rate/burst, got "
                             f"rate={rate}, burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        if now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = max(self._t, now)

    def try_take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        """Take ``n`` tokens if available; False (and no debit) otherwise."""
        with self._lock:
            self._refill(self._clock() if now is None else float(now))
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self, now: Optional[float] = None) -> float:
        with self._lock:
            self._refill(self._clock() if now is None else float(now))
            return self._tokens

    def retry_after_s(self, n: float = 1.0,
                      now: Optional[float] = None) -> float:
        """Seconds until ``n`` tokens will be available (0 if already)."""
        return max(n - self.tokens(now), 0.0) / self.rate

    def set_rate(self, rate: float, now: Optional[float] = None) -> None:
        """Re-rate the bucket in place (capacity recalibration when the
        executor pool shrinks/grows).  The elapsed window refills at the
        OLD rate first, so the switch is exact, not retroactive; banked
        tokens above the (unchanged) burst cap are kept until spent."""
        if rate <= 0:
            raise ValueError(f"token bucket rate must stay positive, "
                             f"got {rate}")
        with self._lock:
            self._refill(self._clock() if now is None else float(now))
            self.rate = float(rate)


class EscalationBudget:
    """Fixed-window cap on escalation-ladder re-runs.

    ``take(n)`` returns how many of ``n`` requested re-runs the current
    window still affords (and debits them).  The window resets when
    ``window_s`` elapses — a retry storm gets ``cap`` re-runs per window
    and the rest resolve with their typed error instead of monopolizing
    the worker."""

    def __init__(self, cap: int, window_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if cap < 0 or window_s <= 0:
            raise ValueError(f"escalation budget needs cap >= 0 and a "
                             f"positive window, got cap={cap}, "
                             f"window_s={window_s}")
        self.cap = int(cap)
        self.window_s = float(window_s)
        self._clock = clock
        self._window_start = clock()
        self._used = 0
        self._lock = threading.Lock()

    def take(self, n: int = 1, now: Optional[float] = None) -> int:
        with self._lock:
            now = self._clock() if now is None else float(now)
            if now - self._window_start >= self.window_s:
                self._window_start = now
                self._used = 0
            allowed = max(min(int(n), self.cap - self._used), 0)
            self._used += allowed
            return allowed


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The declared overload contract of one queue.

    max_depth:       per-lane pending-ticket bound (mapping or one int for
                     all lanes).  The *bounded queue* part of the contract:
                     beyond it, new submissions shed with reason ``depth``.
    max_in_flight:   global cap on admitted-but-unresolved requests
                     (pending + popped-for-execution) across all lanes.
    rate / burst:    optional per-lane token buckets (tokens/s, capacity);
                     lanes absent from ``rate`` are not rate-limited.
    shed_on_warning: lanes shed while any SLO verdict reads ``warning``.
    slo_lanes:       SLO name -> the lane that objective protects (used to
                     place the ``breach`` shed floor); unlisted SLOs
                     protect ``interactive``.
    max_escalations_per_window / escalation_window_s: the escalation
                     budget (ladder re-runs per window across the queue).
    slo_refresh_s:   how often the controller re-consumes the queue's SLO
                     verdicts (admission reads a cached shed set between
                     refreshes — submit stays O(1)).
    retry_after_s:   default retry hint stamped on depth/SLO rejections.

    The defaults admit everything a sane workload submits (deep lanes, no
    rate limits) — the non-overload serving path is unchanged until a
    deployment declares tighter bounds.
    """

    max_depth: object = 4096                  # int, or {lane: int}
    max_in_flight: int = 8192
    rate: Mapping[str, float] = dataclasses.field(default_factory=dict)
    burst: Mapping[str, float] = dataclasses.field(default_factory=dict)
    shed_on_warning: Tuple[str, ...] = ("best_effort",)
    slo_lanes: Mapping[str, str] = dataclasses.field(default_factory=dict)
    max_escalations_per_window: int = 64
    escalation_window_s: float = 1.0
    slo_refresh_s: float = 0.25
    retry_after_s: float = 0.1

    def __post_init__(self):
        # config typos are bugs to surface at construction, not as a
        # mysterious shed (or a silently unlimited lane) under load
        named = set(self.rate) | set(self.burst) | \
            set(self.shed_on_warning) | set(self.slo_lanes.values())
        if isinstance(self.max_depth, Mapping):
            named |= set(self.max_depth)
        unknown = named - set(LANES)
        if unknown:
            raise ValueError(f"AdmissionPolicy: unknown lane(s) "
                             f"{sorted(unknown)}; expected {LANES}")
        bad_rate = {k: v for k, v in self.rate.items() if v <= 0}
        if bad_rate:
            raise ValueError(f"AdmissionPolicy: rate must be positive "
                             f"tokens/s (omit the lane to leave it "
                             f"unlimited), got {bad_rate}")
        if any(v <= 0 for v in self.burst.values()):
            raise ValueError(f"AdmissionPolicy: burst must be positive, "
                             f"got {dict(self.burst)}")
        orphan = set(self.burst) - set(self.rate)
        if orphan:
            raise ValueError(f"AdmissionPolicy: burst for lane(s) "
                             f"{sorted(orphan)} without a matching rate")

    def depth_limit(self, lane: str) -> int:
        if isinstance(self.max_depth, Mapping):
            return int(self.max_depth.get(lane, 4096))
        return int(self.max_depth)

    def slo_lane(self, slo_name: str) -> str:
        return self.slo_lanes.get(slo_name, DEFAULT_LANE)


def shed_lanes_from_verdicts(verdicts: Sequence, policy: AdmissionPolicy
                             ) -> Dict[str, str]:
    """``{lane: reason}`` of lanes the verdict set sheds.

    ``warning`` anywhere sheds ``policy.shed_on_warning``; ``breach`` on an
    SLO protecting lane L sheds every lane of strictly lower priority than
    L (the shed floor).  Breach reasons win over warning reasons."""
    shed: Dict[str, str] = {}
    for v in verdicts:
        verdict = getattr(v, "verdict", v if isinstance(v, str) else None)
        if verdict == "warning":
            for lane in policy.shed_on_warning:
                shed.setdefault(lane, "slo_warning")
        elif verdict == "breach":
            floor = lane_priority(policy.slo_lane(getattr(v, "name", "")))
            for lane in LANES:
                if LANE_PRIORITY[lane] > floor:
                    shed[lane] = "slo_breach"
    return shed


class AdmissionController:
    """Enforces one :class:`AdmissionPolicy` at the queue's submit boundary.

    The queue owns the depth/in-flight numbers (they live under its lock);
    the controller owns the rate buckets, the cached SLO shed set, and the
    escalation budget.  ``admit`` either returns (request admitted) or
    raises :class:`QueueOverloadError` — the decision is O(1): depth and
    in-flight comparisons, one cached-set lookup, one bucket take."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or AdmissionPolicy()
        self._clock = clock
        # rate entries are validated positive by AdmissionPolicy
        self._buckets = {
            lane: TokenBucket(
                r, self.policy.burst.get(lane, max(r, 1.0)), clock=clock)
            for lane, r in self.policy.rate.items()}
        self.escalations = EscalationBudget(
            self.policy.max_escalations_per_window,
            self.policy.escalation_window_s, clock=clock)
        self._shed: Dict[str, str] = {}
        self._shed_t = float("-inf")
        self._lock = threading.Lock()
        # calibration-time rates: scale_capacity re-rates the live buckets
        # from these, so repeated rescales never compound
        self._base_rates = dict(self.policy.rate)
        self.capacity_fraction = 1.0

    def scale_capacity(self, fraction: float) -> None:
        """Re-key every token bucket off *surviving* capacity.

        The serving queue calls this when its executor pool changes size
        mid-run (an executor died, capacity shrank): each lane's bucket is
        re-rated to ``fraction`` x its calibration-time rate, so admission
        keeps shedding at the rate the SURVIVORS can actually serve — not
        the rate the full pool was calibrated for.  Idempotent per
        fraction; rescales never compound."""
        if not 0.0 < fraction:
            raise ValueError(f"capacity fraction must be positive, "
                             f"got {fraction}")
        with self._lock:
            self.capacity_fraction = float(fraction)
        for lane, base in self._base_rates.items():
            bucket = self._buckets.get(lane)
            if bucket is not None:
                bucket.set_rate(max(base * fraction, 1e-9))

    # -- the SLO coupling ----------------------------------------------------
    def consume_verdicts(self, verdicts: Sequence) -> Dict[str, str]:
        """Recompute the shed set from fresh SLO verdicts (returns it)."""
        shed = shed_lanes_from_verdicts(verdicts, self.policy)
        with self._lock:
            self._shed = shed
            self._shed_t = self._clock()
        return dict(shed)

    def maybe_refresh(self, evaluate: Callable[[], Sequence],
                      now: Optional[float] = None) -> None:
        """Throttled verdict refresh: calls ``evaluate`` (the queue's
        ``slo_verdicts``) at most once per ``policy.slo_refresh_s``."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            if now - self._shed_t < self.policy.slo_refresh_s:
                return
            self._shed_t = now      # claim the refresh before evaluating
        verdicts = evaluate()
        shed = shed_lanes_from_verdicts(verdicts, self.policy)
        with self._lock:
            self._shed = shed

    def shed_lanes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._shed)

    # -- the decision --------------------------------------------------------
    def admit(self, lane: str, depth: int, in_flight: int,
              now: Optional[float] = None) -> None:
        """Admit one request to ``lane`` or raise :class:`QueueOverloadError`.

        ``depth`` is the lane's current pending count, ``in_flight`` the
        queue-wide admitted-but-unresolved count (both owned by the caller's
        lock)."""
        if lane not in LANE_PRIORITY:
            raise SlateError(f"serve: unknown lane {lane!r}; "
                             f"expected one of {LANES}")
        with self._lock:
            slo_reason = self._shed.get(lane)
        if slo_reason is not None:
            raise QueueOverloadError(
                lane=lane, depth=depth, reason=slo_reason,
                retry_after_s=self.policy.retry_after_s)
        if depth >= self.policy.depth_limit(lane):
            raise QueueOverloadError(
                lane=lane, depth=depth, reason="depth",
                retry_after_s=self.policy.retry_after_s)
        if in_flight >= self.policy.max_in_flight:
            raise QueueOverloadError(
                lane=lane, depth=depth, reason="inflight",
                retry_after_s=self.policy.retry_after_s)
        bucket = self._buckets.get(lane)
        if bucket is not None and not bucket.try_take(now=now):
            raise QueueOverloadError(
                lane=lane, depth=depth, reason="rate",
                retry_after_s=bucket.retry_after_s(now=now))
