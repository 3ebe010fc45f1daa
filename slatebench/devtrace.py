"""The device's side of a traced run: one profiler window over the card.

``torch.profiler`` records the card's activity (kernels, copies, memsets)
through CUPTI for the whole measured window.  From its raw events this
module works out

* ``busy_s``: the union of every device interval inside the window, so two
  kernels that overlap on two streams count once, and the same split by the
  harness span the host was in (``busy_by_label``);
* ``window_s``: the window's length on the host's clock;
* the device operations that took most time, by name;
* the longest idle gaps, each labelled by the harness span (regenerate,
  solve, submit, ...) that the host was in at the gap's middle.

The device clock is tied to the host's by one marker kernel launched right
after the profiler starts, with nothing else running: its start on the card
is taken as the host time just before its launch (a few microseconds late,
which labelling millisecond gaps does not notice).
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: events of the profiler's own bookkeeping, not the program's work
_SKIP = ("Buffer Flush", "Activity Buffer")
TOP = 10
#: a kernel's name is cut to this many characters in the breakdown
NAME_CHARS = 160


class Spans:
    """Host spans of the harness: ``(t0, t1, label)`` on ``perf_counter``."""

    def __init__(self):
        self.items: List[Tuple[float, float, str]] = []
        self._starts: List[float] = []

    def add(self, t0: float, t1: float, label: str) -> None:
        self.items.append((t0, t1, label))

    def label_at(self, t: float, default: str) -> str:
        if len(self._starts) != len(self.items):
            self._starts = [s[0] for s in self.items]
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i][2]
        return default


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge overlapping ``(start, end)`` intervals (sorted on return)."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: Sequence[Tuple[int, int, str]], w0: int, w1: int,
              spans: Optional[Spans], to_host, idle_label: str) -> Dict:
    """Busy time, top operations and longest gaps of device ``events``
    (``(start_ns, end_ns, name)`` on the device clock) inside ``[w0, w1]``.
    ``to_host`` maps a device ns to host ``perf_counter`` seconds."""
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in events
               if e > w0 and s < w1]
    merged = union([(s, e) for s, e, _ in clipped if e > s])
    busy_ns = sum(e - s for s, e in merged)
    by_label: Dict[str, float] = {}
    for s, e in merged:
        label = (spans.label_at(to_host((s + e) // 2), idle_label) if spans
                 else idle_label)
        by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e9
    per: Dict[str, float] = {}
    for s, e, n in clipped:
        n = n[:NAME_CHARS]
        per[n] = per.get(n, 0.0) + (e - s) / 1e9
    ops = sorted(per.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    gaps = []
    prev = w0
    for s, e in merged + [(w1, w1)]:
        if s > prev:
            mid = to_host((prev + s) // 2)
            label = spans.label_at(mid, idle_label) if spans else idle_label
            gaps.append((label, (s - prev) / 1e9))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[1], reverse=True)
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "busy_by_label": by_label,
            "device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps[:TOP]],
            "intervals": merged}


class DeviceTrace:
    """One profiler window: ``start()`` at the window's start, ``stop()`` at
    its end, then :meth:`summary`."""

    def __init__(self, device: torch.device):
        self.device = device
        self._marker = torch.zeros(1, device=device)
        self.prof = None
        self.t_start = self.t_stop = 0.0
        self._h0_ns = 0

    def start(self) -> None:
        import torch.profiler as tp

        torch.cuda.synchronize(self.device)
        self.prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self._h0_ns = time.perf_counter_ns()
        self._marker.add_(1)
        torch.cuda.synchronize(self.device)
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        self.t_stop = time.perf_counter()
        torch.cuda.synchronize(self.device)
        self.prof.stop()

    def events(self) -> List[Tuple[int, int, str]]:
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = e.name()
            if name.startswith(_SKIP):
                continue
            s = e.start_ns()
            out.append((s, s + e.duration_ns(), name))
        out.sort()
        return out

    def summary(self, spans: Optional[Spans], idle_label: str) -> Dict:
        ev = self.events()
        if not ev:
            raise RuntimeError("the profiler recorded no device activity")
        offset = ev[0][0] - self._h0_ns          # the marker kernel
        ev = ev[1:]
        w0 = int(self.t_start * 1e9) + offset
        w1 = int(self.t_stop * 1e9) + offset
        return summarize(ev, w0, w1, spans,
                         lambda ns: (ns - offset) / 1e9, idle_label)
