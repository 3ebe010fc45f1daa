"""Parameter-sweep machinery (≅ the TestSweeper submodule the reference builds on).

Provides the dim/list grammar of the reference tester
(``--dim 100:500:100``, ``--dim 256,512``, ``--dim 100x200x300``), cartesian sweeps,
wall-clock timing with gflop/s columns from per-routine flop models (each timed
call ends in a sync of the devices its result lives on), and the fixed-width
results table (test/test.cc prints the same shape of table).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

DTYPES = {
    # reference type letters (s/d/c/z)
    "s": np.float32, "d": np.float64, "c": np.complex64, "z": np.complex128,
}


def parse_list(spec: str) -> List[str]:
    """Comma-separated token list: 'lower,upper' -> ['lower', 'upper']."""
    return [t for t in spec.split(",") if t]


def parse_dims(spec: str) -> List[Tuple[int, int, int]]:
    """TestSweeper dim grammar -> list of (m, n, k).

    - ``256`` one square dim; ``256,512`` a list; ``100:500:100`` a range
      (inclusive of stop when hit exactly);
    - ``100x200`` m x n (k = n); ``100x200x300`` m x n x k;
    - tokens may be mixed: ``64,128:256:64,100x50``.
    """
    out: List[Tuple[int, int, int]] = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if "x" in token:
            parts = [int(p) for p in token.split("x")]
            if len(parts) == 2:
                out.append((parts[0], parts[1], parts[1]))
            elif len(parts) == 3:
                out.append((parts[0], parts[1], parts[2]))
            else:
                raise ValueError(f"bad dim token '{token}'")
        elif ":" in token:
            parts = [int(p) for p in token.split(":")]
            if len(parts) == 2:
                parts.append(max(1, (parts[1] - parts[0]) // 4 or 1))
            start, stop, step = parts
            for v in range(start, stop + 1, step):
                out.append((v, v, v))
        else:
            v = int(token)
            out.append((v, v, v))
    return out


@dataclasses.dataclass
class TestResult:
    """One sweep row (≅ one TestSweeper output line)."""
    routine: str
    params: Dict[str, Any]
    error: Optional[float] = None
    time_s: Optional[float] = None
    gflops: Optional[float] = None
    ref_time_s: Optional[float] = None
    status: str = "pass"           # pass | FAILED | error | skipped
    message: str = ""
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # side-channel columns (the reference's --timer-level 2 phase map, IR
    # iteration counts, ...): never gates pass/fail, printed by --timers

    @property
    def ok(self) -> bool:
        return self.status in ("pass", "skipped")


class ParamSweep:
    """Cartesian sweep over named parameter lists.

    >>> sweep = ParamSweep(dim=[(64, 64, 64)], dtype=['s'], uplo=['lower'])
    >>> for params in sweep: ...
    """

    def __init__(self, **param_lists: Sequence[Any]):
        self.names = list(param_lists)
        self.lists = [list(param_lists[k]) for k in self.names]

    def __iter__(self):
        for combo in itertools.product(*self.lists):
            yield dict(zip(self.names, combo))

    def __len__(self):
        total = 1
        for lst in self.lists:
            total *= len(lst)
        return total


def time_call(fn, *args, repeat: int = 1, device=None, **kw) -> Tuple[Any, float]:
    """Best-of-``repeat`` wall time; each call ends when ``device`` (the row's
    device) is idle, so a CUDA row times its kernels and not their enqueue."""
    device = None if device is None else torch.device(device)
    best = float("inf")
    out = None
    for _ in range(max(1, repeat)):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return out, best


_COLUMNS = ["routine", "type", "m", "n", "k", "nb", "extra", "error", "time(s)",
            "gflops", "ref(s)", "status"]


def format_table(results: Iterable[TestResult]) -> str:
    """Fixed-width results table + summary line (the tester's stdout shape)."""
    results = list(results)       # the Iterable is walked twice (rows + summary)
    rows = []
    for r in results:
        p = r.params
        extra = ",".join(f"{k}={v}" for k, v in p.items()
                         if k not in ("m", "n", "k", "nb", "dtype", "dim"))
        rows.append([
            r.routine, str(p.get("dtype", "-")), str(p.get("m", "-")),
            str(p.get("n", "-")), str(p.get("k", "-")), str(p.get("nb", "-")),
            extra or "-",
            f"{r.error:.2e}" if r.error is not None else "-",
            f"{r.time_s:.4f}" if r.time_s is not None else "-",
            f"{r.gflops:.1f}" if r.gflops is not None else "-",
            f"{r.ref_time_s:.4f}" if r.ref_time_s is not None else "-",
            r.status + (f" ({r.message})" if r.message and r.status != "pass" else ""),
        ])
    widths = [max(len(_COLUMNS[i]), *(len(row[i]) for row in rows)) if rows
              else len(_COLUMNS[i]) for i in range(len(_COLUMNS))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(_COLUMNS, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for row in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    npass = sum(1 for r in results if r.status == "pass")
    nskip = sum(1 for r in results if r.status == "skipped")
    nfail = len(results) - npass - nskip
    lines.append(f"{len(results)} tests: {npass} pass, {nfail} failed, {nskip} skipped")
    return "\n".join(lines)
