"""Shared sweep-execution driver of the tester CLI (``python -m
slate_tpu_torch.testing``), so the parameter schema lives in exactly one place."""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.matrix import resolve_device
from .routines import run_routine
from .sweeper import DTYPES, TestResult

# numpy reference timings for --ref (≅ the reference's ScaLAPACK comparison path:
# run the same problem through the host reference library and report its time).
# Each entry is (make_inputs, op) so only the op itself is timed — input
# generation stays outside the clock, matching how the library side is timed.
_REF_FNS = {
    "gemm": (lambda p, r: (r.standard_normal((p["m"], p["k"])),
                           r.standard_normal((p["k"], p["n"]))),
             lambda a, b: a @ b),
    "potrf": (lambda p, r: (_ref_spd(p, r),), np.linalg.cholesky),
    "posv": (lambda p, r: (_ref_spd(p, r), r.standard_normal((p["n"], 2))),
             np.linalg.solve),
    "gesv": (lambda p, r: (r.standard_normal((p["n"], p["n"]))
                           + p["n"] * np.eye(p["n"]),
                           r.standard_normal((p["n"], 2))),
             np.linalg.solve),
    "geqrf": (lambda p, r: (r.standard_normal((p["m"], p["n"])),), np.linalg.qr),
    "heev": (lambda p, r: (_ref_spd(p, r),), np.linalg.eigh),
    "svd": (lambda p, r: (r.standard_normal((p["m"], p["n"])),), np.linalg.svd),
}


def _ref_spd(p, r):
    g = r.standard_normal((p["n"], p["n"]))
    return g @ g.T + p["n"] * np.eye(p["n"])


def _ref_time(routine: str, params: dict) -> Optional[float]:
    entry = _REF_FNS.get(routine)
    if entry is None:
        return None
    make_inputs, op = entry
    inputs = make_inputs(params, np.random.default_rng(params["seed"]))
    t0 = time.perf_counter()
    op(*inputs)
    return time.perf_counter() - t0


def run_sweep(names: Sequence[str],
              dims: Sequence[Tuple[int, int, int]],
              dtypes: Sequence[str],
              nbs: Sequence[int],
              *,
              kind: str = "randn",
              cond: Optional[float] = None,
              seed: int = 0,
              repeat: int = 1,
              nrhs: int = 8,
              grid=None,
              ref: bool = False,
              progress: Optional[Callable[[TestResult], None]] = None,
              device=None,
              ) -> List[TestResult]:
    """Run the cartesian sweep on ``device`` (``cuda`` unless named; raises
    the port's ``SlateError`` when CUDA is asked for and missing); dtype
    letters are restored into each result's params for display.  ``ref``
    also times the numpy reference (where mapped).  The device is not a
    param, so the table's ``extra`` column reads as the JAX package's.  d/z
    sweeps need no precision scope: torch has float64 on every device."""
    dev = resolve_device(device)
    results: List[TestResult] = []
    for routine in names:
        for (m, n, k) in dims:
            for nb in nbs:
                for tletter in dtypes:
                    params = {"m": m, "n": n, "k": k, "nb": nb,
                              "dtype": DTYPES[tletter], "kind": kind,
                              "cond": cond, "seed": seed, "repeat": repeat,
                              "nrhs": nrhs, "grid": grid}
                    r = run_routine(routine, params, device=dev)
                    if ref and r.ok:
                        r.ref_time_s = _ref_time(routine, params)
                    r.params = dict(r.params, dtype=tletter)
                    results.append(r)
                    _count_row(r, tletter)
                    if progress is not None:
                        progress(r)
    return results


def _count_row(r: TestResult, tletter: str) -> None:
    """Mirror each sweep row into the metrics registry (the tester's
    contribution to the shared metrics.json: row counts by status, plus the
    wall-time histogram)."""
    try:
        from .. import obs

        obs.counter("slate_tester_rows_total",
                    "tester sweep rows by routine/status").inc(
                        routine=r.routine, status=r.status, dtype=tletter)
        if r.time_s is not None:
            obs.histogram("slate_tester_row_seconds",
                          "tester row wall time").observe(
                              r.time_s, routine=r.routine, dtype=tletter)
    except Exception:  # pragma: no cover - telemetry never fails a sweep
        pass
