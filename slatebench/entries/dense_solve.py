"""Back-to-back dense solves, one large system at a time: HPL's loop.

Each solve draws a fresh A and b in place from (seed, solve index)
(:func:`slatebench.gen.hpl_fill`), hands both to the program's ``gesv`` on
the card with default options, keeps x and info, and waits for the card.
One solve of a system the window never sees warms every shape first.  The
window runs from the first solve's start to the end of the last solve begun
before ``--seconds`` ran out.

Once the window has closed, the peak memory read and the program's state
freed, every solve's A and b are drawn again and its x is held to HPL's
acceptance test (:mod:`slatebench.reference.dense`); every info must be 0.
"""

from __future__ import annotations

import math
import time

import torch

from slatebench import flops, gen
from slatebench.devtrace import DeviceTrace, Spans
from slatebench.reference import dense

WARM_INDEX = 1 << 40          # the warm solve's system, never one of the window's


def program_solver():
    """The system under test: ``slate_tpu_torch.gesv`` -> (x, info)."""
    import slate_tpu_torch as st
    from slate_tpu_torch.utils import trace as st_trace

    def solve(A, b):
        X, _perm, info = st.gesv(A, b)
        return X, info, st_trace.last_phases("getrf").get("pivots")
    return solve


def control_options():
    """The control: the plain reference in f32 in the program's place."""
    def solve(A, b):
        return dense.solve_f32(A, b), torch.zeros((), dtype=torch.int32), None
    return {"solver": solve}


def run(r, device, solver=None) -> None:
    cfg = r.cell.config
    n = int(cfg["N"])
    dtype = getattr(torch, cfg["dtype"])
    r.dtype = cfg["dtype"]
    solve = solver or program_solver()
    r.mark("program_imported")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda *a: None))
    A = torch.empty((n, n), dtype=dtype, device=device)
    b = torch.empty((n, 1), dtype=dtype, device=device)
    g = torch.Generator(device=device)
    gen.hpl_fill(A, b, g, r.seed, WARM_INDEX)
    sync(device)
    r.mark("inputs_made")
    solve(A, b)                                                  # warm-up
    sync(device)
    r.mark("warmed")

    spans = Spans()
    trace = DeviceTrace(device) if r.trace and device.type == "cuda" else None
    if trace is not None:
        trace.start()
    xs, infos = [], []
    t0 = time.perf_counter()
    r.setup_s = t0 - r.t_process
    i = 0
    t_end = t0
    while i == 0 or time.perf_counter() - t0 < r.seconds:
        ts = time.perf_counter()
        gen.hpl_fill(A, b, g, r.seed, i)
        sync(device)
        tg = time.perf_counter()
        x, info, pivots_s = solve(A, b)
        sync(device)
        t_end = time.perf_counter()
        spans.add(ts, tg, "regenerate")
        spans.add(tg, t_end, "solve")
        xs.append(x)
        infos.append(info)
        r.solves.append({"pivots_s": pivots_s})
        i += 1
    if trace is not None:
        trace.stop()
    r.window_s = t_end - t0
    r.flops = flops.hpl_flops(n) * len(xs)
    r.bytes = flops.solve_bytes(n, n, 1, A.element_size()) * len(xs)
    r.attempted = len(xs)
    if device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    if trace is not None:
        r.device_trace = trace.summary(spans, "between")

    info_bad = sum(int(v) != 0 for v in infos)
    worst = 0.0
    for k, x in enumerate(xs):
        gen.hpl_fill(A, b, g, r.seed, k)
        res = dense.hpl_scaled_residual(A, x, b)
        worst = max(worst, res if math.isfinite(res) else math.inf)
    r.failed = info_bad
    r.check("resid_max", worst, float(cfg["residual_limit"]))
    r.check("info_bad", info_bad, 0)
