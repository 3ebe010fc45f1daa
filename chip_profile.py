#!/usr/bin/env python3
"""Where the time of the port's full-width solver steps goes on one CUDA card.

    python3 chip_profile.py [--steps gesv,calu_pp,...] [--trace-dir DIR]

For each step (the shapes of ``chip_smoke.py``'s main paths): one warm-up call,
one timed call (host clock around the call and a device sync), then one call
under ``torch.profiler`` (CPU and CUDA activities).  Prints, one ``key: value``
line each: the timed call's host seconds, the device busy time of the profiled
call (the sum of its kernels' and copies' own device time), the idle share
``1 - busy / host seconds``, and the kernels that took the most device time,
grouped by name.  With ``--trace-dir`` it writes a chrome trace per step.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

import chip_smoke as cs
import slate_tpu_torch as slate

TOP = 8


def _steps():
    g, f32, f64 = cs.GENERAL, torch.float32, torch.float64
    n, k = g["n"], g["nrhs"]
    calu = {"method_lu": "calu", "block_size": g["calu_nb"],
            "inner_blocking": g["calu_ib"]}

    def general():
        return (cs.randn((n, n), f32, "cuda", cs.SEED + 10),
                cs.randn((n, k), f32, "cuda", cs.SEED + 11))

    def spd32():
        return (cs.spd(n, torch.Generator(device="cuda").manual_seed(cs.SEED), "cuda", f32),
                cs.randn((n, k), f32, "cuda", cs.SEED + 1))

    def tall():
        return (cs.randn((g["ls_m"], g["ls_n"]), f32, "cuda", cs.SEED + 13),
                cs.randn((g["ls_m"], g["ls_nrhs"]), f32, "cuda", cs.SEED + 14))

    def spd64():
        return (cs.spd(n, torch.Generator(device="cuda").manual_seed(cs.SEED + 16), "cuda",
                       f64), cs.randn((n, k), f64, "cuda", cs.SEED + 15))

    def general64():
        return (cs.randn((n, n), f64, "cuda", cs.SEED + 17),
                cs.randn((n, k), f64, "cuda", cs.SEED + 15))

    return {
        "posv": (spd32, lambda A, B: slate.posv(A, B, {"target": "tiled",
                                                         "block_size": cs.NB}, "lower")),
        "gesv": (general, lambda A, B: slate.gesv(A, B)),
        "calu_tournament": (general, lambda A, B: slate.getrf(A, dict(
            calu, lu_panel="tournament"))),
        "calu_pp": (general, lambda A, B: slate.getrf(A, dict(calu, lu_panel="pp"))),
        "gels_cholqr": (tall, lambda A, B: slate.gels_cholqr(A, B)),
        "gels_qr": (tall, lambda A, B: slate.gels_qr(A, B)),
        "posv_mixed": (spd64, lambda A, B: slate.posv_mixed(A, B)),
        "gesv_mixed": (general64, lambda A, B: slate.gesv_mixed(A, B)),
    }


def _device_events(prof):
    """Per-name averages of the events that ran on the card (kernels, copies,
    memsets), without the profiler's own buffer bookkeeping."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Buffer Flush", "Activity Buffer"))]
    return sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)


def profile_step(name, make, call, trace_dir=None) -> dict:
    A, B = make()
    call(A, B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(A, B)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call(A, B)
        torch.cuda.synchronize()
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    rows = _device_events(prof)
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    out = {"host_s": host_s, "device_busy_s": busy_s,
           "idle_share": 1.0 - busy_s / host_s,
           "device_launches": sum(e.count for e in rows)}
    for e in rows[:TOP]:
        out[f"kernel[{e.key[:70]}]"] = (f"{e.self_device_time_total / 1e3:.3f} ms "
                                        f"in {e.count} launches")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    steps = _steps()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default=",".join(steps))
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    cs.say("nvidia-smi", cs.nvidia_smi())
    for name in args.steps.split(","):
        make, call = steps[name]
        for key, v in profile_step(name, make, call, args.trace_dir).items():
            cs.say(f"{name}_{key}", v)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
