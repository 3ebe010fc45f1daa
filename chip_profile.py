#!/usr/bin/env python3
"""Where the time of the port's full-width solver steps goes on one CUDA card.

    python3 chip_profile.py [--steps gesv,calu_pp,serve,...] [--trace-dir DIR]

For each solver step (the shapes of ``chip_smoke.py``'s main paths): one
warm-up call, one timed call (host clock around the call and a device sync),
then one call under ``torch.profiler``.  The eig steps are ``heev`` (values,
n = 16384 f32), ``svd`` (``svd_vals``, 16384), ``heev2s`` and ``svd2s``
(two-stage values with the pipelined chase, 8192).  Prints, one
``key: value`` line each: the timed call's host seconds, the device busy time
of the profiled call (the sum of its kernels' and copies' own device time,
read from the raw trace), the idle share ``1 - busy / host seconds``, the
device launches, and the kernels that took the most device time, grouped by
name.  The profiler traces the card alone; with ``--trace-dir`` it also
traces the host and writes a chrome trace per step.

The ``serve`` step is the measured pass of ``serve.run_mixed_workload``
(1200 ``make_requests`` requests, default policy, one executor, as in
``chip_smoke.py``'s serve phase) on a freshly warmed queue: after one pass
for warm-in, one pass times the host clock from the first submit to the last
result, and one more is profiled over the same window; the idle share is the
profiled device busy time over the unprofiled pass.  Exits non-zero without
CUDA.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
import slate_tpu_torch as slate
from slate_tpu_torch import serve

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

    e = cs.EIG

    def sym(n, seed):
        return lambda: (cs.sym_normal(n, f32, "cuda", seed), None)

    def normal(n, seed):
        return lambda: (cs.randn((n, n), f32, "cuda", seed), None)

    return {
        "heev": (sym(e["n"], cs.SEED + 50), lambda A, _: slate.heev(
            A, uplo="lower", want_vectors=False)),
        "svd": (normal(e["n"], cs.SEED + 51), lambda A, _: slate.svd_vals(A)),
        "heev2s": (sym(e["two_stage_n"], cs.SEED + 52), lambda A, _: slate.heev(
            A, want_vectors=False, method="two_stage", chase_pipeline=True)),
        "svd2s": (normal(e["two_stage_n"], cs.SEED + 53), lambda A, _: slate.svd(
            A, want_u=False, want_vt=False, method="two_stage", chase_pipeline=True)),
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


def _raw_device_totals(prof):
    """{name: [device ns, launches]} of the card's events (kernels, copies,
    memsets) in the raw trace, without the profiler's own buffer
    bookkeeping.  The raw events, not ``key_averages()``: the two-stage
    steps' traces hold millions of launches, which the latter's event tree
    does not finish within minutes."""
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith(("Buffer Flush", "Activity Buffer")):
            continue
        tot = per.setdefault(name, [0, 0])
        tot[0] += e.duration_ns()
        tot[1] += 1
    return per


def _device_summary(prof) -> dict:
    """Device busy seconds, launches and the top kernels of one profile."""
    per = _raw_device_totals(prof)
    rows = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)
    out = {"device_busy_s": sum(ns for ns, _ in per.values()) / 1e9,
           "device_launches": sum(c for _, c in per.values())}
    for key, (ns, count) in rows[:TOP]:
        out[f"kernel[{key[:70]}]"] = f"{ns / 1e6:.3f} ms in {count} launches"
    return out


def _activities(trace_dir) -> list:
    """The card alone, and the host too when a chrome trace is asked for."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if trace_dir:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    return acts


def profile_step(name, make, call, trace_dir=None) -> dict:
    A, B = make()
    call(A, B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(A, B)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=_activities(trace_dir)) as prof:
        call(A, B)
        torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t0
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    dev = _device_summary(prof)
    return {"host_s": host_s, "profiled_host_s": profiled_s,
            "idle_share": 1.0 - dev["device_busy_s"] / host_s, **dev}


def _hist_totals(name: str) -> tuple:
    """(sum, count) over every series of one obs histogram."""
    h = slate.obs.REGISTRY.get(name)
    states = list(h.series().values()) if h is not None else []
    return sum(s["sum"] for s in states), sum(s["count"] for s in states)


def _serve_pass(reqs, combos, prof=None) -> tuple:
    """The mixed workload's measured pass on a fresh warmed queue (default
    policy, one executor, ``cuda``), optionally inside ``prof`` from the end
    of the warm-up to the last result: returns (host seconds, tickets)."""
    slate.obs.reset()
    with serve.ServeQueue(cache=serve.ExecutableCache()) as q:
        q.warmup(combos, dtype=reqs[0][1].dtype)
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        tickets = [q.submit(r, a, b) for r, a, b in reqs]
        for t in tickets:
            cs.require(t.result(timeout=300.0)[1] == 0, "a served request failed")
        wall = time.perf_counter() - t0
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
    return wall, tickets


def profile_serve(trace_dir=None) -> dict:
    """Device busy time and idle share of the mixed workload's measured
    pass (see the module docstring), and the unprofiled pass's host-side
    stage totals from the obs registry and the tickets: submit (the
    caller's thread), pad + copy and execute (the executor's threads, per
    batch), resolve (per request)."""
    n = cs.SERVE["requests"]
    reqs = serve.make_requests(n, seed=0)
    combos = sorted({(r, a.shape[0], a.shape[1], b.shape[1]) for r, a, b in reqs})
    _serve_pass(reqs, combos)                    # process warm-in
    wall, tickets = _serve_pass(reqs, combos)
    lat = [t.latency_s * 1e3 for t in tickets]
    pad_s, batches = _hist_totals("slate_serve_pad_seconds")
    exec_s, _ = _hist_totals("slate_serve_execute_seconds")
    occ_sum, _ = _hist_totals("slate_serve_batch_occupancy")
    prof = torch.profiler.profile(activities=_activities(trace_dir))
    wall_p, _ = _serve_pass(reqs, combos, prof)
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir, "serve.json"))
    dev = _device_summary(prof)
    busy_s, launches = dev["device_busy_s"], dev["device_launches"]
    out = {"requests": n, "host_s": wall, "solves_per_sec": n / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "profiled_host_s": wall_p,
           "idle_share": 1.0 - busy_s / wall,
           "idle_share_of_profiled_pass": 1.0 - busy_s / wall_p,
           "batches": batches,
           "device_launches_per_batch": launches / max(batches, 1),
           "mean_occupancy": occ_sum / max(batches, 1),
           "host_submit_s": sum(t.stages["submit"] for t in tickets),
           "host_pad_s": pad_s, "execute_s": exec_s,
           "host_resolve_s": sum(t.stages["resolve"] for t in tickets), **dev}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    steps = _steps()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default=",".join(list(steps) + ["serve"]))
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    cs.say("nvidia-smi", cs.nvidia_smi())
    for name in args.steps.split(","):
        cs.say(f"{name}_start_s", time.perf_counter())
        if name == "serve":
            res = profile_serve(args.trace_dir)
        else:
            make, call = steps[name]
            res = profile_step(name, make, call, args.trace_dir)
        for key, v in res.items():
            cs.say(f"{name}_{key}", v)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
