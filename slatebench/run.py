"""Run one cell of the benchmark once and print its result line.

    python3 slatebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix, entry
and metric readers are found by the names in ``BENCHMARK.json``
(:mod:`slatebench.cells`).  The run makes its inputs from the seed, warms up
every shape it will use (counted in ``setup_s``), measures for ``--seconds``,
then checks the answers the timed path produced against the plain reference
(:mod:`slatebench.reference`).  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from one profiler window over the same measured window.

The last line of standard output is one JSON object; each number compared
is printed beside its limit as the last lines of standard error and under
``checks``, the result's last key.  The run prints no result, and exits
nonzero, without CUDA or with fewer cards than the cell asks for, and when
JAX or the JAX package is loaded in the process once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: build and kernel caches, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, "slatebench_cache")
CACHE_VARS = (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
              ("TRITON_CACHE_DIR", "triton"),
              ("CUDA_CACHE_PATH", "nv_compute"),
              ("SLATE_TPU_FLIGHT_PATH", "flight_records.json"))

FORBIDDEN = ("jax", "jaxlib", "flax", "slate_tpu")
_STARTED = False


class Run:
    """What one run saw: the window on the host's clock, the work done in
    it, the program's spans and counters, the device trace, and the checks.
    Entries fill it; metric readers read it."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t_process = T_PROCESS
        self.setup_s = None
        self.window_s = None
        self.flops = 0.0                 # model operations completed in the window
        self.bytes = 0.0                 # model bytes of the same work
        self.dtype = None                # the configuration's precision
        self.solves = []                 # dense cells: one dict per solve
        self.submit_late_s = 0.0         # served cells: the client's worst lag
        self.latency_s = []              # served cells: every request, due -> done
        self.completed_in_window = 0
        self.stages = {}                 # program spans: name -> list of seconds
        self.counters = {}               # program counters: name -> (sum, count)
        self.device_trace = None         # devtrace summary (--trace 1)
        self.checks = []                 # (name, value, limit)
        self.setup_marks = []            # (stage, seconds since set-up began)
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.peaks = None
        self.control_gap = None          # a served control's widest gap

    def mark(self, stage: str) -> None:
        """Note that set-up reached ``stage`` (seconds since it began)."""
        self.setup_marks.append((stage, time.perf_counter() - self.t_process))

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks)


def use_checkout_caches() -> None:
    """Point every build and kernel cache, and the serving tier's flight
    dump, at :data:`CACHE` (before torch starts)."""
    for var, sub in CACHE_VARS:
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def peaks_for(kind: str):
    with open(os.path.join(ROOT, "slatebench", "peaks.json")) as f:
        table = json.load(f)
    return table.get(kind)


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device=None, root: str = ROOT, entry_kw=None, traffic=None,
            bench=None):
    """Run one cell on ``device`` (the first card by default) and return
    ``(run, result)``; ``result`` is the JSON object of the last line.
    The tests call this with ``device="cpu"``; ``traffic`` overrides keys of
    the traffic file (the knee sweep's rates), ``entry_kw`` passes options
    to the entry (the control's solver), ``bench`` stands in for
    ``BENCHMARK.json`` (the staged cells)."""
    import torch

    from slatebench.cells import Cell, load_benchmark

    cell = Cell(bench or load_benchmark(root), workload, root)
    cell.traffic.update(traffic or {})
    dev = torch.device(device or "cuda")
    run = Run(cell, seed, seconds, trace)
    global _STARTED
    if _STARTED:            # a later run in one process: set-up starts here
        run.t_process = time.perf_counter()
    _STARTED = True
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        run.peaks = peaks_for(kind)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        kind = "cpu"
    run.mark("device_ready")
    cell.entry().run(run, dev, **(entry_kw or {}))
    metrics = {}
    for spec in cell.metrics(trace):
        value = cell.reader(spec["name"])(run, spec)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": run.correct, "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info}
    if trace and run.device_trace is not None:
        dt = run.device_trace
        device_info["busy_s"] = dt["busy_s"]
        device_info["window_s"] = dt["window_s"]
        result["breakdown"] = {"device_ops": dt["device_ops"],
                               "idle_gaps": dt["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in run.checks}
    return run, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()

    import torch

    from slatebench.cells import Cell, load_benchmark

    chips = Cell(load_benchmark(), args.workload).chips
    if not torch.cuda.is_available():
        print("slatebench: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"slatebench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found; nothing was run",
              file=sys.stderr)
        return 2
    run, result = execute(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print("slatebench: the process loaded " + ", ".join(bad) +
              "; no result", file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{s}={t:.3f}" for s, t in run.setup_marks) +
          f" window_opened={run.setup_s:.3f}", file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
