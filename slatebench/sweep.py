"""Find the knee of a served cell once: run its mix at several fixed rates.

    python3 slatebench/sweep.py --workload <name> --rates 500,1000,2000 --seconds 6

Cells of ``BENCHMARK.json`` and of ``staged_cells.json`` alike.

For each rate one short window of the cell's own entry, with the rate in
place of the traffic file's: the rate completed in the window, the p50 and
p95 latency from when each request was due, the requests that came in after
the window closed (the backlog), and how late the client submitted.  A rate
the system sustains completes about what it offers and leaves no backlog.
The cell's fixed rate is chosen from this once, and written in its traffic
file; the benchmark's own runs never search for a rate.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import slatebench.run as bench  # noqa: E402


def main(argv=None) -> int:
    import argparse
    import json

    import numpy as np

    from slatebench.cells import load_benchmark

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=987654321)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench.use_checkout_caches()
    for rate in [float(v) for v in args.rates.split(",")]:
        run, res = bench.execute(args.workload, args.seed, args.seconds, False,
                                 device=args.device,
                                 traffic={"rate_per_s": rate},
                                 bench=load_benchmark(staged=True))
        lat = np.asarray(run.latency_s)
        print(json.dumps({
            "workload": args.workload, "rate": rate,
            "completed_per_s": run.completed_in_window / run.window_s,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "after_close": int(len(lat) - run.completed_in_window),
            "submit_late_ms": run.submit_late_s * 1e3,
            "setup_s": run.setup_s, "correct": res["correct"],
            "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
