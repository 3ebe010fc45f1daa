"""Read the numbers that set a cell's limits: the program's on many seeds,
and the control's, the plain reference one precision below the
configuration's in the program's place.

    python3 slatebench/control.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2

One JSON line per run, with every number compared and, for a control run,
the control's reading.  Each entry's ``control_options()`` says how: a dense
cell's control solves in f32 in the place of ``gesv`` and is judged as the
program is; a served cell's control answers the same sampled requests from
operands rounded to TF32 (``reference.dense.solve_tf32``), next to the
program's own answers.  The benchmark's own runs never run a control.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import slatebench.run as bench  # noqa: E402


def main(argv=None) -> int:
    import argparse
    import json

    from slatebench.cells import Cell, load_benchmark

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench.use_checkout_caches()
    table = load_benchmark(staged=True)
    cell = Cell(table, args.workload)
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        run, res = bench.execute(args.workload, seed, args.seconds, False,
                                 device=args.device, bench=table,
                                 entry_kw=(cell.entry().control_options() if control
                                           else None))
        line = {"workload": args.workload, "seed": seed,
                "side": "control" if control else "program",
                "correct": res["correct"], "checks": res["checks"]}
        if run.control_gap is not None:
            line["control_gap_max"] = run.control_gap
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
