"""Tester CLI: ``python -m slate_tpu_torch.testing <routine|category|all> [flags]``.

≅ the reference's ``tester`` binary (test/test.cc:654-663 main + dispatch table).
Rows run on ``--device`` (default ``cuda``); without CUDA the CLI exits non-zero
with the port's ``SlateError`` unless ``--device cpu`` is given.  Examples::

    python -m slate_tpu_torch.testing gemm --dim 128:512:128 --type s --nb 64
    python -m slate_tpu_torch.testing cholesky --dim 256 --type s,c --ref
    python -m slate_tpu_torch.testing all --quick
    python -m slate_tpu_torch.testing posv --dim 64 --device cpu
"""

from __future__ import annotations

import argparse
import sys

from ..core.exceptions import SlateError
from ..core.matrix import resolve_device
from .driver import run_sweep
from .routines import ROUTINES
from .sweeper import DTYPES, format_table, parse_dims, parse_list


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m slate_tpu_torch.testing",
        description="slate_tpu_torch routine tester (TestSweeper-style sweeps)")
    ap.add_argument("routine",
                    help="routine name, category (blas3/cholesky/lu/qr/eig/svd/"
                         "band/indefinite/aux/condest), or 'all'")
    ap.add_argument("--dim", default="128",
                    help="dims: N | N1,N2 | start:stop:step | MxN | MxNxK")
    ap.add_argument("--type", default="s", help="s,d,c,z")
    ap.add_argument("--nb", default="64", help="tile sizes (comma list)")
    ap.add_argument("--matrix", default="randn", dest="kind",
                    help="matgen kind for general inputs")
    ap.add_argument("--cond", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1, help="timing repeats (best-of)")
    ap.add_argument("--ref", action="store_true",
                    help="also time the numpy reference (ref(s) column)")
    ap.add_argument("--quick", action="store_true", help="small fixed sweep")
    ap.add_argument("--list", action="store_true", help="list routines and exit")
    ap.add_argument("--device", default="cuda",
                    help="device the rows run on (cuda, cuda:N or cpu)")
    return ap


def select_routines(token: str):
    if token == "all":
        return sorted(ROUTINES)
    if token in ROUTINES:
        return [token]
    cats = sorted(r for r, s in ROUTINES.items() if s["category"] == token)
    if not cats:
        raise SystemExit(f"unknown routine/category '{token}'; "
                         f"known routines: {sorted(ROUTINES)}")
    return cats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        for name in sorted(ROUTINES):
            print(f"{name:16s} {ROUTINES[name]['category']:12s}"
                  f" {ROUTINES[name]['doc'].splitlines()[0] if ROUTINES[name]['doc'] else ''}")
        return 0

    try:
        device = resolve_device(args.device)
    except SlateError as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2

    dims = parse_dims("64,96" if args.quick else args.dim)
    dtypes = parse_list(args.type)
    unknown = [t for t in dtypes if t not in DTYPES]
    if unknown:
        raise SystemExit(f"unknown type letters {unknown}; use s,d,c,z")

    def progress(r):
        print(f"  {r.routine} {r.params.get('dtype')} "
              f"{r.params['m']}x{r.params['n']} nb={r.params['nb']}: {r.status}",
              flush=True)

    results = run_sweep(select_routines(args.routine), dims, dtypes,
                        [int(x) for x in parse_list(args.nb)],
                        kind=args.kind, cond=args.cond, seed=args.seed,
                        repeat=args.repeat, ref=args.ref, progress=progress,
                        device=device)
    print()
    print(format_table(results))
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
