"""CLI for slate-lint: ``python -m slate_tpu_torch.analysis``.

Modes::

    python -m slate_tpu_torch.analysis           # report all findings
    python -m slate_tpu_torch.analysis --check   # CI gate: rc!=0 on any
                                                 # non-baseline finding or
                                                 # reason-less baseline entry
    python -m slate_tpu_torch.analysis --update-baseline
    python -m slate_tpu_torch.analysis --rules   # rule table
    python -m slate_tpu_torch.analysis --collectives --pset 2,4,8 --device cpu
                                                 # Tier B schedule audit over
                                                 # the scaling registry, on a
                                                 # pool of gloo ranks per P
                                                 # (default device: cuda)
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import baseline as baseline_mod
from .lint import lint_package
from .rules import RULES, rule_table


def _print_rules() -> None:
    print(f"{'ID':8s} {'severity':8s} title")
    for rid, sev, title in rule_table():
        print(f"{rid:8s} {sev:8s} {title}")
        doc = RULES[rid].doc.replace("\n", " ")
        print(f"{'':8s} {'':8s}   {doc}")


def _run_lint(args) -> int:
    findings = lint_package()
    doc = baseline_mod.load(args.baseline)
    problems = baseline_mod.validate(doc)
    new, accepted, stale = baseline_mod.apply(findings, doc)

    if args.update_baseline:
        out = baseline_mod.build(findings, prev=doc)
        path = baseline_mod.save(out, args.baseline)
        todo = sum(1 for e in out["entries"]
                   if e["reason"].startswith("TODO"))
        print(f"wrote {path}: {len(out['entries'])} entries"
              + (f" ({todo} need a reason before --check passes)"
                 if todo else ""))
        return 0

    for f in accepted:
        if args.verbose:
            print(f.render(baselined=True))
    for f in new:
        print(f.render())
        if f.suggestion and (args.explain or args.check):
            print(f"    fix: {f.suggestion}")
    for e in stale:
        print(f"stale baseline entry (no longer matches): "
              f"{e['rule']} {e['path']} :: {e['line_text'][:60]}")
    for p in problems:
        print(f"baseline problem: {p}")

    print(f"slate-lint: {len(findings)} finding(s), {len(accepted)} "
          f"baselined, {len(new)} new, {len(stale)} stale baseline "
          f"entr{'y' if len(stale) == 1 else 'ies'}")
    if args.check:
        return 1 if (new or problems) else 0
    return 0


def _run_collectives(args) -> int:
    from .collective_audit import audit_routines, summarize

    pset = [int(p) for p in args.pset.split(",") if p]
    names = [t for t in args.routines.split(",") if t] \
        if args.routines else None

    def progress(row):
        status = (row.get("error") or row.get("skipped")
                  or f"{row['collective_sites']} collective site(s), "
                     f"{len(row['findings'])} finding(s)")
        print(f"P={row['P']} {row['routine']:28s} {status}", flush=True)

    try:
        rows = audit_routines(pset, names=names, progress=progress,
                              device=args.device)
    except (ValueError, RuntimeError) as e:
        # unknown routine names, or a rank pool that fails to start or
        # times out — report cleanly, don't traceback
        print(f"error: {e}")
        return 2
    audited, nfind, lines = summarize(rows)
    for line in lines:
        print(f"RACE {line}")
    skipped = sum(1 for r in rows if r.get("skipped"))
    errors = [r for r in rows if r.get("error")]
    for r in errors:
        print(f"ERROR P={r['P']} {r['routine']}: {r['error']}")
    print(f"collective-audit: {audited} routine runs verified at "
          f"P∈{{{args.pset}}}, {skipped} skipped (grid constraints), "
          f"{len(errors)} errors, {nfind} schedule finding(s)")
    return 1 if (nfind or errors) else 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m slate_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="CI gate: exit nonzero on non-baseline findings")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite analysis/baseline.json from current "
                         "findings (reasons carry over by fingerprint)")
    ap.add_argument("--baseline", default=None,
                    help="baseline path (default: analysis/baseline.json)")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--explain", action="store_true",
                    help="print fix suggestions under each finding")
    ap.add_argument("--verbose", action="store_true",
                    help="also print baselined findings")
    ap.add_argument("--collectives", action="store_true",
                    help="run the Tier B collective-schedule audit instead "
                         "of (or after) the AST tier")
    ap.add_argument("--pset", default="2,4,8",
                    help="rank counts for --collectives (default 2,4,8)")
    ap.add_argument("--routines", default=None,
                    help="comma list of routine names for --collectives")
    ap.add_argument("--device", default=None,
                    help="device of --collectives' grids (default cuda: P=1 "
                         "in this process, or a launcher's ranks; cpu: a "
                         "pool of gloo ranks per P)")
    args = ap.parse_args(argv)

    if args.check and args.update_baseline:
        # --update-baseline rewrites the baseline to absorb every current
        # finding, so a combined invocation would always "pass" — a CI job
        # wired that way gates nothing.  Refuse instead of silently skipping.
        ap.error("--check and --update-baseline are mutually exclusive "
                 "(updating the baseline makes the check vacuous)")
    if args.rules:
        _print_rules()
        return 0
    rc = 0
    if not args.collectives or args.check or args.update_baseline:
        rc = _run_lint(args)
    if args.collectives:
        rc = max(rc, _run_collectives(args))
    return rc


if __name__ == "__main__":
    sys.exit(main())
