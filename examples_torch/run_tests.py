#!/usr/bin/env python
"""Run the port's examples, each in its own process, on one device:

    python examples_torch/run_tests.py --device cpu      # or cuda (default)
    python examples_torch/run_tests.py --device cpu ex04_norm ex14_scalapack_gemm
    python examples_torch/run_tests.py --device cuda --jobs 4   # four at a time

Prints one line per example and ``<passed>/<count> examples pass``; exits 1
when any example fails."""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def examples(names=()):
    found = sorted(f[:-3] for f in os.listdir(HERE) if f.startswith("ex") and f.endswith(".py"))
    missing = set(names) - set(found)
    if missing:
        raise SystemExit(f"no such example: {sorted(missing)}")
    return [f for f in found if not names or f in names]


def run(name: str, device: str, timeout: float, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, os.path.join(HERE, name + ".py"), "--device", device],
                          capture_output=True, text=True, env=env, timeout=timeout)


def main(argv=None) -> int:
    from concurrent.futures import ThreadPoolExecutor

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--jobs", type=int, default=1, help="examples run at once")
    ap.add_argument("names", nargs="*", help="examples to run (default: all)")
    args = ap.parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    chosen = examples(args.names)
    failures = []
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        procs = [pool.submit(run, ex, args.device, args.timeout, env) for ex in chosen]
        for ex, fut in zip(chosen, procs):
            proc = fut.result()
            ok = proc.returncode == 0 and f"{ex[:4]} OK" in proc.stdout.splitlines()
            print(f"{ex:42s} {'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                failures.append(ex)
                print(proc.stdout[-2000:])
                print(proc.stderr[-2000:])
    print(f"\n{len(chosen) - len(failures)}/{len(chosen)} examples pass")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
