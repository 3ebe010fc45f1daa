"""The port's examples (``examples_torch/``) on the CPU: one case per
example, each run as its own process with ``--device cpu`` and required to
exit 0 and print its ``exNN OK`` line.  The distributed ones start one pool
of gloo ranks each.  The examples start together, three at a time, when the
module's first case asks for them; each case waits for its own."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "examples_torch")
EXAMPLES = sorted(f[:-3] for f in os.listdir(HERE) if f.startswith("ex") and f.endswith(".py"))
# the rank-pool examples first: they take longest
DISTRIBUTED = ("ex14_scalapack_gemm", "ex16_distributed_band_indefinite",
               "ex17_f64_emulation_and_rbt", "ex18_distributed_chase")
TIMEOUT = 300


def run_example(name):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    return subprocess.run([sys.executable, os.path.join(HERE, name + ".py"), "--device", "cpu"],
                          capture_output=True, text=True, timeout=TIMEOUT, env=env)


@pytest.fixture(scope="module")
def runs():
    order = list(DISTRIBUTED) + [e for e in EXAMPLES if e not in DISTRIBUTED]
    with ThreadPoolExecutor(3) as ex:
        yield {name: ex.submit(run_example, name) for name in order}


def test_nineteen_examples():
    assert len(EXAMPLES) == 19 and set(DISTRIBUTED) <= set(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example(runs, name):
    proc = runs[name].result(timeout=2 * TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert f"{name[:4]} OK" in proc.stdout.splitlines()


def test_runner_reports_each_example():
    proc = subprocess.run([sys.executable, os.path.join(HERE, "run_tests.py"), "--device",
                           "cpu", "ex01_matrix", "ex15_set_matrix"], capture_output=True,
                          text=True, timeout=TIMEOUT, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "2/2 examples pass" in proc.stdout
    assert [line.split()[-1] for line in proc.stdout.splitlines()[:2]] == ["ok", "ok"]
