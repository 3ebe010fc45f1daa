"""On the card: every cell's command runs for a short window, exits 0 and
prints a correct result as its last line (run on the chip with
``python3 -m pytest slatebench/tests -m card``)."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT, SEED


@pytest.mark.card
def test_every_cell_runs_correct_on_the_card(cuda_device):
    from slatebench.cells import load_benchmark

    for w in load_benchmark(ROOT)["workloads"]:
        out = subprocess.run([sys.executable, "slatebench/run.py",
                              "--workload", w["name"], "--seed", str(SEED),
                              "--seconds", "2", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=360)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] is True, res["checks"]
        assert res["device"]["platform"] == "gpu"
