"""The result line: its keys, their shapes, the checks last; and no result
at all without a card."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT, SEED


@pytest.mark.parametrize("trace", [False, True])
def test_every_cell_gives_a_result_of_the_contract_shape(tiny_root, bench,
                                                         trace):
    from slatebench import run as runner

    for w in bench["workloads"]:
        run, res = runner.execute(w["name"], SEED, 0.3, trace, device="cpu",
                                  root=tiny_root)
        assert list(res)[-1] == "checks"
        for key in ("correct", "attempted", "failed", "metrics", "device"):
            assert key in res
        assert res["correct"] is True
        assert res["failed"] == 0 and res["attempted"] >= 1
        assert set(res["device"]) >= {"platform", "kind", "count",
                                      "memory_peak_bytes"}
        assert res["device"]["count"] == w["chips"]
        names = {m["name"]: m for m in (bench["per_layer"] if trace
                                        else bench["end_to_end"])
                 if w["name"] in m.get("workloads", [w["name"]])}
        # a CPU run reads no device metric: those are left out, never 0
        for name, m in res["metrics"].items():
            assert name in names
            assert m["unit"] == names[name]["unit"]
            assert isinstance(m["value"], float)
            assert names[name]["source"] != "device_trace"
        if not trace:
            assert "setup_s" in res["metrics"]
            assert len(res["metrics"]) == len(names)
        for c in res["checks"].values():
            assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
        json.dumps(res)


def test_without_a_card_the_command_prints_no_result_and_fails(bench):
    w = bench["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "slatebench/run.py", "--workload", w,
                          "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_in_a_tree_without_the_program_the_command_fails(tmp_path, bench):
    """A directory with only BENCHMARK.json and the harness: no result."""
    from .conftest import harness_copy

    harness_copy(str(tmp_path / "slatebench"))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    out = subprocess.run([sys.executable, "slatebench/run.py", "--workload",
                          bench["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
