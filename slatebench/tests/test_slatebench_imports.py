"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Top-level module names are compared
whole: ``slate_tpu_torch`` begins with ``slate_tpu`` and is not it."""

import ast
import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT, SEED

FORBIDDEN = {"jax", "jaxlib", "flax", "slate_tpu"}
HARNESS = os.path.join(ROOT, "slatebench")


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    for path in _py_files(HARNESS):
        bad = set(_imported(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(HARNESS, "reference")):
        assert "slate_tpu_torch" not in set(_imported(path)), path
    code = ("import sys; sys.path.insert(0, %r); "
            "import slatebench.reference.dense, slatebench.gen, slatebench.flops; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "slate_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from slatebench import run as bench

    monkeypatch.setitem(sys.modules, "slate_tpu_torch_lookalike", sys)
    assert "slate_tpu_torch" not in bench.FORBIDDEN
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert bench.forbidden_modules() == ["jaxlib.xla_client"]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_of_every_cell_loads_no_jax(tiny_root, bench, trace):
    """Every cell, run on the CPU at a tiny size in a fresh interpreter,
    leaves no forbidden module in ``sys.modules``."""
    names = [w["name"] for w in bench["workloads"]]
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import slatebench.run as b\n"
        "for w in %r:\n"
        "    run, res = b.execute(w, %d, 0.3, %r, device='cpu', root=%r)\n"
        "    assert res['correct'], (w, res)\n"
        "print(json.dumps(b.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (ROOT, names, SEED, bool(trace), tiny_root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    assert "slate_tpu_torch" in json.loads(lines[-1])
