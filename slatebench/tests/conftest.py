"""Fixtures of the harness's tests: a tiny tree of the benchmark (the real
cells at sizes the CPU holds) and the card, where there is one."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a large seed, past 32 signed bits, as the driver's are
SEED = 2 ** 31 + 4321


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on the CPU")


def shrink(bench):
    """The tiny tree's files: every configuration and traffic file of
    ``bench`` at a size the CPU runs in a second."""
    configs, traffic = {}, {}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        if "N" in cfg:
            cfg["N"] = 192
        configs[c["file"]] = cfg
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "slatebench", "traffic",
                               w["traffic"] + ".json")) as f:
            t = json.load(f)
        if "dims" in t:
            t.update(dims=t["dims"][:2], rate_per_s=150, check_sample=24)
            if t.get("pool"):
                t["pool"] = 48
        traffic[w["traffic"]] = t
    return configs, traffic


def write_tree(root, bench, configs, traffic):
    os.makedirs(os.path.join(root, "slatebench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "slatebench", "traffic"), exist_ok=True)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for path, cfg in configs.items():
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
    for name, t in traffic.items():
        with open(os.path.join(root, "slatebench", "traffic",
                               name + ".json"), "w") as f:
            json.dump(t, f)


@pytest.fixture
def bench():
    """``BENCHMARK.json`` with the staged cells, so that every entry the
    harness has is driven."""
    from slatebench.cells import load_benchmark

    return load_benchmark(ROOT, staged=True)


@pytest.fixture
def tiny_root(tmp_path, bench):
    """A tree with the real BENCHMARK.json and tiny configuration and
    traffic files; the harness's code is found in the real folder."""
    configs, traffic = shrink(bench)
    write_tree(str(tmp_path), bench, configs, traffic)
    return str(tmp_path)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the card tests run on the chip")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _flight_path(tmp_path, monkeypatch):
    monkeypatch.setenv("SLATE_TPU_FLIGHT_PATH",
                       str(tmp_path / "flight_records.json"))


def cells_of(bench, entry):
    files = {c["name"]: c["file"] for c in bench["configs"]}
    out = []
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, files[w["config"]])) as f:
            if json.load(f)["entry"] == entry:
                out.append(w["name"])
    return out


def harness_copy(dst):
    shutil.copytree(os.path.join(ROOT, "slatebench"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
