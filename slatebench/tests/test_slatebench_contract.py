"""BENCHMARK.json keeps to the form the benchmark's contract sets, and every
configuration file holds what its entry says."""

import json
import os
import re

import pytest

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


@pytest.fixture
def table():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def test_top_level_keys_paths_and_command(table):
    assert set(table) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(table["paths"]) <= 16
    for p in table["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(table["command"]) <= 32
    assert all(_line(w) for w in table["command"])
    assert table["command"][1].startswith(table["paths"][0] + "/")
    assert isinstance(table["run_seconds"], int)
    assert 1 <= table["run_seconds"] <= 51


def test_configs_and_cells(table):
    names = [c["name"] for c in table["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in table["workloads"]}
    for c in table["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith(table["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size"))
    cells = [w["name"] for w in table["workloads"]]
    assert 1 <= len(cells) <= 24 and len(set(cells)) == len(cells)
    pairs = [(w["config"], w["traffic"]) for w in table["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in table["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(ROOT, "slatebench", "traffic",
                                           w["traffic"] + ".json"))
    assert sum(w["chips"] == 4 for w in table["workloads"]) <= \
        max(1, len(cells) // 4)


def test_metrics(table):
    cells = {w["name"] for w in table["workloads"]}
    e2e = {m["name"]: m for m in table["end_to_end"]}
    pl = table["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in pl]
    assert len(set(names)) == len(names)
    for m in table["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in table["end_to_end"] + pl:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    reports = {c: {n for n, m in e2e.items() if c in m.get("workloads", cells)}
               for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert any(c in m.get("workloads", cells) for m in pl)
    for m in pl:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert m["moves"] in reports[c]


def test_the_check_budget_fits_the_full_benchmark(table):
    rs = table["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
