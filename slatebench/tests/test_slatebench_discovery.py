"""A configuration, a traffic mix and a per-layer metric added as new files
and entries are found by name, with no edit to a file the harness has."""

import hashlib
import json
import os

from .conftest import ROOT, SEED, shrink, write_tree


def _digest(top):
    h = hashlib.sha256()
    for d, dirs, files in sorted(os.walk(top)):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        for f in sorted(files):
            if f.endswith(".pyc"):
                continue
            h.update(os.path.relpath(os.path.join(d, f), top).encode())
            with open(os.path.join(d, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def test_new_files_and_entries_make_a_new_cell(tmp_path, bench):
    from slatebench import run as runner

    before = _digest(os.path.join(ROOT, "slatebench"))
    root = str(tmp_path)
    configs, traffic = shrink(bench)
    serve_cfg = next(c for c in bench["configs"]
                     if configs[c["file"]]["entry"] == "serve_queue")
    new_cfg = dict(configs[serve_cfg["file"]], name="serve_two_executors",
                   executors=2)
    configs["slatebench/configs/serve_two_executors.json"] = new_cfg
    traffic["tiny_gesv_only"] = {
        "kind": "open_loop", "routines": ["gesv"], "dims": [8, 20],
        "nrhs": [2], "operands": "host", "rate_per_s": 100,
        "check_sample": 16, "gap_limit": 1e-4}
    bench = json.loads(json.dumps(bench))
    bench["configs"].append(dict(serve_cfg, name="serve_two_executors",
                                 file="slatebench/configs/"
                                      "serve_two_executors.json"))
    bench["workloads"].append({"name": "serve_two_executors.tiny_gesv_only",
                               "config": "serve_two_executors",
                               "traffic": "tiny_gesv_only", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({
        "name": "requests_done.new", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "client", "moves": "setup_s",
        "workloads": ["serve_two_executors.tiny_gesv_only"]})
    write_tree(root, bench, configs, traffic)
    os.makedirs(os.path.join(root, "slatebench", "metrics"))
    with open(os.path.join(root, "slatebench", "metrics",
                           "requests_done.py"), "w") as f:
        f.write("def read(run, spec):\n    return len(run.latency_s)\n")

    _, res = runner.execute("serve_two_executors.tiny_gesv_only", SEED, 0.5,
                            True, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_done.new"]["value"] == 50.0
    assert res["attempted"] == 50
    _, res = runner.execute("serve_two_executors.tiny_gesv_only", SEED, 0.5,
                            False, device="cpu", root=root)
    assert set(res["metrics"]) == {"setup_s"}
    assert _digest(os.path.join(ROOT, "slatebench")) == before


def test_a_metric_whose_reader_finds_nothing_is_left_out(tiny_root, bench):
    from slatebench import run as runner

    name = bench["workloads"][0]["name"]
    _, res = runner.execute(name, SEED, 0.2, True, device="cpu",
                            root=tiny_root)
    sources = {m["name"]: m["source"] for m in bench["per_layer"]}
    assert all(sources[k] != "device_trace" for k in res["metrics"])
