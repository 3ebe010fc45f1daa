"""Where a cell's parts live, found by the names in ``BENCHMARK.json``.

Nothing here names a cell, a configuration, a traffic mix or a metric: each
is a file of its own, and adding one takes new files and entries only.

* a configuration: the ``file`` of its entry in ``configs`` (JSON); its
  ``entry`` key names the module under ``entries/`` that drives it;
* a traffic mix: ``traffic/<traffic>.json``, parameters read by
  :mod:`slatebench.gen`;
* a metric: ``metrics/<name>.py``, or ``metrics/<stem>.py`` for a name
  ``<stem>.<suffix>``; its ``read(run, spec)`` returns the number, or None
  when it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT, staged: bool = False) -> Dict[str, Any]:
    """``BENCHMARK.json``; with ``staged``, also the cells of
    ``staged_cells.json`` (built and measured, not yet in the benchmark)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if staged:
        with open(os.path.join(HERE, "staged_cells.json")) as f:
            extra = json.load(f)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + extra[key]
    return bench


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _find(dirs: List[str], sub: str, stems: List[str], ext: str) -> str:
    for d in dirs:
        for stem in stems:
            path = os.path.join(d, sub, stem + ext)
            if os.path.exists(path):
                return path
    raise FileNotFoundError(f"no {sub}/{stems[0]}{ext} under {dirs}")


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    entry module and metric specs."""

    def __init__(self, bench: Dict[str, Any], name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        #: where a cell's files are looked for: the checkout's harness folder,
        #: then this one (the same folder, unless a test points ``root``
        #: at a tree of its own)
        self.dirs = list(dict.fromkeys([os.path.join(root, "slatebench"),
                                        HERE]))
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _read_json(os.path.join(
            root, configs[self.workload["config"]]["file"]))
        self.traffic = _read_json(_find(self.dirs, "traffic",
                                        [self.workload["traffic"]], ".json"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: Dict[str, Any]) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def entry(self):
        name = self.config["entry"]
        return _module(_find(self.dirs, "entries", [name], ".py"),
                       f"slatebench_entry_{name}")

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        return self.per_layer if trace else self.end_to_end

    def reader(self, name: str):
        """The ``read`` function of metric ``name`` (see the module
        docstring)."""
        path = _find(self.dirs, "metrics", [name, name.split(".", 1)[0]], ".py")
        return _module(path, "slatebench_metric_" +
                       os.path.basename(path)[:-3].replace(".", "_")).read
