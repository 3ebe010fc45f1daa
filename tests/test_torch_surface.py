"""The port's public surface against the JAX package's (imports only).

Every module of ``slate_tpu`` has a counterpart of the same dotted name in
``slate_tpu_torch``, or is listed below as owed (ROADMAP.md queue A, by item)
or replaced.  In every counterpart, each public name of the JAX module exists,
unless it is listed.  A listed name or module that the port has since gained
fails too, so the lists shrink as the port grows.

Public names: a module's ``__all__`` where it has one; else the names its
source binds at top level — functions, classes and assignments, and for a
package what it imports from its own modules — that do not start with an
underscore and are not modules (names a plain module imports are not its
surface)."""

import ast
import importlib
import importlib.util
import pkgutil
import types

import pytest

import slate_tpu
import slate_tpu_torch

# dotted paths relative to the package; "mod:name" is a name in a module
# ("" the top level); a module path covers its submodules
OWED = {}
REPLACED = {
    "ops.pallas_norms": "the Pallas kernels; the CUDA kernels are ops/cuda_norms.py",
    "ops.norms:USE_PALLAS": "the CUDA kernels run on every CUDA tensor, no switch",
    "testing.driver:x64_scope": "torch has float64 on every device, no scope",
    "parallel.mesh:shard_map": "the jax.shard_map version adapter; the port runs "
                               "one process per rank",
    "obs.costaudit:Instr": "a parsed HLO instruction; the port audits run-time "
                           "collective logs, it compiles no HLO",
    "obs.costaudit:parse_computations": "splits compiled HLO text; the port has "
                                        "no compiled HLO",
    "obs.costaudit:module_num_partitions": "reads the HLO module header; a "
                                           "run's rank count is its grid's",
    "analysis.collective_audit:audit_hlo": "audits HLO text; audit_log takes its "
                                           "place over the ranks' run-time logs",
    "analysis.collective_audit:audit_compiled": "audits a jax Compiled; the port "
                                                "runs each routine (audit_log)",
    "analysis:audit_hlo": "re-export of collective_audit.audit_hlo (audit_log)",
    "analysis:audit_compiled": "re-export of collective_audit.audit_compiled "
                               "(audit_log)",
}


def _listed():
    out = {e for entries in OWED.values() for e in entries}
    return out | set(REPLACED)


def _covered(path: str, listed: set) -> bool:
    return any(path == e or path.startswith(e + ".") for e in listed if ":" not in e)


def _exists(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:
        return False


def _bound(body, package: bool) -> set:
    """Names a module body binds at top level (inside if/try blocks too):
    defs, classes and assignments, and for a package its relative imports."""
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and package and node.level >= 1:
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.If, ast.Try)):
            for block in [node.body, node.orelse, getattr(node, "finalbody", [])] + [
                    h.body for h in getattr(node, "handlers", [])]:
                out |= _bound(block, package)
    return out


def _public(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    with open(mod.__file__) as f:
        names = _bound(ast.parse(f.read()).body, hasattr(mod, "__path__"))
    return {n for n in names if not n.startswith("_")
            and not isinstance(getattr(mod, n, None), types.ModuleType)}


def _jax_modules():
    return [""] + [m.name[len("slate_tpu."):] for m in
                   pkgutil.walk_packages(slate_tpu.__path__, "slate_tpu.")]


def surface_gaps(port=slate_tpu_torch) -> list:
    """Every JAX module or public name neither in the port nor listed."""
    listed, gaps = _listed(), []
    for rel in _jax_modules():
        if _covered(rel, listed):
            continue
        jname = "slate_tpu" + ("." + rel if rel else "")
        tname = port.__name__ + ("." + rel if rel else "")
        if not _exists(tname):
            gaps.append(f"module {rel}")
            continue
        jmod, tmod = importlib.import_module(jname), importlib.import_module(tname)
        for n in sorted(_public(jmod)):
            if f"{rel}:{n}" not in listed and not hasattr(tmod, n):
                gaps.append(f"{rel}:{n}")
    return gaps


def test_every_jax_name_is_ported_or_listed():
    assert surface_gaps() == []


def test_listed_entries_are_not_ported_yet():
    stale = []
    for entry in sorted(_listed()):
        rel, _, name = entry.partition(":")
        tname = "slate_tpu_torch" + ("." + rel if rel else "")
        if not name:
            if _exists(tname):
                stale.append(entry)
        elif hasattr(importlib.import_module(tname), name):
            stale.append(entry)
    assert stale == [], f"ported but still listed: {stale}"


def test_listed_entries_exist_in_the_jax_package():
    for entry in sorted(_listed()):
        rel, _, name = entry.partition(":")
        jname = "slate_tpu" + ("." + rel if rel else "")
        assert _exists(jname), entry
        if name:
            assert hasattr(importlib.import_module(jname), name), entry


@pytest.mark.parametrize("target", [("slate_tpu_torch.utils.trace", "phase_report"),
                                    ("slate_tpu_torch", "version"),
                                    ("slate_tpu_torch", "VERSION"),
                                    ("slate_tpu_torch", "id")])
def test_a_deleted_name_is_a_gap(monkeypatch, target):
    module, name = target
    monkeypatch.delattr(importlib.import_module(module), name)
    rel = module[len("slate_tpu_torch."):] if "." in module else ""
    assert f"{rel}:{name}" in surface_gaps()


def test_version_and_id_match_the_jax_package():
    assert slate_tpu_torch.VERSION == slate_tpu.VERSION == slate_tpu_torch.version()
    ident = slate_tpu_torch.id()
    assert isinstance(ident, str) and ident


def test_id_is_unknown_where_git_does_not_track_the_package(monkeypatch, tmp_path):
    monkeypatch.setattr(slate_tpu_torch, "__path__", [str(tmp_path)])
    assert slate_tpu_torch.id() == "unknown"


@pytest.mark.parametrize("min_frac", [0.0, 0.1, 0.5])
def test_phase_report_matches_jax(min_frac):
    from slate_tpu.utils.trace import phase_report as jreport
    from slate_tpu_torch.utils.trace import Timers, phase_report

    phases = {"he2hb": 1.25, "hb2st": 3.5, "sterf": 0.75, "back": 0.0625,
              "tiny": 0.001}
    timers = Timers()
    timers.update(phases)
    assert phase_report(phases, min_frac) == jreport(phases, min_frac)
    assert phase_report(timers, min_frac) == jreport(phases, min_frac)
    assert list(phase_report(phases, min_frac))[:2] == ["total_s", "hb2st"]
    assert phase_report({}, min_frac) == jreport({}, min_frac) == {"total_s": 0.0}
