"""slate-lint of the port (``slate_tpu_torch.analysis``) against the JAX
package's: the AST rules and their fixtures, the rules and the suppression
directive both packages share, the baseline workflow, the clean-port
meta-test, and the collective-schedule auditor — on the JAX package's
synthetic schedules and on the logs every spec of the scaling registry
records on a pool of 2 gloo ranks.
"""

import dataclasses
import json
import textwrap

import pytest
import torch

from slate_tpu_torch.analysis import (RULES, audit_log, extract_events,
                                      participant_schedules, rule_table,
                                      verify_events, verify_participant_schedules)
from slate_tpu_torch.analysis import baseline as baseline_mod
from slate_tpu_torch.analysis import collective_audit
from slate_tpu_torch.analysis.__main__ import main
from slate_tpu_torch.analysis.findings import Finding
from slate_tpu_torch.analysis.lint import lint_package, lint_source
from slate_tpu_torch.obs import scaling

P = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def pool():
    from slate_tpu_torch.parallel.launch import RankPool

    with RankPool(P, timeout=240) as p:
        yield p


@pytest.fixture(scope="module")
def recorded(pool):
    """Every spec once on both ranks: ``{routine: [rank 0 log, rank 1 log]}``
    (skipped specs have no log)."""
    per_rank = scaling.rank_passes(P, device="cpu", pool=pool)
    out = {}
    for k, entry in enumerate(per_rank[0]):
        out[entry["row"]["routine"]] = [ranks[k]["log"] for ranks in per_rank]
    return out


@pytest.fixture(scope="module")
def jax_analysis():
    import slate_tpu.analysis as ja

    return ja


# ---------------------------------------------------------------------------
# Tier A: golden fixtures — (rule, relpath, snippet, expected line)

FIXTURES = {
    "SLT101": ("slate_tpu_torch/linalg/lu.py", """\
        def gesv_core(a, b):
            if b.sum() > 0:
                return a
            return b
        """, 2),
    "SLT102": ("slate_tpu_torch/linalg/chol.py", """\
        def posv_core(a, b):
            return float(a), b
        """, 2),
    "SLT103": ("slate_tpu_torch/linalg/qr.py", """\
        import numpy as np

        def gels_core(a, b):
            return np.linalg.lstsq(a, b)
        """, 4),
    "SLT201": ("snippet.py", """\
        import torch

        def run_all(fns, x):
            out = []
            for fn in fns:
                out.append(torch.compile(fn)(x))
            return out
        """, 6),
    "SLT202": ("snippet.py", """\
        import functools

        @functools.lru_cache(maxsize=8)
        def plan(n, opts={}):
            return n
        """, 4),
    "SLT203": ("slate_tpu_torch/serve/snippet.py", """\
        def key_for(routine, shape, opts):
            return (routine, shape, Options.make(opts))
        """, 2),
    "SLT301": ("snippet.py", """\
        import torch

        def setup():
            torch.backends.cuda.matmul.allow_tf32 = True
        """, 4),
    "SLT302": ("snippet.py", """\
        import torch

        def f(x):
            torch.cuda.set_sync_debug_mode("warn")
            return x
        """, 4),
    "SLT401": ("snippet.py", """\
        import torch

        def f(a, b):
            return torch.mm(a, b, out=a)
        """, 4),
    "SLT501": ("snippet.py", """\
        def f():
            try:
                return work()
            except Exception:
                return None
        """, 4),
    "SLT601": ("slate_tpu_torch/parallel/snippet.py", """\
        def gesv_snippet_distributed(a, b, grid):
            return a
        """, 1),
}


@pytest.mark.parametrize("rule_id", sorted(FIXTURES))
def test_rule_fires_exactly_once(rule_id):
    relpath, snippet, line = FIXTURES[rule_id]
    findings = lint_source(textwrap.dedent(snippet), relpath=relpath)
    hits = [f for f in findings if f.rule == rule_id]
    assert len(hits) == 1, f"{rule_id} fired {len(hits)}x: {findings}"
    assert hits[0].line == line
    assert hits[0].severity == RULES[rule_id].severity


def test_rule_ids_and_severities_are_the_jax_packages(jax_analysis):
    assert set(FIXTURES) == set(RULES)
    assert [(r, s) for r, s, _ in rule_table()] == \
        [(r, s) for r, s, _ in jax_analysis.rule_table()]


_QUIET = {
    "metadata branch in a core": ("slate_tpu_torch/linalg/lu.py", """\
        def gesv_core(a, b):
            if a.shape[-1] == 0 or a.is_complex() or b is None:
                return a
            return b
        """),
    "a non-core of the same name": ("slate_tpu_torch/linalg/svd.py", """\
        def gesv_core(a, b):
            return float(a)
        """),
    "host params of start_batched": ("slate_tpu_torch/serve/batched.py", """\
        def start_batched(routine, A, B, opts=None, cache=None, donate=False,
                          n_real=None, device=None):
            if donate and n_real is not None and int(n_real) > 0:
                return A
            return B
        """),
    "re.compile in a loop": ("snippet.py", """\
        import re

        def pats(words):
            return [re.compile(w) for w in words] + [re.compile(w) for w in words]
        """),
    "a tuple default on a cached function": ("snippet.py", """\
        import functools

        @functools.lru_cache(maxsize=8)
        def plan(n, opts=()):
            return n
        """),
    "highest precision and tf32 off": ("snippet.py", """\
        import torch

        def setup():
            torch.set_float32_matmul_precision("highest")
            torch.backends.cuda.matmul.allow_tf32 = False
        """),
    "precision in the tester entrypoint": ("slate_tpu_torch/testing/__main__.py", """\
        import torch

        torch.set_default_dtype(torch.float64)
        """),
    "out= to a fresh tensor": ("snippet.py", """\
        import torch

        def f(a, b, c):
            return torch.mm(a, b, out=c)
        """),
}


@pytest.mark.parametrize("case", sorted(_QUIET))
def test_rule_subjects_do_not_fire_where_nothing_syncs_or_leaks(case):
    relpath, snippet = _QUIET[case]
    assert lint_source(textwrap.dedent(snippet), relpath=relpath) == []


_SHARED = {
    "broad except": ("", FIXTURES["SLT501"][1]),
    "broad except that re-raises": ("", """\
        def f():
            try:
                return work()
            except Exception:
                cleanup()
                raise
        """),
    "suppression above": ("", """\
        def f():
            try:
                return work()
            # slate-lint: disable=SLT501 -- fixture: intentional swallow
            except Exception:
                return None
        """),
    "suppression trailing": ("", """\
        def f():
            try:
                return work()
            except (ValueError, Exception):  # slate-lint: disable=SLT501 -- ok
                return None
        """),
    "directive inside a string": ("", """\
        def f():
            s = "# slate-lint: disable=SLT501 -- nope"
            try:
                return work()
            except BaseException:
                return s
        """),
    "Options key": ("serve/snippet.py", FIXTURES["SLT203"][1]),
    "Options cache_key": ("serve/snippet.py", """\
        def key_for(routine, shape, opts):
            return (routine, shape, Options.make(opts).cache_key())
        """),
    "driver without instrument": ("parallel/snippet.py", FIXTURES["SLT601"][1]),
    "drivers with instrument or private": ("parallel/snippet.py", """\
        from ..obs import instrument

        @instrument
        def potrf_snippet_distributed(a, grid):
            return a

        def _helper_pipelined(a):
            return a

        def scan_sharded(a):
            return a
        """),
}


def _fields(findings):
    return [(f.rule, f.severity, f.line, f.col, f.message, f.context, f.line_text,
             f.suggestion) for f in findings]


@pytest.mark.parametrize("case", sorted(_SHARED))
def test_shared_rules_match_the_jax_linter(jax_analysis, case):
    """SLT203, SLT501, SLT601 and the directive carry over as they are: the
    same snippet gives the same findings (each package's own path prefix)."""
    from slate_tpu.analysis.lint import lint_source as jlint

    sub, snippet = _SHARED[case]
    text = textwrap.dedent(snippet)
    rules = ["SLT203", "SLT501", "SLT601"]
    port = lint_source(text, relpath=f"slate_tpu_torch/{sub or 'snippet.py'}",
                       rules=rules)
    ref = jlint(text, relpath=f"slate_tpu/{sub or 'snippet.py'}", rules=rules)
    assert _fields(port) == _fields(ref)


def test_syntax_error_is_a_finding():
    (f,) = lint_source("def f(:\n", relpath="snippet.py")
    assert f.rule == "SLT000" and f.severity == "error"


# ---------------------------------------------------------------------------
# baseline workflow


def _findings(cls):
    rows = [("SLT501", "error", "a/x.py", 4, 4, "m", "f", "except Exception:", ""),
            ("SLT501", "error", "a/x.py", 9, 4, "m", "f", "except Exception:", ""),
            ("SLT601", "warning", "a/y.py", 1, 0, "m", "<module>", "def g(): pass", ""),
            ("SLT302", "warning", "a/z.py", 3, 0, "m", "h", "breakpoint()", "")]
    return [cls(*r) for r in rows]


def test_baseline_matches_the_jax_package():
    from slate_tpu.analysis import baseline as jbase
    from slate_tpu.analysis.findings import Finding as JFinding

    mine, ref = _findings(Finding), _findings(JFinding)
    assert [f.fingerprint() for f in mine] == [f.fingerprint() for f in ref]
    doc, jdoc = baseline_mod.build(mine), jbase.build(ref)
    assert doc["entries"] == jdoc["entries"]
    assert doc["schema"] == baseline_mod.SCHEMA != jdoc["schema"]
    assert baseline_mod.validate(doc) == jbase.validate(jdoc) != []
    for e, je in zip(doc["entries"], jdoc["entries"]):
        e["reason"] = je["reason"] = "fixture: accepted for the parity test"
    for d in (doc, jdoc):                       # absorb one of the two SLT501s
        (twice,) = [e for e in d["entries"] if e.get("count") == 2]
        twice["count"] = 1
    doc["entries"].append({"rule": "SLT501", "path": "gone.py", "context": "c",
                           "line_text": "t", "reason": "stale entry, reason ok"})
    jdoc["entries"].append(dict(doc["entries"][-1]))
    new, acc, stale = baseline_mod.apply(mine, doc)
    jnew, jacc, jstale = jbase.apply(ref, jdoc)
    assert (_fields(new), _fields(acc), stale) == (_fields(jnew), _fields(jacc), jstale)
    assert len(new) == 1 and len(stale) == 1
    rebuilt, jrebuilt = baseline_mod.build(mine, prev=doc), jbase.build(ref, prev=jdoc)
    assert rebuilt["entries"] == jrebuilt["entries"]
    bad = {"entries": [{"rule": "SLT501", "path": "", "context": "c", "line_text": "t",
                        "reason": "TODO", "count": 0}]}
    assert baseline_mod.validate(bad) == jbase.validate(bad) and len(baseline_mod.validate(bad)) == 3


def test_port_lints_clean_against_its_baseline():
    doc = baseline_mod.load()
    assert doc["schema"] == baseline_mod.SCHEMA
    assert baseline_mod.validate(doc) == []
    new, accepted, stale = baseline_mod.apply(lint_package(), doc)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [], f"stale baseline entries: {stale}"
    assert accepted and all(f.path.startswith("slate_tpu_torch/") for f in accepted)


def test_cli_modes(tmp_path, capsys):
    assert main(["--check"]) == 0
    assert "0 new" in capsys.readouterr().out
    assert main(["--rules"]) == 0
    out = capsys.readouterr().out
    assert all(rid in out for rid in RULES)
    with pytest.raises(SystemExit) as e:
        main(["--check", "--update-baseline"])
    assert e.value.code == 2
    path = str(tmp_path / "baseline.json")
    assert main(["--update-baseline", "--baseline", path]) == 0
    with open(path) as f:
        assert json.load(f)["entries"]           # reasons stamped TODO
    assert main(["--check", "--baseline", path]) == 1     # ... which the gate refuses
    assert main(["--collectives", "--routines", "no_such_routine", "--pset", "2"]) == 2


def test_cli_collectives_run_on_the_card_unless_asked(monkeypatch, capsys):
    """``--collectives`` hands ``--device`` to the auditor, cuda unless asked:
    P = 2 on the card without a launcher's ranks is refused (no pool
    starts); ``--device cpu`` asks for the pool of gloo ranks."""
    import slate_tpu_torch.analysis.collective_audit as ca

    if not torch.cuda.is_available():
        assert main(["--collectives", "--pset", "2", "--routines",
                     "norm_distributed"]) == 2
        assert "device='cpu'" in capsys.readouterr().out
    asked = []

    def fake(pset, names=None, progress=None, device=None, pool=None):
        asked.append(device)
        return []

    monkeypatch.setattr(ca, "audit_routines", fake)
    assert main(["--collectives", "--pset", "2"]) == 0
    assert main(["--collectives", "--pset", "2", "--device", "cpu"]) == 0
    assert asked == [None, "cpu"]


# ---------------------------------------------------------------------------
# Tier B on the JAX package's synthetic schedules


def _port_events(jevents):
    return [collective_audit.CollectiveEvent(**dataclasses.asdict(e)) for e in jevents]


def _hlo(name):
    import test_analysis

    return getattr(test_analysis, name)


def _cases(jax_analysis):
    """(JAX schedules by participant, nproc) of each corruption scenario."""
    je = jax_analysis.extract_events
    sched = jax_analysis.participant_schedules(je(_hlo("_HLO_CLEAN")), 2)
    fwd = je(_hlo("_HLO_PERMUTE"), nproc=2)
    rev = je(_hlo("_HLO_PERMUTE").replace("{{0,1}}", "{{1,0}}"), nproc=2)
    while_ = jax_analysis.participant_schedules(je(_hlo("_HLO_WHILE")), 2)
    return {
        "clean": (sched, 2),
        "dropped_psum": ({0: sched[0], 1: [e for e in sched[1] if e.op != "all-reduce"]}, 2),
        "dropped_on_0": ({0: sched[0][:1], 1: sched[1]}, 2),
        "reordered": ({0: sched[0], 1: list(reversed(sched[1]))}, 2),
        "permute_direction": ({0: fwd, 1: rev}, 2),
        "permute_agree": ({0: fwd, 1: list(fwd)}, 2),
        "while_clean": (while_, 2),
        "third_rank_idle": ({0: sched[0], 1: sched[1], 2: []}, 3),
    }


@pytest.mark.parametrize("case", ["clean", "dropped_psum", "dropped_on_0", "reordered",
                                  "permute_direction", "permute_agree", "while_clean",
                                  "third_rank_idle"])
def test_schedules_match_the_jax_auditor(jax_analysis, case):
    jsched, nproc = _cases(jax_analysis)[case]
    sched = {d: _port_events(evs) for d, evs in jsched.items()}
    want = jax_analysis.verify_participant_schedules(jsched, nproc)
    assert verify_participant_schedules(sched, nproc) == want
    assert bool(want) == (case not in ("clean", "permute_agree", "while_clean",
                                       "third_rank_idle"))


@pytest.mark.parametrize("name", ["_HLO_CLEAN", "_HLO_COND", "_HLO_CHAN_REUSE",
                                  "_HLO_COND_UNIFORM", "_HLO_WHILE",
                                  "_HLO_WHILE_DIVERGENT", "_HLO_PERMUTE"])
def test_projection_and_structure_match_the_jax_auditor(jax_analysis, name):
    jevents = jax_analysis.extract_events(_hlo(name), nproc=2)
    events = _port_events(jevents)
    for nproc in (1, 2):
        assert verify_events(events, nproc) == jax_analysis.verify_events(jevents, nproc)
    mine = participant_schedules(events, 2)
    ref = jax_analysis.participant_schedules(jevents, 2)
    assert {d: [e.key() for e in evs] for d, evs in mine.items()} == \
        {d: [e.key() for e in evs] for d, evs in ref.items()}
    assert [e.describe() for e in events] == [e.describe() for e in jevents]


# ---------------------------------------------------------------------------
# Tier B on recorded logs (P = 2, one pool)


def test_recorded_logs_of_every_spec_verify_clean(recorded):
    assert list(recorded) == scaling.spec_names()
    audited = 0
    for name, logs in recorded.items():
        if logs[0] is None:
            assert name == "gemm_ring"                 # square grids only
            continue
        out = audit_log(logs, P)
        assert out["findings"] == [], (name, out["findings"][:3])
        audited += 1
        for log in logs:
            events = extract_events(log)
            assert all(e.channel_id is None and e.branch_path == () and
                       e.while_depth == 0 for e in events)
    assert audited == 30


def _joint(log, i):
    return log[i].groups == ((0, 1),)


def _key(rec):
    return rec.op, rec.groups, rec.pairs


@pytest.mark.parametrize("routine", ["potrf_distributed", "ge2tb_distributed"])
def test_a_dropped_all_reduce_is_reported_and_named(recorded, routine):
    """Rank 1 skips one of its joint all-reduces (one whose next joint
    collective is another rendezvous, so the divergence is right there): the
    audit names the all-reduce, the function that issued it and the rank
    that would block."""
    logs = recorded[routine]
    log = logs[1]
    joint = [i for i in range(len(log)) if _joint(log, i)]
    k = next(a for a, b in zip(joint, joint[1:] + [None])
             if log[a].op == "all-reduce" and (b is None or _key(log[b]) != _key(log[a])))
    dropped = [logs[0], log[:k] + log[k + 1:]]
    findings = audit_log(dropped, P)["findings"]
    assert len(findings) == 1
    assert "all-reduce" in findings[0] and log[k].site in findings[0]
    assert ("participant 1 is missing" in findings[0]
            or "disagree" in findings[0])
    assert audit_log(logs, P)["findings"] == []     # the recorded logs themselves


def test_two_swapped_events_are_reported(recorded):
    logs = recorded["ge2tb_distributed"]
    log = list(logs[1])
    joint = [i for i in range(len(log)) if _joint(log, i)]
    i, j = next((a, b) for a in joint for b in joint
                if a < b and _key(log[a]) != _key(log[b]))
    log[i], log[j] = log[j], log[i]
    findings = audit_log([logs[0], log], P)["findings"]
    assert len(findings) == 1 and "disagree" in findings[0]
    assert log[j].op in findings[0] and log[i].op in findings[0]


def test_point_to_point_logs_carry_every_members_pairs(recorded):
    """A chase's neighbour exchange logs the same pairs on both ranks, so the
    pairwise check compares like with like."""
    logs = recorded["hb2st_chase_distributed"]
    permutes = [[r for r in log if r.op == "collective-permute"] for log in logs]
    assert permutes[0] and len(permutes[0]) == len(permutes[1])
    assert {r.pairs for r in permutes[0]} == {((0, 1), (1, 0))}
    assert all(r.wire == "p2p" for r in permutes[0])


def test_audit_routines_runs_the_registry_on_the_pool(pool):
    from slate_tpu_torch.analysis import audit_routines

    rows = audit_routines(pset=(P,), names=("gemm_allgather", "gemm_ring",
                                            "getrf_distributed"),
                          device="cpu", pool=pool)
    assert [r["routine"] for r in rows] == ["gemm_allgather", "gemm_ring",
                                            "getrf_distributed"]
    assert rows[1]["skipped"]
    for r in (rows[0], rows[2]):
        assert r["findings"] == [] and r["collective_sites"] > 0 and r["P"] == P
    audited, nfind, lines = collective_audit.summarize(rows)
    assert (audited, nfind, lines) == (2, 0, [])
    with pytest.raises(ValueError):
        audit_routines(pset=(P,), names=("nope",), device="cpu", pool=pool)


def test_chip_phase_15_rehearsal():
    """Phase 15 of ``chip_smoke.py`` on the CPU at a small size, in a process
    of its own (its 1x1 grid starts a world of one gloo rank): the registry
    counted once, every log of that pass audited, the lint gate, and the
    three full-width specs with their flop ratios within the phase's
    tolerance of this size's ratios (the counts depend on n and nb only) and
    their LAPACK ops counted."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""\
        import json, torch
        torch.set_num_threads(1)
        import chip_smoke as cs
        sizes = {**cs.AUDIT, "n": 256, "nb": 32, "flop_ratio": {
            "gemm_allgather": 1.000, "potrf_distributed": 1.191,
            "getrf_distributed": 1.425}}
        res = cs.audit_path("cpu", sizes)
        cs.check_audit_path(res, sizes)
        print(json.dumps({k: v["flops_over_model"] for k, v in res["full"].items()}))
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ratios = json.loads(out.stdout.strip().splitlines()[-1])
    assert ratios["gemm_allgather"] == 1.0
    assert 1.0 < ratios["potrf_distributed"] < ratios["getrf_distributed"] < 1.8


def test_a_launched_world_runs_the_pass_in_place(pool, recorded):
    """Under a launcher whose world has P ranks, each rank runs the specs in
    place and every rank gets all ranks' entries (``all_gather_object``): the
    same logs the pool's pass recorded."""
    import torch_audit_jobs

    names = ("gemm_allgather", "norm_distributed")
    got = pool.run(torch_audit_jobs.launched_pass, names)
    assert got[0] == got[1] and len(got[0]) == P
    for rank in range(P):
        assert [e["row"]["routine"] for e in got[0][rank]] == list(names)
        assert [e["log"] for e in got[0][rank]] == [recorded[n][rank] for n in names]
