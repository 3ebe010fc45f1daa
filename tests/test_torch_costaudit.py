"""The cost audit of the port (``slate_tpu_torch.obs.costaudit`` and
``obs.scaling``) against the JAX package's.

The registry, the pins gate and the collective bill are held against the JAX
functions on the same inputs.  The run-time rows all come from one pool of 2
gloo ranks: one pass over the 31 specs with ``CommDebugMode`` on as well, and
a second plain pass that must give the same rows.
"""

import os

import numpy as np
import pytest
import torch

import slate_tpu_torch
from slate_tpu_torch import obs
from slate_tpu_torch.obs import costaudit, scaling
from slate_tpu_torch.parallel.collectives import CollectiveRecord

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
def jax_scaling():
    from slate_tpu.obs import scaling as jscaling

    return jscaling


@pytest.fixture(scope="module")
def jax_loops(jax_scaling):
    """Whether each spec's JAX program at P = 2 holds a ``while`` loop (None
    for a skipped spec): the JAX pins count a loop's collectives once, so
    only the loop-free programs' pins are run-time counts.  Compiled in a
    thread while the rank pool runs."""
    import concurrent.futures
    import re

    def compile_all():
        grid = jax_scaling.make_grid(P)
        out = {}
        for spec in jax_scaling.specs():
            compiled, problem = jax_scaling.compile_spec(spec, grid)
            out[spec.name] = None if problem else \
                bool(re.search(r"\bwhile\(", compiled.as_text()))
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(compile_all)


@pytest.fixture(scope="module")
def passes(pool, jax_loops):
    """Two passes of every spec on every rank: the first under CommDebugMode
    too (``torch_audit_jobs``), the second plain (``scaling.rank_pass``)."""
    import torch_audit_jobs

    first = pool.run(torch_audit_jobs.audit_pass_under_comm_debug, P)
    second = pool.run(scaling.rank_pass, P, None, "cpu")
    return first, second


def _norm(lines):
    """The pins gates' lines with each package's regeneration command as one
    placeholder (the only text in which the two gates differ)."""
    return [line.replace("(run python -m slate_tpu_torch.obs.scaling --update-pins --device cpu)",
                         "(run <update-pins>)")
            .replace("(run tools/gen_scaling.py --update-pins)", "(run <update-pins>)")
            for line in lines]


# ---------------------------------------------------------------------------
# the registry and the pins gate


def test_registry_matches_the_jax_package(jax_scaling):
    jspecs = jax_scaling.specs()
    assert scaling.spec_names() == jax_scaling.spec_names()
    assert len(scaling.specs()) == 31
    assert [s.module for s in scaling.specs()] == [s.module for s in jspecs]
    assert [s.model_flops for s in scaling.specs()] == [s.model_flops for s in jspecs]
    assert [s.requires is None for s in scaling.specs()] == \
        [s.requires is None for s in jspecs]
    assert (scaling.AUDIT_N, scaling.AUDIT_NB, scaling.AUDIT_KD) == \
        (jax_scaling.AUDIT_N, jax_scaling.AUDIT_NB, jax_scaling.AUDIT_KD)
    assert obs.AUDIT_N == 128 and obs.AUDIT_NB == 32
    assert obs.COLLECTIVE_OPS == __import__("slate_tpu").obs.COLLECTIVE_OPS


def test_specs_cover_every_parallel_module():
    import slate_tpu_torch.parallel as par

    pkg_dir = os.path.dirname(par.__file__)
    modules = {f[:-3] for f in os.listdir(pkg_dir)
               if f.endswith(".py") and not f.startswith("_")}
    infra = {"mesh", "collectives", "distribute", "pivot", "launch"}
    covered = {s.module for s in scaling.specs()}
    assert not modules - infra - covered


_PINS = {"P": 2, "bytes_slack": 1.25, "count_slack": 2, "routines": {
    "ok": {"collective_bytes": 100, "collective_count": 4},
    "gone": {"collective_bytes": 100, "collective_count": 4},
    "broken": {"collective_bytes": 100, "collective_count": 4},
    "square": {"collective_bytes": 100, "collective_count": 4},
    "fat": {"collective_bytes": 100, "collective_count": 4},
    "chatty": {"collective_bytes": 100, "collective_count": 4}}}


def _row(name, p=2, **kw):
    return {"routine": name, "P": p, **kw}


_ROWS = {
    "within": [_row("ok", collective_bytes=125, collective_count=6)],
    "pinned_but_missing": [],
    "error": [_row("broken", error="RuntimeError: boom")],
    "skipped": [_row("square", skipped="grid constraint")],
    "over_slack_bytes": [_row("fat", collective_bytes=126, collective_count=4)],
    "over_slack_count": [_row("chatty", collective_bytes=100, collective_count=7)],
    "unpinned": [_row("new", collective_bytes=1, collective_count=1)],
    "unpinned_error": [_row("new_err", error="ValueError: bad")],
    "unpinned_skipped": [_row("new_skip", skipped="grid constraint")],
    "other_p": [_row("ok", p=4, collective_bytes=10 ** 9, collective_count=99)],
}


@pytest.mark.parametrize("case", sorted(_ROWS) + ["all"])
def test_check_pins_matches_the_jax_gate(jax_scaling, case):
    rows = [r for rs in _ROWS.values() for r in rs] if case == "all" else _ROWS[case]
    got = scaling.check_pins(rows, _PINS)
    assert _norm(got) == _norm(jax_scaling.check_pins(rows, _PINS))
    audited = {r["routine"] for r in rows if r["P"] == 2}
    missing = len(set(_PINS["routines"]) - audited)
    assert len(got) == _EXPECTED[case] + missing


# regressions besides the pinned-but-missing ones, per case
_EXPECTED = {"within": 0, "pinned_but_missing": 0, "error": 1, "skipped": 1,
             "over_slack_bytes": 1, "over_slack_count": 1, "unpinned": 1,
             "unpinned_error": 1, "unpinned_skipped": 0, "other_p": 0, "all": 6}


# ---------------------------------------------------------------------------
# the collective bill

_HLO = """
%ag = f32[64,64]{1,0} all-gather(f32[32,64]{1,0} %p0), replica_groups={{0,1}}, dimensions={0}
%ar = f32[16]{0} all-reduce(f32[16]{0} %y), replica_groups={{0,1}}, to_apply=%add
%ar2 = f64[3,3]{1,0} all-reduce(f64[3,3]{1,0} %y2), replica_groups={{0,1}}, to_apply=%add
%rs = f32[8,4]{1,0} reduce-scatter(f32[16,4]{1,0} %z), replica_groups={{0,1}}, dimensions={0}, to_apply=%add
%cp = f32[8]{0} collective-permute(f32[8]{0} %x), source_target_pairs={{0,1},{1,0}}
%a2a = f32[4,4]{1,0} all-to-all(f32[4,4]{1,0} %w), replica_groups={{0,1}}, dimensions={0}
%mm = f32[64,64]{1,0} dot(f32[64,64] %a, f32[64,64] %b)
"""


def _rec(op, shape, dtype="float32", pairs=None, wire="allreduce_"):
    size = {"float32": 4, "float64": 8}[dtype]
    return CollectiveRecord(op=op, groups=((0, 1),), pairs=pairs, dtype=dtype,
                            shape=shape, bytes=int(np.prod(shape)) * size,
                            wire=wire, site="test")


_LOG = [_rec("all-gather", (64, 64), wire="allgather_"), _rec("all-reduce", (16,)),
        _rec("all-reduce", (3, 3), "float64"), _rec("reduce-scatter", (8, 4)),
        _rec("collective-permute", (8,), pairs=((0, 1), (1, 0)), wire="p2p"),
        _rec("all-to-all", (4, 4), wire="p2p")]


def test_collective_volume_matches_the_jax_hlo_bill():
    from slate_tpu.obs.costaudit import collective_volume as jvolume

    assert costaudit.collective_volume(_LOG) == jvolume(_HLO)
    assert costaudit.collective_volume([]) == jvolume("")


def test_harvest_keys_and_sums_match_the_jax_package():
    import jax
    import jax.numpy as jnp
    from slate_tpu.obs import costaudit as jca

    f1 = jax.jit(lambda x: x + 1).lower(jnp.zeros((8, 8), jnp.float32)).compile()
    f2 = jax.jit(lambda x: x * 2).lower(jnp.zeros((8, 8), jnp.float32)).compile()
    runs = [costaudit.Run(log=_LOG, flops=1000.0, bytes_accessed=64.0),
            costaudit.Run(log=_LOG[:2], flops=24.0, bytes_accessed=8.0)]
    one = costaudit.harvest(runs[0])
    assert set(one) == set(jca.harvest(f1))
    agg = costaudit.harvest_many(runs)
    assert set(agg) == set(jca.harvest_many([f1, f2]))
    assert agg["programs"] == 2
    assert agg["flops"] == 1024.0 and agg["bytes_accessed"] == 72.0
    vol, vol2 = costaudit.collective_volume(_LOG), costaudit.collective_volume(_LOG[:2])
    assert agg["collective_bytes"] == vol["total_bytes"] + vol2["total_bytes"]
    assert agg["collective_count"] == 8
    assert agg["collectives"]["all-gather"] == {"count": 2, "bytes": 2 * 64 * 64 * 4}
    assert agg["comm_compute_ratio"] == agg["collective_bytes"] / 1024.0
    assert costaudit.harvest(costaudit.Run())["comm_compute_ratio"] is None


# ---------------------------------------------------------------------------
# the flop and byte counters (one process, no process group)

_A = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8)))
_SPD = _A @ _A.T + 8 * torch.eye(8, dtype=torch.float64)
_T = _A[:, :4].contiguous()
_B = _A[:, :3].contiguous()

# op -> (call, aten op counted, its LAPACK flops at these shapes)
_FLOPS = {
    "cholesky": (lambda: torch.linalg.cholesky_ex(_SPD), "linalg_cholesky_ex",
                 8 ** 3 // 3),
    "solve_triangular": (lambda: torch.linalg.solve_triangular(_SPD, _B, upper=False),
                         "linalg_solve_triangular", 8 * 8 * 3),
    "solve_triangular_right": (lambda: torch.linalg.solve_triangular(
        _SPD, _B.T, upper=False, left=False), "linalg_solve_triangular", 3 * 8 * 8),
    "lu_factor": (lambda: torch.linalg.lu_factor_ex(_SPD), "linalg_lu_factor_ex",
                  8 ** 3 - 8 ** 3 // 3),
    "geqrf": (lambda: torch.geqrf(_T), "geqrf", 2 * 8 * 16 - 2 * 64 // 3),
    "householder_product": (lambda: torch.linalg.householder_product(
        _T, torch.ones(4, dtype=torch.float64)), "linalg_householder_product",
        4 * 8 * 4 * 4 - 2 * 12 * 16 + 4 * 64 // 3),
    "ormqr": (lambda: torch.ormqr(_T, torch.ones(4, dtype=torch.float64), _B),
              "ormqr", 4 * 8 * 3 * 4 - 2 * 3 * 16),
    "eigh": (lambda: torch.linalg.eigh(_SPD), "_linalg_eigh",
             4 * 8 ** 3 // 3 + 2 * 8 ** 3),
    "svd": (lambda: torch.linalg.svd(_T, full_matrices=False), "_linalg_svd",
            4 * 8 * 16 - 4 * 64 // 3 + 4 * 8 * 16 + 8 * 64),
    "matmul": (lambda: _A @ _B, "mm", 2 * 8 * 8 * 3),
    "vector_norm": (lambda: torch.linalg.vector_norm(_A), "linalg_vector_norm", 2 * 64),
    "add": (lambda: _A + _A, "add", 64),
}


@pytest.mark.parametrize("name", sorted(_FLOPS))
def test_flop_counter_counts_each_lapack_op(name):
    call, op, flops = _FLOPS[name]
    with costaudit.counted() as run:
        call()
    assert run.flops_by_op.get(f"aten.{op}") == flops, run.flops_by_op
    assert run.flops >= flops > 0


def test_bytes_and_cost_analysis_dict_match_xla_keys():
    import jax
    import jax.numpy as jnp
    from slate_tpu.testing import cost_analysis_dict as jdict
    from slate_tpu_torch.testing import cost_analysis_dict

    a = torch.ones(4, 4)
    with costaudit.counted() as run:
        (a + a).t()                       # the transpose is a view: no bytes
    assert run.bytes_accessed == 3 * 16 * 4 and run.flops == 16
    assert run.log == []
    got = cost_analysis_dict(run)
    assert got == {"flops": 16.0, "bytes accessed": 192.0}
    compiled = jax.jit(lambda x: x + x).lower(jnp.ones((4, 4), jnp.float32)).compile()
    assert set(got) <= set(jdict(compiled))


# ---------------------------------------------------------------------------
# the run-time rows (P = 2, one pool)


def test_rows_are_deterministic(passes):
    first, second = passes
    for r in range(P):
        assert [e["row"] for e in first[r]] == [e["row"] for e in second[r]]
        assert [e["log"] for e in first[r]] == [e["log"] for e in second[r]]


def test_rows_pass_the_pins(passes):
    rows = [e["row"] for e in passes[0][0]]
    assert [r["routine"] for r in rows] == scaling.spec_names()
    assert scaling.check_pins(rows, scaling.load_pins()) == []
    skipped = [r["routine"] for r in rows if r.get("skipped")]
    assert skipped == ["gemm_ring"]            # Cannon needs a square grid
    assert not [r for r in rows if r.get("error")]
    pins = scaling.load_pins()
    assert pins["schema"] == scaling.PINS_SCHEMA and pins["P"] == 2
    assert (pins["bytes_slack"], pins["count_slack"]) == (1.25, 2)
    assert sorted(pins["routines"]) == sorted(scaling.pins_doc(rows)["routines"])


# The loop-free routines whose P = 2 row breaks the JAX package's pin
# (SCALING_PINS.json), by kind; ROADMAP §C gives each cause.
#   "one-rank": the row holds once the steps over a group of one rank are
#     left out (they move nothing): trmm's B panel gathered along p inside
#     gemm_allgather, tsqr's and the norm's FLAT collectives, which run as a
#     q step and a p step where the JAX package issues one.
#   "count": the bytes hold, the count does not: solvers._panel's blocked
#     substitution all-reduces one block a step where XLA gathers L and B
#     whole and solves replicated.
_JAX_DEPARTURES = {
    "trmm_distributed": "one-rank", "tsqr_distributed": "one-rank",
    "norm_distributed": "one-rank", "trsm_distributed": "count",
    "posv_distributed": "count", "trtri_distributed": "count",
    "potri_distributed": "count"}


def test_loop_free_rows_hold_against_the_jax_pins(passes, jax_loops, jax_scaling):
    """Where the JAX program has no ``while`` loop its pin is what one run
    moves, so the port's run-time row is held against it with the JAX gate
    and the pins' own slack; each departure is listed above with its kind."""
    import json

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "SCALING_PINS.json"), encoding="utf-8") as f:
        jpins = json.load(f)
    loops = jax_loops.result()
    loop_free = sorted(n for n, has in loops.items() if has is False)
    assert len(loop_free) == 13 and set(_JAX_DEPARTURES) <= set(loop_free)
    entries = {e["row"]["routine"]: e for e in passes[1][0]}
    for name in loop_free:
        e = entries[name]
        one = {**jpins, "routines": {name: jpins["routines"][name]}}
        bad = jax_scaling.check_pins([e["row"]], one)
        kind = _JAX_DEPARTURES.get(name)
        if kind is None:
            assert bad == [], (name, bad)
        elif kind == "count":
            assert bad and all("collective sites" in b for b in bad), (name, bad)
        else:
            assert bad, name
            vol = costaudit.collective_volume(
                [rec for rec in e["log"] if len(rec.groups[0]) > 1])
            moved = dict(e["row"], collective_bytes=vol["total_bytes"],
                         collective_count=vol["total_count"])
            assert jax_scaling.check_pins([moved], one) == [], name


def test_no_modelled_row_counts_zero_flops(passes):
    for r in range(P):
        for e in passes[0][r]:
            row = e["row"]
            if row.get("skipped"):
                continue
            if row["model_flops"] > 0:
                assert row["flops"] > 0, row["routine"]
            assert row["bytes_accessed"] > 0, row["routine"]


def test_gemm_allgather_bills_its_two_gathers(passes):
    row = passes[0][0][0]["row"]
    n = scaling.AUDIT_N
    assert row["routine"] == "gemm_allgather" and row["grid"] == "1x2"
    # A gathered along q (the full n x n on a 1x2 grid) and B along p (this
    # rank's n x n/2 shard, a group of one): 1.5 n^2 f32, as the JAX pin
    assert row["collectives"] == {"all-gather": {"count": 2, "bytes": int(1.5 * n * n * 4)}}
    assert row["flops"] == n ** 3                      # this rank's half
    assert row["comm_compute_ratio"] == row["collective_bytes"] / row["flops"]


def test_no_collective_escapes_the_log(passes):
    """Every collective CommDebugMode counts (c10d and functional, DTensor's
    own included) is in the log, one for one; the log also sees the
    point-to-point ops CommDebugMode cannot, one record for each batch the
    collectives module ran."""
    p2p = 0
    for r in range(P):
        for e in passes[0][r]:
            if e["log"] is None:
                assert e["p2p"] == 0, e["row"]["routine"]
                continue
            wires = {}
            for rec in e["log"]:
                wires[rec.wire] = wires.get(rec.wire, 0) + 1
            assert wires.pop("p2p", 0) == e["p2p"], e["row"]["routine"]
            assert wires == e["comm"], e["row"]["routine"]
            p2p += e["p2p"]
    assert p2p > 0


def test_gloo_reduce_scatter_is_logged_as_reduce_scatter(pool):
    import torch_audit_jobs

    for rank, (log, comm, out, still_on) in enumerate(
            pool.run(torch_audit_jobs.logged_reduce_scatter)):
        assert not still_on
        assert comm == {"allreduce_": 1}               # what gloo ran
        (rec,) = log
        assert (rec.op, rec.wire, rec.groups, rec.pairs) == \
            ("reduce-scatter", "allreduce_", ((0, 1),), None)
        assert rec.shape == (2, 3) and rec.bytes == 2 * 3 * 4   # the kept slice
        np.testing.assert_array_equal(out, np.full((2, 3), 2.0))


def test_scaling_cli_runs_on_the_card_unless_asked(monkeypatch, capsys):
    """``python -m slate_tpu_torch.obs.scaling`` hands ``--device`` to
    ``audit_all``, cuda unless asked (the pins are taken with --device cpu)."""
    asked = []

    def fake(nprocs, names=None, progress=None, device=None, pool=None):
        asked.append((tuple(nprocs), device))
        return []

    monkeypatch.setattr(scaling, "audit_all", fake)
    assert scaling.main([]) == 0
    assert scaling.main(["--device", "cpu"]) == 0
    assert asked == [((2,), None), ((2,), "cpu")]
    assert scaling.main(["--check", "--device", "cpu"]) == 1     # every pin missing
    assert "pinned but missing" in capsys.readouterr().out


def test_audit_all_needs_ranks_or_the_cpu():
    """P >= 2 on the card needs a launcher's ranks; the library refuses it
    instead of starting a pool it cannot run (entry points default to cuda)."""
    from slate_tpu_torch.core.exceptions import SlateError

    with pytest.raises(SlateError):
        obs.audit_all(nprocs=(2,), device="cuda" if torch.cuda.is_available() else None)
    assert slate_tpu_torch.obs.scaling.compile_spec is scaling.run_spec
