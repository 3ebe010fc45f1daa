"""The port's routine tester (slate_tpu_torch.testing) against the JAX package's
(slate_tpu.testing), on the CPU.

- The sweep grammar, ``format_table`` and ``--list`` give the same strings,
  names and categories.
- One row per category at n = 48 agrees with the JAX package's row in status,
  and in error within a factor ERR_FACTOR; the JAX rows run through
  ``run_routine`` under the suite's global x64 (its ``run_sweep`` scopes x64
  with ``jax.experimental.enable_x64``, which jax 0.9 no longer has).
- ``gesv_mixed`` passes in the port (the JAX row errors for the same reason).
- The tests of tests/test_tester.py follow, on the port, and then the CPU
  rehearsal of chip_smoke.py's tester phase at a small size.  The whole
  quick sweep runs on the card (chip_smoke.py), not here."""

import contextlib
import io

import numpy as np
import pytest
import torch

from slate_tpu import testing as jt
from slate_tpu.testing import __main__ as jmain
from slate_tpu.testing import sweeper as jsw
from slate_tpu_torch.testing import ROUTINES, run_routine
from slate_tpu_torch.testing import __main__ as tmain
from slate_tpu_torch.testing import driver as tdriver
from slate_tpu_torch.testing import sweeper as tsw
from slate_tpu_torch.testing.sweeper import (ParamSweep, TestResult, format_table,
                                             parse_dims, parse_list)

ERR_FACTOR = 10.0
# one routine per category (posv_f64ir is the JAX package's "chol" category)
CATEGORY_ROWS = {"blas3": "gemm", "aux": "norm", "cholesky": "posv",
                 "chol": "posv_f64ir", "lu": "gesv", "indefinite": "hesv",
                 "band": "gbsv", "qr": "gels", "serve": "gesv_batched",
                 "eig": "heev", "svd": "svd", "condest": "gecondest"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on the
    machine's cores, and torch's thread pool spinning beside them made these
    tests 10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rank_pool():
    """Eight gloo ranks on the CPU for the grid-swept rows."""
    from slate_tpu_torch.parallel.launch import RankPool

    with RankPool(8) as pool:
        yield pool


def params(n=48, dtype=np.float32, **kw):
    p = {"m": n, "n": n, "k": n, "nb": 16, "dtype": dtype, "kind": "randn",
         "cond": None, "seed": 0, "repeat": 1, "nrhs": 2}
    p.update(kw)
    return p


def cpu_row(routine, p):
    return run_routine(routine, p, device="cpu")


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# ---------------------------------------------------------------------------
# parity with the JAX package's tester

@pytest.mark.parametrize("spec", ["256", "64,128", "100:300:100", "100:300",
                                  "100x50", "100x50x25", "64,128:256:64,100x50"])
def test_dim_grammar_matches_jax(spec):
    assert parse_dims(spec) == jsw.parse_dims(spec)
    assert parse_list(spec) == jsw.parse_list(spec)


def test_format_table_matches_jax():
    rows = [("gemm", {"m": 8, "n": 8, "k": 8, "nb": 4, "dtype": "s"},
             dict(error=1e-7, time_s=0.1, gflops=5.0)),
            ("posv", {"m": 64, "n": 64, "k": 64, "nb": 16, "dtype": "d", "kind": "randn",
                      "cond": None, "seed": 0, "repeat": 1, "nrhs": 8, "grid": None},
             dict(error=2e-16, time_s=0.004, gflops=1.5, ref_time_s=0.002)),
            ("heev", {"m": 32, "n": 32, "k": 32, "nb": 8, "dtype": "s"},
             dict(status="FAILED", message="err>1e-5", error=3e-5)),
            ("gesv", {"m": 9}, dict(status="error", message="KeyError: 'n'"))]
    mine = [TestResult(r, p, **f) for r, p, f in rows]
    theirs = [jsw.TestResult(r, p, **f) for r, p, f in rows]
    assert format_table(mine) == jsw.format_table(theirs)
    assert format_table([]) == jsw.format_table([])


def test_list_gives_the_jax_names_and_categories():
    rc_t, out_t = _cli(tmain.main, ["all", "--list"])
    rc_j, out_j = _cli(jmain.main, ["all", "--list"])
    assert rc_t == rc_j == 0
    names = lambda out: [line.split()[:2] for line in out.splitlines()]
    assert names(out_t) == names(out_j)
    assert len(ROUTINES) == len(jt.ROUTINES) == 38
    for token in ("all", "lu", "eig", "serve", "gemm"):
        assert tmain.select_routines(token) == jmain.select_routines(token)


@pytest.mark.parametrize("category", sorted(CATEGORY_ROWS))
def test_one_row_per_category_matches_jax(category):
    routine = CATEGORY_ROWS[category]
    for dtype in (np.float64, np.float32):
        p = params(dtype=dtype)
        mine = cpu_row(routine, dict(p))
        theirs = jt.run_routine(routine, dict(p))
        assert mine.status == theirs.status == "pass", (mine.message, theirs.message)
        floor = float(np.finfo(dtype).eps)
        g, w = max(float(mine.error), floor), max(float(theirs.error), floor)
        assert max(g, w) <= ERR_FACTOR * min(g, w), (routine, g, w)


def test_sweep_rows_read_as_the_jax_rows():
    """run_sweep keeps the device out of params: the extra column is the JAX
    package's text."""
    (r,) = tdriver.run_sweep(["gemm"], [(32, 32, 32)], ["s"], [16], device="cpu")
    extra = format_table([r]).splitlines()[2]
    assert "kind=randn,cond=None,seed=0,repeat=1,nrhs=8,grid=None" in extra
    assert "device" not in extra and r.params["dtype"] == "s"


def test_gesv_mixed_promotes_s_and_records_iters():
    """s/c rows sweep the d/z mixed pipeline instead of skipping, and the IR
    iteration count lands in the row (the JAX row errors: its scoped x64
    needs jax.experimental.enable_x64, gone in jax 0.9)."""
    r = cpu_row("gesv_mixed", params())
    assert r.status == "pass", (r.status, r.message)
    assert "ir_iters" in r.details and r.details["ir_iters"] >= 0
    assert r.details.get("promoted", "").startswith("s/c")
    assert r.error is not None and r.error < 1e-12


@pytest.mark.parametrize("routine", ["posv", "gemm", "trsm", "her2k"])
def test_repeats_solve_the_same_problem(routine):
    """Every timed repeat builds its output wrappers afresh (the JAX runners
    hoist them, so their repeat > 1 rows accumulate and fail)."""
    r = cpu_row(routine, params(repeat=3))
    assert r.status == "pass", (r.status, r.message)


def test_cli_device_rule():
    rc, out = _cli(tmain.main, ["posv", "--dim", "64", "--device", "cpu"])
    assert rc == 0 and "1 tests: 1 pass" in out
    if torch.cuda.is_available():
        return
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, out = _cli(tmain.main, ["posv", "--dim", "64"])
    assert rc != 0 and "SlateError" in err.getvalue() and "CUDA" in err.getvalue()
    assert "pass" not in out
    row = run_routine("posv", params())          # never raises: an error row
    assert row.status == "error" and "CUDA" in row.message


def test_timing_waits_for_every_device_in_the_result(monkeypatch):
    """time_call ends each repeat in a sync of the row's device when that is
    a card, and syncs nothing for a CPU row."""
    synced = []
    monkeypatch.setattr(tsw.torch.cuda, "synchronize", synced.append)
    out, t = tsw.time_call(lambda: torch.ones(2), repeat=3, device="cpu")
    assert synced == [] and t >= 0 and torch.equal(out, torch.ones(2))
    tsw.time_call(lambda: None, repeat=3, device="cuda:1")
    assert synced == [torch.device("cuda:1")] * 3
    assert cpu_row("norm", params(n=8)).status == "pass"
    assert synced == [torch.device("cuda:1")] * 3


# ---------------------------------------------------------------------------
# tests/test_tester.py, on the port

class TestSweeperGrammar:
    def test_single_and_list(self):
        assert parse_dims("256") == [(256, 256, 256)]
        assert parse_dims("64,128") == [(64, 64, 64), (128, 128, 128)]

    def test_range(self):
        assert parse_dims("100:300:100") == [(100,) * 3, (200,) * 3, (300,) * 3]

    def test_shapes(self):
        assert parse_dims("100x50") == [(100, 50, 50)]
        assert parse_dims("100x50x25") == [(100, 50, 25)]

    def test_mixed(self):
        assert parse_dims("64,100x50") == [(64, 64, 64), (100, 50, 50)]

    def test_sweep_cartesian(self):
        sweep = ParamSweep(a=[1, 2], b=["x", "y", "z"])
        assert len(sweep) == 6
        assert {(p["a"], p["b"]) for p in sweep} == {(i, c) for i in (1, 2)
                                                    for c in "xyz"}

    def test_table_formats(self):
        r = TestResult("gemm", {"m": 8, "n": 8, "k": 8, "nb": 4, "dtype": "s"},
                       error=1e-7, time_s=0.1, gflops=5.0)
        out = format_table([r])
        assert "gemm" in out and "pass" in out and "1 tests: 1 pass" in out


class TestDispatch:
    def test_inventory_covers_families(self):
        cats = {spec["category"] for spec in ROUTINES.values()}
        assert {"blas3", "cholesky", "lu", "qr", "eig", "svd", "band",
                "indefinite"} <= cats

    def test_unknown_routine_raises(self):
        with pytest.raises(KeyError):
            run_routine("nosuch", {}, device="cpu")

    @pytest.mark.parametrize("routine", ["gemm", "potrf", "getrf", "geqrf"])
    def test_smoke(self, routine):
        r = cpu_row(routine, params())
        assert r.status == "pass", (r.status, r.message)
        assert r.error is not None and r.time_s is not None

    @pytest.mark.parametrize("routine", ["gemm", "potrf", "gesv"])
    def test_grid_sweep_routes_distributed(self, routine, rank_pool):
        """--grid PxQ rows run the distributed drivers (the reference tester's
        p/q sweep dimension), here on a 2x4 grid of gloo ranks: the row
        passes, and every rank made collectives during it."""
        from torch_rank_jobs import counted_call

        p = params(32, np.float64, nb=8, grid=(2, 4))
        got = rank_pool.run(counted_call, "slate_tpu_torch.testing.run_routine",
                            (routine, p), {"device": "cpu"}, (2, 4, "col"))
        r = got[0][0]
        assert r.status == "pass", (r.status, r.message)
        assert all(calls > 0 for _, calls in got), [calls for _, calls in got]

    @pytest.mark.parametrize("routine", ["heev", "svd"])
    def test_grid_sweep_refuses_15b_drivers(self, routine, rank_pool):
        """The eigenvalue and SVD rows on a grid run the distributed drivers
        (item 15b, no longer refused): the row passes the JAX runners' gate,
        and every rank made collectives during it."""
        from torch_rank_jobs import counted_call

        p = params(32, np.float64, nb=8, grid=(2, 4))
        got = rank_pool.run(counted_call, "slate_tpu_torch.testing.run_routine",
                            (routine, p), {"device": "cpu"}, (2, 4, "col"))
        r = got[0][0]
        assert r.status == "pass", (r.status, r.message)
        assert all(calls > 0 for _, calls in got), [calls for _, calls in got]

    def test_runner_never_raises(self):
        r = run_routine("gemm", {"m": 8}, device="cpu")
        assert r.status == "error"

    @pytest.mark.parametrize("routine", ["sterf", "he2hb", "hb2st"])
    def test_stage_level_rows(self, routine):
        r = cpu_row(routine, params())
        assert r.status == "pass", (r.status, r.message)

    def test_heev_row_carries_phase_map(self):
        r = cpu_row("heev", params(32, nb=8))
        assert r.status == "pass", (r.status, r.message)
        phases = r.details.get("phases", {})
        assert "total_s" in phases and phases["total_s"] > 0


# ---------------------------------------------------------------------------
# the tester phase of chip_smoke.py, rehearsed on the CPU at a small size with
# its checks (the quick sweep of one category, as the card runs all of them;
# the full-width rows, matgen, gemm_f64emu and the LAPACK API cut to n <= 600)

SMALL_TESTER = {"quick": ["lu", "--quick", "--type", "s,d"], "quick_rows": 20,
                "n": 96, "nb": 32, "repeat": 2,
                "full": ("posv", "gesv", "norm", "gesv_f64ir"), "condest_n": 64,
                "matgen_n": 600, "matgen_kinds": ("randn", "rand", "rands", "randb",
                                                  "randr"),
                "spectrum_n": 64}


def test_tester_phase_on_the_cpu():
    import chip_smoke as cs

    quick = cs.tester_quick("cpu", SMALL_TESTER["quick"])
    full = cs.tester_full("cpu", SMALL_TESTER)
    cs.check_tester_path(quick, full, SMALL_TESTER)
    assert len(quick["slowest"]) == 5 and quick["summary"].startswith("20 tests")
    assert set(full) == {"posv", "gesv", "norm", "gesv_f64ir", "gecondest"}
    cs.check_matgen(cs.matgen_checks("cpu", SMALL_TESTER), SMALL_TESTER)
    cs.check_f64emu(cs.f64emu_check("cpu", 64))
    cs.check_lapack(cs.lapack_checks("cpu", 64), 64)


def test_table_rows_parse_the_cli_table():
    import chip_smoke as cs

    rows = [TestResult("gemm", {"m": 8, "n": 8, "k": 8, "nb": 4, "dtype": "s",
                                "kind": "randn"}, error=1e-7, time_s=0.25, gflops=5.0),
            TestResult("gesv", {"m": 9, "n": 9, "k": 9, "nb": 4, "dtype": "d"},
                       status="error", message="SlateError: CUDA is not available")]
    parsed = cs._table_rows("  progress line\n\n" + format_table(rows))
    assert [(r["routine"], r["type"], r["m"], r["status"]) for r in parsed] == [
        ("gemm", "s", 8, "pass"),
        ("gesv", "d", 9, "error (SlateError: CUDA is not available)")]
    assert parsed[0]["time_s"] == 0.25 and parsed[1]["time_s"] == 0.0
