"""Escalation ladders of the PyTorch port (slate_tpu_torch.robust.policy and the
ladder drivers) against the JAX package.

The ladder engine runs the same rungs under both packages and must leave the
same report (rung chain, retries, recovered) and the same exceptions.  The
chaos cases inject the same seeded faults into both packages' drivers on
numpy-seeded inputs: ``info`` codes, report chains, ``recovered`` and the
fired-fault log must be identical, and the recovered solutions within the
tests' residual gate (||A X - B|| / ||B|| < 1e-9, as ``tests/test_robust.py``).
The ``ir_stall`` perturbation draws from a ``torch.Generator`` in the port
and from ``jax.random`` in the JAX package, so only its outcome is compared.
"""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu import robust as jrobust
from slate_tpu.utils import trace as jtrace
from slate_tpu_torch import robust as trobust
from slate_tpu_torch.utils import trace as ttrace

PKGS = {"jax": (sj, jrobust, jtrace), "torch": (st, trobust, ttrace)}


def _spd(seed, n):
    m = np.random.default_rng(seed).standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


def _gen(seed, n):
    return np.random.default_rng(seed).standard_normal((n, n)) + n * np.eye(n)


def _rhs(seed, n, k=2):
    return np.random.default_rng(seed + 1000).standard_normal((n, k))


def _t(a):
    return torch.from_numpy(np.array(a))


def _resid(a, x, b):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.linalg.norm(a @ x - b) / np.linalg.norm(b)


def _chain(rep):
    return (rep.routine, rep.info, rep.fallback_chain, rep.recovered, rep.retries,
            rep.precision_used, tuple(rep.faults))


# ---------------------------------------------------------------------------
# the ladder engine
# ---------------------------------------------------------------------------


def test_ladder_table_and_policy_match_jax():
    assert trobust.LADDERS == jrobust.LADDERS
    opts = {"max_retries": 2, "retry_backoff": 0.0}
    got = trobust.RetryPolicy.from_options(st.Options.make(opts), "gesv_mixed")
    want = jrobust.RetryPolicy.from_options(sj.Options.make(opts), "gesv_mixed")
    assert (got.max_retries, got.backoff, got.ladder) == \
        (want.max_retries, want.backoff, want.ladder) == (2, 0.0, ("mixed", "full"))


def _scenario(pkg, verdicts, max_retries=0, raise_on_exhaust=False):
    """Run rungs "a", "b" whose successive verdicts come from ``verdicts``;
    each rung records a phase map.  Returns (payload or exception, report,
    phase attempts)."""
    _, robust, trace = PKGS[pkg]
    calls = iter(verdicts)
    routine = f"t_ladder_{pkg}_{len(verdicts)}_{max_retries}"

    def rung(name):
        def run():
            trace.record_phases(f"{routine}_inner", {"work": 1.0})
            return name, next(calls)
        return robust.Rung(name, run)

    report = robust.SolveReport(routine="demo")
    try:
        out = robust.run_ladder(routine, [rung("a"), rung("b")],
                                robust.RetryPolicy(max_retries=max_retries), report,
                                raise_on_exhaust=raise_on_exhaust)
    except Exception as e:          # the exception is the result compared
        out = (type(e).__name__, e.report is report)
    return out, (report.fallback_chain, report.retries, report.recovered), \
        trace.phase_attempts(routine)


@pytest.mark.parametrize("verdicts,max_retries,raise_on_exhaust", [
    ([True], 0, False),                        # first rung wins
    ([False, True], 0, False),                 # escalation
    ([False, False, True], 1, False),          # a retry on the first rung, then b
    ([False, False, False, False], 1, True),   # exhaustion raises, retries counted
    ([False, False], 0, False),                # exhaustion returns the last payload
], ids=["first-wins", "escalate", "retry", "exhaust-raise", "exhaust-return"])
def test_run_ladder_matches_jax(verdicts, max_retries, raise_on_exhaust):
    got = _scenario("torch", verdicts, max_retries, raise_on_exhaust)
    want = _scenario("jax", verdicts, max_retries, raise_on_exhaust)
    assert got[0] == want[0] and got[1] == want[1]
    # one phase map per attempt, keyed by the attempt index across rungs
    assert list(got[2]) == list(want[2]) == list(range(len(verdicts)))
    if raise_on_exhaust:
        assert got[0] == ("ConvergenceError", True)
        assert got[1] == (("a", "b"), 2, False)


def test_guard_shards_reruns_a_failed_shard():
    """No plan: one call, no check.  A shard_fail at the output of the first
    run: the guard re-runs once and returns the intact result."""
    x = torch.ones(8, 2, dtype=torch.float64)
    out, retries = trobust.guard_shards("solve", lambda: x.clone())
    assert retries == 0 and torch.equal(out, x)
    plan = trobust.FaultPlan([trobust.FaultSpec("solve", "shard_fail", index=1,
                                                world=4)])
    with plan:
        out, retries = trobust.guard_shards("solve", lambda: x.clone())
    assert retries == 1 and torch.equal(out, x)
    assert plan.fired == (("solve", "shard_fail", 0),)


# ---------------------------------------------------------------------------
# LU ladders and fault classes
# ---------------------------------------------------------------------------


def _both(call):
    """``call(pkg, to)`` under each package, ``to`` its array constructor."""
    return call(PKGS["torch"], _t), call(PKGS["jax"], np.array)


@pytest.mark.parametrize("kind,tile", [("nan_tile", (0, 0)), ("inf_tile", (1, 1))])
def test_tile_faults_surface_info(kind, tile):
    """A poisoned tile never leaves info 0.  With NaN in the first pivot
    column the code depends on the LAPACK build's pivot search: the JAX
    package's (scipy's LAPACK) passes over the NaN rows and reports 2, the
    port's CPU LAPACK picks a NaN row and reports 1 (ROADMAP.md §C)."""
    a, b = _gen(1, 32), _rhs(1, 32)

    def call(p, to):
        slate, robust, _ = p
        with robust.FaultPlan([robust.FaultSpec("getrf", kind, tile=tile, nb=8)]):
            _, _, info = slate.gesv(to(a), to(b))
        return int(info)

    got, want = _both(call)
    assert got > 0 and want > 0
    if kind == "inf_tile":
        assert got == want


def test_zero_pivot_escalates_nopiv_to_partialpiv():
    n = 48
    a, b = _gen(2, n), _rhs(2, n, 3)

    def call(p, to):
        slate, robust, _ = p
        plan = robust.FaultPlan([robust.FaultSpec("getrf_nopiv", "zero_pivot", index=5)])
        with plan:
            X, _, info, rep = slate.gesv_nopiv(to(a), to(b),
                                               slate.Options(solve_report=True))
        return X, int(info), _chain(rep), plan.fired

    (X, info, rep, fired), (Xj, infoj, repj, firedj) = _both(call)
    assert (info, rep, fired) == (infoj, repj, firedj)
    assert rep[2] == ("nopiv", "partialpiv") and rep[3] and info == 0
    assert fired == (("getrf_nopiv", "zero_pivot", 0),)
    assert _resid(a, X, b) < 1e-9


def test_zero_pivot_without_fallback_surfaces_failure():
    n = 48
    a, b = _gen(3, n), _rhs(3, n, 3)

    def call(p, to):
        slate, robust, _ = p
        with robust.FaultPlan([robust.FaultSpec("getrf_nopiv", "zero_pivot", index=5)]):
            X, _, info, rep = slate.gesv_nopiv(
                to(a), to(b), slate.Options(solve_report=True, use_fallback_solver=False))
        return int(info), _chain(rep)

    got, want = _both(call)
    assert got == want
    assert got[1][2] == ("nopiv",) and not got[1][3] and got[0] > 0


def test_failed_solve_reports_not_recovered():
    n = 32
    a = _gen(4, n)
    a[:, 4] = 0
    a[4, :] = 0

    def call(p, to):
        slate, _, _ = p
        _, _, info, rep = slate.gesv(to(a), to(_rhs(4, n)), slate.Options(solve_report=True))
        return int(info), rep.recovered

    got, want = _both(call)
    assert got == want and got[0] > 0 and got[1] is False


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "escalated"])
def test_wrapper_keeps_factor_writeback_on_ladder_path(fault):
    """A Matrix wrapper ends up holding the winning rung's LU factor: the nopiv
    factor of A, or after an escalation the pivoted factor of the pristine A."""
    n = 32
    a = _gen(5, n)
    specs = [trobust.FaultSpec("getrf_nopiv", "zero_pivot", index=3)] if fault else []
    Aw = st.Matrix.from_array(_t(a), nb=8)
    with trobust.FaultPlan(specs):
        _, perm, info = st.gesv_nopiv(Aw, _t(_rhs(5, n)))
    lu_ = Aw.array.numpy()
    L, U = np.tril(lu_, -1) + np.eye(n), np.triu(lu_)
    assert int(info) == 0
    assert np.linalg.norm(a[perm.numpy()] - L @ U) / np.linalg.norm(a) < 1e-10
    if fault:
        # the partial-pivot rung's factor of the pristine operand
        lu_p, perm_p, _ = st.getrf(_t(a))
        assert torch.equal(Aw.array, lu_p) and torch.equal(perm, perm_p)


def _mixed(routine, a, b, specs, seed=0, opts=None):
    """Run ``routine`` under both packages with ``specs``; returns
    ((X, info, iters, report chain, fired), same for JAX)."""
    opts = dict(solve_report=True, **(opts or {}))

    def call(p, to):
        slate, robust, _ = p
        plan = robust.FaultPlan([robust.FaultSpec(*s[:2], **s[2]) for s in specs],
                                seed=seed)
        with plan:
            out = getattr(slate.linalg, routine)(to(a), to(b), slate.Options(**opts))
        X, info, iters, rep = out[0], out[-3], out[-2], out[-1]
        return X, int(info), int(iters), _chain(rep), plan.fired

    return _both(call)


@pytest.mark.parametrize("routine,spd", [("gesv_mixed", False), ("posv_mixed", True)])
def test_ir_stall_escalates_mixed_to_full(routine, spd):
    n = 64
    a = _spd(6, n) if spd else _gen(6, n)
    b = _rhs(6, n)
    (X, info, _, rep, fired), (_, infoj, _, repj, firedj) = _mixed(
        routine, a, b, [(routine, "ir_stall", {"scale": 1e3})], seed=3)
    assert (info, rep, fired) == (infoj, repj, firedj)
    assert rep[2] == ("mixed", "full") and rep[3] and info == 0
    assert rep[5] == "float64"
    assert _resid(a, X, b) < 1e-9


@pytest.mark.parametrize("routine,spd", [("gesv_mixed", False), ("posv_mixed", True)])
def test_transient_input_fault_recovers_via_full_rung(routine, spd):
    n = 48
    a = _spd(7, n) if spd else _gen(7, n)
    b = _rhs(7, n)
    (X, info, _, rep, fired), (_, infoj, _, repj, firedj) = _mixed(
        routine, a, b, [(routine, "nan_tile", {"tile": (0, 0), "nb": 8})])
    assert (info, rep, fired) == (infoj, repj, firedj)
    assert fired == ((routine, "nan_tile", 0),)
    assert rep[2] == ("mixed", "full") and rep[3] and info == 0
    assert _resid(a, X, b) < 1e-9


@pytest.mark.parametrize("routine,spd", [("gesv_mixed", False), ("posv_mixed", True)])
def test_clean_mixed_stays_on_first_rung(routine, spd):
    n = 64
    a = _spd(8, n) if spd else _gen(8, n)
    b = _rhs(8, n)
    (X, info, iters, rep, _), (Xj, infoj, itersj, repj, _) = _mixed(routine, a, b, [])
    assert (info, iters, rep) == (infoj, itersj, repj)
    assert rep[2] == ("mixed",) and rep[5] == "float32" and rep[6] == ()
    assert np.linalg.norm(X.numpy() - np.asarray(Xj)) / np.linalg.norm(np.asarray(Xj)) <= 1e-12


@pytest.mark.parametrize("routine,site,spd", [
    ("gesv_nopiv", "getrf_nopiv", False), ("gesv_mixed", "gesv_mixed", False),
    ("posv_mixed", "posv_mixed", True), ("gesv_rbt", "getrf_nopiv", False)])
def test_forced_zero_pivot_escalation_per_ladder(routine, site, spd):
    """One forced escalation per ladder — a zero pivot in the first rung's
    factored operand, transient by call index — reads (first rung, second
    rung) with recovered true in both packages (chip_smoke.py repeats this on
    the card).  gesv_rbt takes it in the transformed matrix: a zero row and
    column of A itself passes the butterfly's refinement (a backward-error
    test) with a huge solution, in both packages."""
    n = 40
    a = _spd(9, n) if spd else _gen(9, n)
    b = _rhs(9, n)

    def call(p, to):
        slate, robust, _ = p
        plan = robust.FaultPlan([robust.FaultSpec(site, "zero_pivot", call_index=0,
                                                  index=7)])
        with plan:
            out = getattr(slate, routine)(to(a), to(b), slate.Options(solve_report=True))
        return out[0], _chain(out[-1]), plan.fired

    (X, rep, fired), (_, repj, firedj) = _both(call)
    assert (rep, fired) == (repj, firedj)
    assert rep[2] == trobust.LADDERS[routine] and rep[3] and rep[1] == 0
    assert _resid(a, X, b) < 1e-9


@pytest.mark.parametrize("routine", ["gesv_mixed_gmres", "posv_mixed_gmres"])
def test_gmres_nan_residual_forces_the_fallback(routine):
    """A NaN in the operand makes every GMRES residual NaN: the convergence
    test fails and the full-precision solve takes over (iters -1), reporting
    the NaN's info as the JAX package does."""
    n = 24
    a = _spd(10, n) if routine.startswith("posv") else _gen(10, n)
    a[3, 3] = np.nan
    b = _rhs(10, n, 1)

    def call(p, to):
        slate, _, _ = p
        out = getattr(slate.linalg, routine)(to(a), to(b))
        return int(out[-2]), int(out[-1])

    got, want = _both(call)
    assert got == want and got[1] == -1 and got[0] > 0


# ---------------------------------------------------------------------------
# Cholesky fault classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [("nan_tile", {"tile": (1, 1), "nb": 8}),
                                     ("zero_pivot", {"index": 9})])
def test_potrf_faults_surface_info(kind, kw):
    a = _spd(11, 32)

    def call(p, to):
        slate, robust, _ = p
        with robust.FaultPlan([robust.FaultSpec("potrf", kind, **kw)]):
            _, info = slate.potrf(to(a))
        return int(info)

    got, want = _both(call)
    assert got == want > 0
    if kind == "zero_pivot":
        assert got <= 10


def test_posv_mixed_wrapper_keeps_factor_on_full_rung():
    """The full rung passes the caller's HermitianMatrix through posv, so the
    wrapper's stored triangle ends up holding the Cholesky factor."""
    n = 32
    a = _spd(12, n)
    Aw = st.HermitianMatrix.from_array("lower", _t(a), nb=8)
    with trobust.FaultPlan([trobust.FaultSpec("posv_mixed", "ir_stall")]):
        X, info, _, rep = st.posv_mixed(Aw, _t(_rhs(12, n)), {"solve_report": True})
    assert rep.fallback_chain == ("mixed", "full") and int(info) == 0
    np.testing.assert_allclose(np.tril(Aw.array.numpy()), np.linalg.cholesky(a),
                               atol=1e-12)
    np.testing.assert_array_equal(np.triu(Aw.array.numpy(), 1), np.triu(a, 1))
