"""Per-routine scaling audit: run every distributed routine on a P-rank grid
and harvest its collective volume and this rank's flops / bytes.

The JAX package compiles each :class:`RoutineSpec` ahead of time on a CPU mesh
and reads the compiled program.  The port runs each spec once, counted
(:func:`run_spec`: the collective log, the flop counter and the byte counter
on), so its rows are run-time counts per rank (``obs.costaudit``).  A grid of
P ≥ 2 ranks runs on a pool of gloo ranks on the CPU (``parallel.launch.
RankPool``) or under a launcher with one card per rank; ``nproc=1`` runs in
this process, on a world of one (NCCL on the card).  ``audit_all`` returns
rank 0's rows.

The registry is the JAX package's: the same 31 specs, names, modules, order,
audit shapes (n = 128, nb = 32, kd = 4) and flop models, on the same numpy
inputs (``np.random.default_rng``, float32).  The P = 2 rows on gloo are
pinned in ``scaling_pins.json`` next to this module; regenerate it with
``python -m slate_tpu_torch.obs.scaling --update-pins``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .costaudit import counted, harvest

#: the default audit problem edge (divisible by every grid in P ∈ {2,4,8}
#: and by the nb=32 blocking the specs use)
AUDIT_N = 128
AUDIT_NB = 32
#: band audits: half-bandwidth small enough for the chase's seg >= 2kd+2
#: constraint at P=8 (seg = 128/8 = 16 >= 2*4+2)
AUDIT_KD = 4

_DTYPE = np.float32

PINS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "scaling_pins.json")
PINS_SCHEMA = "slate_tpu_torch.scaling_pins/v1"


@dataclasses.dataclass(frozen=True)
class RoutineSpec:
    """One audited distributed routine.

    name:     row label (the public driver's name).
    module:   owning ``slate_tpu_torch.parallel`` module (table grouping).
    build:    ``build(grid) -> call``: puts the audit inputs on the grid's
              device and returns the zero-argument call that runs the routine.
    model_flops: whole-problem flop model at the audit shape (this rank's
              flops come from the flop counter).
    requires: optional grid predicate (e.g. Cannon's square-grid-only ring).
    """

    name: str
    module: str
    build: Callable[[Any], Any]
    model_flops: float = 0.0
    requires: Optional[Callable[[Any], bool]] = None


def _rng(seed: int = 0):
    return np.random.default_rng(seed)


def _randn(m: int, n: int) -> np.ndarray:
    return _rng(m * 131 + n).standard_normal((m, n)).astype(_DTYPE)


def _spd(n: int) -> np.ndarray:
    g = _rng(n).standard_normal((n, n))
    return (g @ g.T + n * np.eye(n)).astype(_DTYPE)


def _randn_batch(b: int, m: int, n: int) -> np.ndarray:
    a = _rng(b * 17 + m).standard_normal((b, m, n))
    if m == n:
        a = a + m * np.eye(m)      # diagonally dominant: well-posed solves
    return a.astype(_DTYPE)


def _spd_batch(b: int, n: int) -> np.ndarray:
    g = _rng(b * 31 + n).standard_normal((b, n, n))
    return (g @ np.swapaxes(g, -1, -2) + n * np.eye(n)).astype(_DTYPE)


def _band_sym(n: int, kd: int) -> np.ndarray:
    """Dense-storage Hermitian band matrix (the chase's input shape)."""
    mask = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) <= kd
    return (_spd(n) * mask).astype(_DTYPE)


def _band_upper(n: int, kd: int) -> np.ndarray:
    """Dense-storage upper-band matrix (tb2bd's input shape)."""
    off = np.arange(n)[None, :] - np.arange(n)[:, None]
    mask = (off >= 0) & (off <= kd)
    return (_randn(n, n) * mask + np.eye(n) * n).astype(_DTYPE)


def _on(grid, fn, *arrays):
    """The call ``fn(*tensors)`` with the numpy inputs on the grid's device."""
    import torch

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(grid.device) for a in arrays]
    return lambda: fn(*args)


def _square_grid(grid) -> bool:
    return grid.p == grid.q


def build_specs(n: int = AUDIT_N, nb: int = AUDIT_NB,
                kd: int = AUDIT_KD) -> List[RoutineSpec]:
    """The audit table at edge ``n``, block ``nb`` and half-bandwidth ``kd``.
    Imports live inside the builders so ``import slate_tpu_torch.obs`` stays
    light; every builder closes over nothing but the grid handed to it."""
    from ..parallel import (band_dist, batched, blas3_dist, chase_dist, eig_dist,
                            indefinite_dist, inverse, lu_dist, pipeline, qr_dist,
                            rbt, secular, solvers, summa)

    mt = 4 * n                     # tall-panel audit height
    nrhs = 16

    def band_lower(g):
        import torch
        spd = torch.from_numpy(_spd(n)).to(g.device)
        ab = band_dist.dense_to_band_lower(spd, kd)
        return lambda: band_dist.pbtrf_distributed(ab, g, kd=kd, nb=nb)

    def band_general(g):
        import torch
        spd = torch.from_numpy(_spd(n)).to(g.device)
        gb = band_dist.dense_to_band_general(spd, kd, kd, extra=kd)
        return lambda: band_dist.gbtrf_distributed(gb, g, kl=kd, ku=kd, nb=nb)

    specs = [
        # -- summa ----------------------------------------------------------
        RoutineSpec(
            "gemm_allgather", "summa",
            lambda g: _on(g, lambda a, b: summa.gemm_allgather(a, b, g),
                          _randn(n, n), _randn(n, n)),
            model_flops=2 * n**3),
        RoutineSpec(
            "gemm_ring", "summa",
            lambda g: _on(g, lambda a, b: summa.gemm_ring(a, b, g),
                          _randn(n, n), _randn(n, n)),
            model_flops=2 * n**3, requires=_square_grid),
        # -- blas3_dist ------------------------------------------------------
        RoutineSpec(
            "herk_distributed", "blas3_dist",
            lambda g: _on(g, lambda a, c: blas3_dist.herk_distributed(
                1.0, a, 0.0, c, g), _randn(n, n), _spd(n)),
            model_flops=n**3),
        RoutineSpec(
            "trmm_distributed", "blas3_dist",
            lambda g: _on(g, lambda a, b: blas3_dist.trmm_distributed(
                "left", 1.0, a, b, g), _spd(n), _randn(n, n)),
            model_flops=n**3),
        # -- solvers ---------------------------------------------------------
        RoutineSpec(
            "potrf_distributed", "solvers",
            lambda g: _on(g, lambda a: solvers.potrf_distributed(a, g, nb=nb),
                          _spd(n)),
            model_flops=n**3 / 3),
        RoutineSpec(
            "trsm_distributed", "solvers",
            lambda g: _on(g, lambda l, b: solvers.trsm_distributed(l, b, g),
                          _spd(n), _randn(n, nrhs)),
            model_flops=n * n * nrhs),
        RoutineSpec(
            "trsmA_distributed", "solvers",
            lambda g: _on(g, lambda a, b: solvers.trsmA_distributed(a, b, g),
                          _spd(n), _randn(n, nrhs)),
            model_flops=n * n * nrhs),
        RoutineSpec(
            "posv_distributed", "solvers",
            lambda g: _on(g, lambda a, b: solvers.posv_distributed(
                a, b, g, nb=nb), _spd(n), _randn(n, nrhs)),
            model_flops=n**3 / 3 + 2 * n * n * nrhs),
        RoutineSpec(
            "cholqr_distributed", "solvers",
            lambda g: _on(g, lambda a: solvers.cholqr_distributed(a, g),
                          _randn(mt, nb)),
            model_flops=2 * mt * nb * nb),
        RoutineSpec(
            "gels_cholqr_distributed", "solvers",
            lambda g: _on(g, lambda a, b: solvers.gels_cholqr_distributed(
                a, b, g), _randn(mt, nb), _randn(mt, nrhs)),
            model_flops=2 * mt * nb * nb + 2 * mt * nb * nrhs),
        # -- lu_dist ---------------------------------------------------------
        RoutineSpec(
            "getrf_distributed", "lu_dist",
            lambda g: _on(g, lambda a: lu_dist.getrf_distributed(a, g, nb=nb),
                          _randn(n, n)),
            model_flops=2 * n**3 / 3),
        RoutineSpec(
            "getrf_tall_distributed", "lu_dist",
            lambda g: _on(g, lambda a: lu_dist.getrf_tall_distributed(
                a, g, nb=nb), _randn(mt, nb)),
            model_flops=mt * nb * nb),
        RoutineSpec(
            "gesv_distributed", "lu_dist",
            lambda g: _on(g, lambda a, b: lu_dist.gesv_distributed(
                a, b, g, nb=nb), _randn(n, n), _randn(n, nrhs)),
            model_flops=2 * n**3 / 3 + 2 * n * n * nrhs),
        # -- rbt -------------------------------------------------------------
        RoutineSpec(
            "getrf_nopiv_distributed", "rbt",
            lambda g: _on(g, lambda a: rbt.getrf_nopiv_distributed(
                a, g, nb=nb), _spd(n)),
            model_flops=2 * n**3 / 3),
        # -- qr_dist ---------------------------------------------------------
        RoutineSpec(
            "tsqr_distributed", "qr_dist",
            lambda g: _on(g, lambda a: qr_dist.tsqr_distributed(a, g),
                          _randn(mt, nb)),
            model_flops=2 * mt * nb * nb),
        RoutineSpec(
            "geqrf_distributed", "qr_dist",
            lambda g: _on(g, lambda a: qr_dist.geqrf_distributed(a, g, nb=nb),
                          _randn(n, n)),
            model_flops=4 * n**3 / 3),
        # -- eig_dist --------------------------------------------------------
        RoutineSpec(
            "he2hb_distributed", "eig_dist",
            lambda g: _on(g, lambda a: eig_dist.he2hb_distributed(a, g, nb=nb),
                          _spd(n)),
            model_flops=4 * n**3 / 3),
        RoutineSpec(
            "ge2tb_distributed", "eig_dist",
            lambda g: _on(g, lambda a: eig_dist.ge2tb_distributed(a, g, nb=nb),
                          _randn(n, n)),
            model_flops=8 * n**3 / 3),
        RoutineSpec(
            "norm_distributed", "eig_dist",
            lambda g: _on(g, lambda a: eig_dist.norm_distributed("fro", a, g),
                          _randn(n, n)),
            model_flops=2 * n * n),
        RoutineSpec(
            "steqr_distributed", "eig_dist",
            lambda g: _on(g, lambda d, e: eig_dist.steqr_distributed(d, e, g),
                          _randn(n, 1)[:, 0], _randn(n - 1, 1)[:, 0]),
            model_flops=6 * n**3),
        # -- secular ---------------------------------------------------------
        RoutineSpec(
            "secular_roots_sharded", "secular",
            lambda g: _on(
                g, lambda d, z2: secular.secular_roots_sharded(d, z2, 1.0, g),
                np.sort(np.abs(_rng(3).standard_normal(n))).astype(_DTYPE)
                + np.arange(n, dtype=_DTYPE),
                (np.abs(_rng(5).standard_normal(n)) + 0.1).astype(_DTYPE)),
            model_flops=90 * n * n),
        # -- chase_dist ------------------------------------------------------
        RoutineSpec(
            "hb2st_chase_distributed", "chase_dist",
            lambda g: _on(g, lambda a: chase_dist.hb2st_chase_distributed(
                a, kd, g), _band_sym(n, kd)),
            model_flops=6 * n * n * kd),
        RoutineSpec(
            "tb2bd_chase_distributed", "chase_dist",
            lambda g: _on(g, lambda b: chase_dist.tb2bd_chase_distributed(
                b, kd, g), _band_upper(n, kd)),
            model_flops=6 * n * n * kd),
        # -- band_dist -------------------------------------------------------
        RoutineSpec("pbtrf_distributed", "band_dist", band_lower,
                    model_flops=n * kd * kd),
        RoutineSpec("gbtrf_distributed", "band_dist", band_general,
                    model_flops=2 * n * kd * kd),
        # -- indefinite_dist -------------------------------------------------
        RoutineSpec(
            "hetrf_distributed", "indefinite_dist",
            lambda g: _on(g, lambda a: indefinite_dist.hetrf_distributed(
                a, g, nb=nb), _spd(n)),
            model_flops=n**3 / 3),
        # -- inverse ---------------------------------------------------------
        RoutineSpec(
            "trtri_distributed", "inverse",
            lambda g: _on(g, lambda t: inverse.trtri_distributed(t, g), _spd(n)),
            model_flops=n**3 / 3),
        RoutineSpec(
            "potri_distributed", "inverse",
            lambda g: _on(g, lambda l: inverse.potri_distributed(l, g), _spd(n)),
            model_flops=2 * n**3 / 3),
        # -- pipeline --------------------------------------------------------
        RoutineSpec(
            "potrf_pipelined", "pipeline",
            lambda g: _on(g, lambda a: pipeline.potrf_pipelined(a, g, nb=nb),
                          _spd(n)),
            model_flops=n**3 / 3),
        # -- batched (serving tier) ------------------------------------------
        # batch=16 divides every grid in P ∈ {2,4,8}; the audited fact is
        # that the batch tier runs with ZERO collectives — independent
        # problems shard perfectly
        RoutineSpec(
            "gesv_batched_distributed", "batched",
            lambda g: _on(g, lambda a, b: batched.gesv_batched_distributed(
                a, b, g), _randn_batch(16, nb, nb), _randn_batch(16, nb, 4)),
            model_flops=16 * (2 * nb**3 / 3 + 2 * nb * nb * 4)),
        RoutineSpec(
            "posv_batched_distributed", "batched",
            lambda g: _on(g, lambda a, b: batched.posv_batched_distributed(
                a, b, g), _spd_batch(16, nb), _randn_batch(16, nb, 4)),
            model_flops=16 * (nb**3 / 3 + 2 * nb * nb * 4)),
    ]
    return specs


_SPECS_CACHE: Optional[List[RoutineSpec]] = None


def specs() -> List[RoutineSpec]:
    """The audit registry: one RoutineSpec per audited distributed routine."""
    global _SPECS_CACHE
    if _SPECS_CACHE is None:
        _SPECS_CACHE = build_specs()
    return _SPECS_CACHE


def spec_names() -> List[str]:
    """Names of every routine in the audit registry."""
    return [s.name for s in specs()]


def make_grid(nproc: int, device=None):
    """A ProcessGrid of ``grid_size(nproc)`` (p×q) over the running world, on
    ``device`` (``cuda`` unless asked).  With no process group a grid of one
    rank starts a world of one; a larger one needs its ranks (a launcher, or
    a :class:`~slate_tpu_torch.parallel.launch.RankPool` on the CPU)."""
    from ..core.grid import grid_size
    from ..parallel.mesh import ProcessGrid

    p, q = grid_size(nproc)
    return ProcessGrid.cached(p, q, device=device)


def run_spec(spec: RoutineSpec, grid):
    """Run one audit spec on ``grid``, counted (the collective log, the flop
    counter and the byte counter on).

    Returns ``(run, None)`` on success, else ``(None, problem)`` where
    ``problem`` is a ``{"skipped": ...}`` or ``{"error": ...}`` dict — the
    shared front half of :func:`audit_routine` and the collective auditor
    (``slate_tpu_torch.analysis.collective_audit``), so both run each routine
    in exactly the same way."""
    if spec.requires is not None and not spec.requires(grid):
        return None, {"skipped": "grid constraint "
                      "(e.g. square-grid-only algorithm)"}
    call = spec.build(grid)
    try:
        with counted() as run:
            call()
    except (ValueError, RuntimeError, TypeError, NotImplementedError) as e:
        # a row renders a routine's failure as data (its type and message);
        # every rank fails the same way, so no rank is left at a rendezvous
        return None, {"error": f"{type(e).__name__}: {e}"}
    return run, None


#: the JAX package's name: the port runs a spec where the JAX package
#: compiled it, and both tools share this front half the same way
compile_spec = run_spec


def _meta(spec: RoutineSpec, grid) -> Dict[str, Any]:
    return {"routine": spec.name, "module": spec.module, "P": grid.size,
            "grid": f"{grid.p}x{grid.q}", "model_flops": spec.model_flops}


def audit_entry(spec: RoutineSpec, grid) -> Dict[str, Any]:
    """One spec on ``grid``: ``{"row": audit row, "log": this rank's
    collective log (None when the spec was skipped or failed)}``."""
    run, problem = run_spec(spec, grid)
    if problem is not None:
        return {"row": dict(_meta(spec, grid), **problem), "log": None}
    return {"row": dict(harvest(run), **_meta(spec, grid)), "log": list(run.log)}


def audit_routine(spec: RoutineSpec, grid) -> Dict[str, Any]:
    """Run one routine on ``grid`` and harvest this rank's counts.

    Returns the :func:`costaudit.harvest` dict extended with routine/grid
    metadata, or the metadata with ``skipped``/``error`` when the spec does
    not apply or fails."""
    return audit_entry(spec, grid)["row"]


def rank_pass(nproc: int, names: Optional[Sequence[str]] = None,
              device=None) -> List[Dict[str, Any]]:
    """Every rank's job: each spec (or the named ones) once on the
    ``nproc``-rank grid, as :func:`audit_entry` gives it."""
    grid = make_grid(nproc, device)
    return [audit_entry(spec, grid) for spec in specs()
            if not names or spec.name in names]


def rank_passes(nproc: int, names: Optional[Sequence[str]] = None, device=None,
                pool=None) -> List[List[Dict[str, Any]]]:
    """:func:`rank_pass` on every rank of an ``nproc``-rank world; one list
    per rank.  In this process for a world of one (``device`` cuda unless
    asked) or under a launcher whose world has ``nproc`` ranks; otherwise on
    the CPU through ``pool`` or a new gloo :class:`RankPool`."""
    import torch.distributed as dist

    from ..core.exceptions import SlateError
    from ..core.matrix import resolve_device
    from ..parallel.launch import RankPool

    launched = dist.is_initialized() or "WORLD_SIZE" in os.environ
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", "1"))
    if (launched and world == nproc) or (not launched and nproc == 1):
        mine = rank_pass(nproc, names, device)
        if world == 1:
            return [mine]
        everyone = [None] * world
        dist.all_gather_object(everyone, mine)
        return everyone
    if resolve_device(device).type != "cpu":
        raise SlateError(f"an audit at P={nproc} on {resolve_device(device)} needs "
                         f"{nproc} ranks from a launcher (torchrun); pass "
                         "device='cpu' for a pool of gloo ranks")
    if pool is not None and pool.world == nproc:
        return pool.run(rank_pass, nproc, names, "cpu")
    with RankPool(nproc) as own:
        return own.run(rank_pass, nproc, names, "cpu")


def check_pins(rows: Sequence[Dict[str, Any]], pins: Dict[str, Any]
               ) -> List[str]:
    """Diff audited rows against a pins document; returns the list of
    regressions (empty = gate passes).  The JAX package's semantics: a
    routine that is audited-but-unpinned is itself a failure, so a shrunk or
    partially regenerated pin file cannot let the gate pass vacuously."""
    bad: List[str] = []
    nproc = int(pins.get("P", 2))
    slack = float(pins.get("bytes_slack", 1.25))
    cslack = int(pins.get("count_slack", 2))
    pinned = pins.get("routines", {})
    fresh = {r["routine"]: r for r in rows if r.get("P") == nproc}
    for name, pin in sorted(pinned.items()):
        row = fresh.get(name)
        if row is None:
            bad.append(f"{name}: pinned but missing from the audit registry")
            continue
        if row.get("error") or row.get("skipped"):
            bad.append(f"{name}: audit failed: "
                       f"{row.get('error') or row.get('skipped')}")
            continue
        if row["collective_bytes"] > slack * pin["collective_bytes"]:
            bad.append(f"{name}: collective bytes {row['collective_bytes']} "
                       f"> {slack} x pinned {pin['collective_bytes']}")
        if row["collective_count"] > pin["collective_count"] + cslack:
            bad.append(f"{name}: collective sites {row['collective_count']} "
                       f"> pinned {pin['collective_count']} + {cslack}")
    for name in sorted(set(fresh) - set(pinned)):
        row = fresh[name]
        if row.get("skipped"):
            continue          # grid-constrained at this P — nothing to pin
        if row.get("error"):
            # --update-pins drops error rows, so "unpinned" would point at
            # the wrong remedy: surface the failure itself
            bad.append(f"{name}: audit failed: {row['error']}")
            continue
        bad.append(f"{name}: audited but unpinned "
                   "(run python -m slate_tpu_torch.obs.scaling --update-pins "
                   "--device cpu)")
    return bad


def audit_all(nprocs: Sequence[int] = (2, 4, 8),
              names: Optional[Sequence[str]] = None,
              progress: Optional[Callable[[Dict[str, Any]], None]] = None,
              device=None, pool=None) -> List[Dict[str, Any]]:
    """Audit every routine spec at every requested rank count (rank 0's
    rows; see :func:`rank_passes` for where each P runs).  Rows carrying
    ``error``/``skipped`` keys mark non-applicable combinations."""
    rows = []
    for nproc in nprocs:
        for entry in rank_passes(nproc, names, device, pool)[0]:
            rows.append(entry["row"])
            if progress is not None:
                progress(entry["row"])
    return rows


def pins_doc(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The pins document of the P = 2 rows (error and skipped rows are left
    out)."""
    nproc = 2
    return {"P": nproc, "audit_n": AUDIT_N, "audit_nb": AUDIT_NB,
            "bytes_slack": 1.25, "count_slack": 2,
            "routines": {r["routine"]: {"collective_bytes": r["collective_bytes"],
                                        "collective_count": r["collective_count"],
                                        "flops": r["flops"]}
                         for r in sorted(rows, key=lambda r: r["routine"])
                         if r.get("P") == nproc and not r.get("error")
                         and not r.get("skipped")},
            "schema": PINS_SCHEMA}


def load_pins() -> Dict[str, Any]:
    with open(PINS_PATH, encoding="utf-8") as f:
        return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m slate_tpu_torch.obs.scaling",
        description="Run the scaling audit at P=2 (a pool of gloo ranks with "
                    "--device cpu, a launcher's ranks on the card); check or "
                    "rewrite the pins.")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero when the rows break scaling_pins.json")
    ap.add_argument("--update-pins", action="store_true",
                    help="rewrite scaling_pins.json from the rows")
    ap.add_argument("--device", default=None,
                    help="device of the grid (default cuda, which needs two "
                         "ranks from a launcher; the pins are taken with "
                         "--device cpu)")
    args = ap.parse_args(argv)

    def progress(row):
        status = row.get("error") or row.get("skipped") or (
            f"{row['collective_count']} collectives, {row['collective_bytes']} B, "
            f"{row['flops']:.0f} flops (model {row['model_flops']:.0f})")
        print(f"P={row['P']} {row['routine']:28s} {status}", flush=True)

    rows = audit_all((2,), progress=progress, device=args.device)
    if args.update_pins:
        with open(PINS_PATH, "w", encoding="utf-8") as f:
            json.dump(pins_doc(rows), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {PINS_PATH}")
    elif args.check:
        bad = check_pins(rows, load_pins())
        for line in bad:
            print(f"PIN {line}")
        print(f"scaling pins: {len(bad)} regression(s)")
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
