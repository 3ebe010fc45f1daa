#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``slate_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failed check:

1. header: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, the float32 matmul flags (TF32 must be off), and the build of the
   CUDA kernels from ``slate_tpu_torch/csrc/``;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   for every op, mask mode and unit-diagonal setting, in f32 and f64, at
   16384^2, the ragged test shapes, 131072 x 64 and 64 x 70000, on an
   odd-width view with NaN beyond its width (the 16-byte-load variant) and on
   an unaligned view (the 1-element variant), with the variant kernel_plan
   chose; two calls on one input must agree bitwise;
3. timings at 16384^2 (f32, and f64 for col_reduce sum and row_sums): each
   kernel and the one PyTorch call that computes the same function (timed as a
   yardstick, never used by the port) in interleaved rounds (kernel, library,
   library, kernel), median and spread of each and their ratio, the plain
   version, and the bound of an H100 SXM for the same work;
4. checks on small inputs: the solve against numpy, the card against the
   port's CPU path, ``info`` codes, and that the library Cholesky on the card
   reads only the lower triangle;
5. the main path at full width: the blocked SPD solve (``posv``, Tiled
   ``potrf``, nb=2048) of a 16384^2 f32 system with 10 right-hand sides, its
   norm-checked backward error (<= 50 eps sqrt(n)) and condition estimates,
   with the kernels' launch counters set to 0 just before and read just after;
6. the general solvers at full width, the second main path, with the counters
   set to 0 just before and read just after: ``gesv`` of a 16384^2 f32 system
   (10 right-hand sides, partial pivoting) with its backward error, one- and
   inf-norm ``gecondest`` and a singular copy; CALU ``getrf`` at 16384^2
   (nb = ib = 2048) with the tournament and the pp panel, checked by probe
   vectors; ``gels_cholqr`` and ``gels_qr`` at 131072 x 4096 f32 (16
   right-hand sides) under the tester's normal-equations gate; ``posv_mixed``
   and ``gesv_mixed`` at 16384^2 f64 (an f32 factor);
7. at n = 4096 f64: ``gesv_nopiv``, ``gesv_rbt``, both GMRES-IR solvers,
   ``getri``, the minimum-norm ``gels``, and one forced escalation per
   escalation ladder (a zero pivot from a FaultPlan);
8. at n = 512 f64: every new routine on the card against the port's CPU path
   (solutions to 1e-10, ``info`` codes);
9. the serving path (``slate_tpu_torch.serve``) at the JAX package's serving
   configuration, with the kernels' launch counters set to 0 just before and
   read just after (the serve path launches neither norm kernel: its verdicts
   are ``info`` and ``isfinite``): ``start_batched`` of each routine at batch
   32, bucket 64 (gels 128 x 64) under ``torch.cuda.set_sync_debug_mode
   ("error")`` — the launch half never waits for the card; 1200 mixed
   requests through the default ``BucketPolicy`` at one executor (solves/s,
   p50/p99, warm-up, zero misses after it); 900 requests at 1, 2 and 4
   executors and at 2 executors in continuous mode; the continuous-vs-flush
   A/B; the chaos checks (a zero pivot recovered element-wise, a worker
   crash rerouted at 2 executors under a 40-request burst); 48 requests
   handed in as tensors already on the card (submit normalization and the
   packer under ``set_sync_debug_mode("error")``: the operands never visit
   the host; ``solve_many`` and a ``ServeQueue`` of them against the numpy
   route); and 96 requests on the card against the CPU (backward errors
   within the f32 gate, ``info`` equal);
10. the eigenvalue and SVD family (``eig``), with the kernels' launch counters
    set to 0 just before the full-width steps and read just after (the path
    launches neither norm kernel: heev scales by an inline max): ``heev``
    values and vectors and ``svd_vals`` at n = 16384 f32, each timed on a
    cold and then a warm call (ascending order, the trace and sum-of-squares
    checks, the tester's eigenvector gate, Sigma sigma^2 against ||A||_F^2,
    each warm step's GFLOP/s on bench.py's models), the
    two-stage values (pipelined chase) of ``heev`` and ``svd`` at n = 8192
    against the fused values of the same matrix, with the he2hb / hb2st /
    sterf and ge2tb / bdsqr phase split (tracing on for those two calls, so
    each phase ends in a device sync); then, outside the counted run, the
    library SVD's values under its two drivers at n = 4096, the two-stage
    ``heev`` vectors (stedc), ``heev_range`` (k = 64 from the middle),
    ``eig_count`` on a gap-centred interval, ``hegv``, ``svd`` vectors fused
    and two-stage, ``svd_range``, ``pbsv`` / ``gbsv`` (kd = kl = ku = 64) and
    ``hesv`` at n = 4096 f32, ``MethodEig.QR`` and ``Bisection`` at n = 512
    f64 (with their phase split: steqr's sweep runs on the host), every new routine on the card against the CPU at n = 256 f64
    (values and both chases' (d, e) to 1e-10, vectors sign-free, ``info``
    equal), and the phase's peak device memory;
11. the tester entry point (``python -m slate_tpu_torch.testing``), with the
    kernels' launch counters set to 0 just before and read just after: its
    ``main(["all", "--quick", "--type", "s,d", "--device", "cuda"])`` (152
    rows, every one must pass), then ``posv``, ``gesv``, ``norm`` and ``gesv_f64ir`` at
    n = 16384 f32 (nb 2048, best of 3; the norm row must launch both
    kernels) and ``gecondest`` at n = 4096 through ``run_sweep``; then,
    outside the counted run, matgen's random kinds at 16384^2 f32 (seconds,
    peak memory, four tiles against the CPU port's ``generate_tile``: bit for
    bit, randn within RANDN_TILE_ULP) and ``poev_geo`` at 4096 against its
    spectrum, ``gemm_f64emu`` at 4096^2 f64 against the f64 matmul (< 1e-12,
    the JAX package's bound), and the LAPACK-style API at n = 2048 (sgesv,
    dposv, sgels, ssyev, sgesvd, slange against numpy, a singular sgesv with
    ``info`` > 0);
12. the distributed tier (``slate_tpu_torch.parallel``) on a 1x1 grid over a
    NCCL process group of one rank (one card: real process group, real
    collectives, every distributed code path), with the kernels' launch
    counters set to 0 just before and read just after: ``posv_distributed``
    and ``potrf_pipelined`` at 16384^2 f32 (nb 2048), ``gesv_distributed`` at
    16384^2 f32 (10 right-hand sides), ``gemm_allgather`` and ``gemm_ring`` at
    16384^2 f32, ``gels_cholqr_distributed`` and ``tsqr_distributed`` at
    131072 x 4096 f32 (16 right-hand sides), ``geqrf_distributed`` at 8192^2,
    ``posv_mixed_distributed`` at 16384^2 f64, ``norm_distributed`` (one, inf,
    max, fro) at 16384^2 f32 (that step must launch both kernels),
    ``getri_distributed`` and ``potri_distributed`` at 4096^2 f64 and
    ``gesv_batched_distributed`` at the serving configuration (batch 32,
    bucket 64); each step's seconds beside the single-device port's on the
    same input, its error under the single-device phase's gate, its
    agreement with the single-device port, the grid, the world size and the
    phase's peak device memory;
13. the second half of the distributed tier on a 1x1 NCCL grid, with the
    kernels' launch counters set to 0 just before and read just after (both
    must launch: the drivers' scaling and every gate's norm come from
    ``norm_distributed``): ``heev_distributed`` values and
    ``svd_distributed`` values at n = 8192 f32 (nb 64, phase 10's two-stage
    configurations and matrices: the trace and sum-of-squares gates and the
    distance from phase 10's single-device two-stage values within
    50 eps sqrt(n) ||A||_2); at n = 4096 f32 ``heev_distributed`` with
    vectors (stedc) and again with ``chase_distributed=True``,
    ``heev_range_distributed`` and ``svd_range_distributed`` (k = 64),
    ``svd_distributed`` with vectors, ``hegv_distributed``, and
    ``pbsv_distributed`` / ``gbsv_distributed`` (kd = kl = ku = 64) and
    ``hesv_distributed`` under phase 10's small-step gates; at n = 512 f64
    ``MethodEig.QR`` (steqr on the rows, 100 n eps) and bisection.  Each
    step's seconds beside phase 10's single-device seconds on the same
    matrix, the phase's wall time and peak device memory;
14. the host runtime and the ScaLAPACK API, with the kernels' launch counters
    set to 0 just before and read just after (both must launch, and each from
    ``pslange`` one / inf on both routes): the native runtime must be the
    compiled library (``native.backend() == "native"``); its owner maps,
    local tiles and redistribution plans at 2048^2 tiles on 8x4 and 4x8 grids
    in both orders equal the Python versions exactly (both timed); a
    MemoryPool cycle of 65,536 blocks rejects a double free; phase 1's posv
    under ``trace.on()`` with pool tracking on (native regions equal to the
    ``trace_block`` regions, the native dump parsed as chrome-trace JSON, the
    tracked storages leak-free, the backward error, the tracing overhead);
    ``save_matrix`` / ``load_matrix`` of the 16384^2 f32 matrix through a
    temporary directory (bit-equal, GB/s) and ``print_matrix`` at verbose 2
    against the CPU copy's text; then each p* call with no grid and on a 1x1
    NCCL grid (the distributed bodies): psgemm, pslange (one, inf, fro, max),
    psposv, psgesv and psgetrf at 16384 f32, psgels at 131072 x 4096 (its
    forward error against an f64 normal-equations solution), pdgetri / pdgecon / pdpotri / pdpocon at 4096 f64, pssyev (vectors),
    pssyevd (values) and psgesvd at 4096 f32 — each route's seconds, its
    host<->device copy share, its error under its gate and the two routes'
    agreement;
15. the cost audit and the analysis tier on a 1x1 NCCL grid, with the
    kernels' launch counters set to 0 just before and read just after
    (``col_reduce`` must launch: the ``norm_distributed`` spec):
    ``obs.scaling.rank_passes(1)``, the scaling registry's 31 specs at n =
    128, nb = 32, counted once (collective log, flop counter, byte counter;
    one ``audit_row`` line each, none may fail or count no flops), the
    collective auditor over every spec's log of that pass
    (``analysis.collective_audit.audit_pass``, no finding), ``python -m
    slate_tpu_torch.analysis --check`` in process (rc 0), and
    ``gemm_allgather``, ``potrf_distributed`` and ``getrf_distributed``
    at 16384^2 f32, nb 2048: counted flops over the spec's flop model
    within ``AUDIT["flop_tol"]`` of ``AUDIT["flop_ratio"]``, the LAPACK ops
    of ``AUDIT["lapack_ops"]`` counted, and the wall time counted over
    uncounted;
16. the C API (``slate_tpu_torch/csrc/slate_c_api.cpp`` over
    ``slate_tpu_torch/c_api.py``), with the kernels' launch counters set to 0
    just before and read just after: ``tests/c_api_check.c``,
    ``examples/c/ex05_blas.c`` and ``examples/c/example_gesv.c`` compiled
    with gcc against the port's library and run on cuda (every check ``ok``,
    ``grid-posv`` skipped on one rank), ``examples_torch/run_tests.py
    --device cuda`` (19/19, six at a time), then through the same library
    loaded in this process: ``slate_sposv`` on the posv main path's matrix,
    ``slate_sgesv`` and ``slate_sgemm`` at 16384 f32 (backward error, the
    factor and the kept triangle, 1e-5 of the float64 product) and
    ``slate_dlange`` '1', 'i', 'f', 'm' at 16384^2 f64 (1e-12 of float64; '1'
    must launch ``col_reduce`` and 'i' ``row_sums``), each C call beside the
    Python p* call it wraps on the same matrix, their ratio the boundary's
    cost; the path's launches are the C calls' own.  Also timed: three ways
    of writing a row-major 1 GiB result into a column-major host buffer;
17. the blocked LU with one-panel lookahead (``linalg/lu.py::_getrf_tiled``)
    and its pivot kernels (``slate_tpu_torch/csrc/pivots.cu``): the row-move
    lists of ``pivot_moves`` against the plain version, bit for bit, for
    panels of 1 to 4096 columns (self swaps, repeated targets, a last square
    panel), each applied to a permutation against ``_ipiv_perm``'s host
    replay; ``move_rows`` against the plain version, bit for bit, in f32,
    f64, c128 and int64 on an unaligned column range and on a vector; both
    kernels timed at the HPL cell's shapes (N = 49152 f64, nb 256, 512 and
    1024) beside their bounds, and ``move_rows`` held bit for bit at that
    shape too (2048 f64 pairs over the 49152 x 47104 trailing columns of the
    first step at nb 1024, and the perm vector); ``getrf_panel`` (cuSOLVER's
    getrf called directly) against ``torch.linalg.lu_factor_ex`` on a 16384 x
    1024 panel in f32, f64, c64 and c128 (equal pivots, factor within 20 eps
    sqrt(m)); the lookahead route's private copy and NaN guard
    (``copy_scan_nan``, ``guard_lost_nan``) against their plain versions and
    ``lu._mark_lost_nan``, bit for bit, in f32, f64, c64 and c128 over six
    layouts and eight NaN cases, and at 49152² f64 clean and with a NaN the
    factor lost (``info`` names its column); ``copy_scan_nan`` timed beside
    ``clone`` and its bound there, and the guard's early exit on a clean
    factor; ``getrf`` and ``gesv`` on the lookahead route under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync; ``perm`` and
    ``info`` stay on the card); the lookahead route against the library
    route at N = 4096 (Target.Tiled) and 49152 (Target.Auto, the route and
    panel width the HPL cell takes) f64 (probe error of A[perm] = L U under
    20 eps sqrt(N), equal ``info``; also on a singular and a NaN matrix at
    4096), the factor time of both routes at N = 2048 ... 49152
    with the panel width ``Target.Auto`` takes (the crossover
    ``LU_LOOKAHEAD_MIN``), the panel-width sweep at 49152 (256 ... 1024),
    the route ``Target.Auto`` takes there, the peak memory and the launch
    counts.
    ``python3 chip_smoke.py --only lu`` runs the header and this phase alone.

The last lines are a JSON line of per-kernel numbers, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import slate_tpu_torch as slate
from slate_tpu_torch import serve
from slate_tpu_torch.linalg import chol
from slate_tpu_torch.linalg import eig as leig
from slate_tpu_torch.linalg import lu as llu
from slate_tpu_torch.core.types import Target
from slate_tpu_torch.serve import executor as sexec
from slate_tpu_torch.serve import queue as squeue
from slate_tpu_torch.ops import cuda_norms as cn
from slate_tpu_torch.ops import cuda_pivots as cp
from slate_tpu_torch.robust import first_bad_index_batched
from slate_tpu_torch.utils import trace

# the module (the package binds the name "svd" to the driver function)
lsvd = importlib.import_module("slate_tpu_torch.linalg.svd")

N = 16384            # the potrf / norm bench size (bench.py:284,461)
NB = 2048            # the Tiled potrf block (bench.py:304)
NRHS = 10            # the tester's default (testing/routines.py:297)
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): the HBM rate is the one kernel_plan's
# bound uses; the float32 / float64 rates are those outside the tensor cores
# (the norms do abs + add / max per element)
HBM_BYTES_PER_S = cn.HBM_BYTES_PER_S
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

MODES = (cn._MODE_GE, cn._MODE_LOWER, cn._MODE_UPPER, cn._MODE_LOWER_STRICT,
         cn._MODE_UPPER_STRICT)
# kernel vs plain: a max is exact; sums differ only in summation order
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
ROUNDS = 5           # interleaved timing rounds (kernel, library, library, kernel)
# the main path's shapes (A, and R and X of B - A X), the tester path's (the quick
# sweep's 64² and 96² norm and gecondest rows, gecondest at 4096²), the ragged
# test shapes, and tall-skinny / short-wide inputs that split the reduced dimension;
# every configuration the paths launch is checked again after them (path_shapes_phase)
KERNEL_SHAPES = [(N, N), (N, NRHS), (64, 64), (96, 96), (4096, 4096), (5, 3), (1, 129),
                 (257, 131), (8, 8), (300, 200), (3, 200), (131072, 64), (64, 70000)]

REPLACES = {
    "col_reduce": "slate_tpu/ops/pallas_norms.py:202",
    "row_sums": "slate_tpu/ops/pallas_norms.py:243",
}
SOURCE = "slate_tpu_torch/csrc/norms.cu"


def say(key: str, value) -> None:
    print(f"{key}: {value}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(device):
    """A ``step(name, fn)`` that runs ``fn``, ends it in a device sync on the
    card, and records its host seconds in the returned ``times``."""
    times = {}

    def step(name, fn):
        t0 = time.perf_counter()
        r = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return r
    return times, step


# ---------------------------------------------------------------------------
# the slice's main path, through the public API (any device)
# ---------------------------------------------------------------------------


def main_path(A: torch.Tensor, B: torch.Tensor, nb: int) -> dict:
    """Blocked SPD solve with the tester's acceptance check and the condition
    estimates ex07 takes: posv (Tiled potrf + potrs), R = B - A X by gemm, the
    backward error from Frobenius norms, the one/inf/max norms and colNorms of
    A, trcondest of the factor and pocondest, and a non-SPD solve that must
    report info > 0.  Returns the numbers and the host time of each step (each
    step ends in a device synchronisation)."""
    n = A.shape[-1]
    opts = {"target": "tiled", "block_size": nb}
    out, (times, step) = {}, _timed(A.device)
    Aw = slate.HermitianMatrix.from_array("lower", A, nb=nb)
    X, info = step("posv_s", lambda: slate.posv(Aw, slate.Matrix.from_array(B, nb=nb),
                                                opts))
    out["info"] = int(info)
    R = step("residual_s", lambda: slate.gemm(-1.0, A, X, 1.0,
                                              slate.Matrix.from_array(B, nb=nb)))
    r_fro, a_fro, x_fro = step("fro_norms_s", lambda: [
        float(slate.norm("fro", M)) for M in (R, A, X)])
    eps = torch.finfo(A.dtype).eps
    out.update(r_fro=r_fro, a_fro=a_fro, x_fro=x_fro,
               backward_error=r_fro / (a_fro * x_fro),
               backward_tol=50.0 * eps * math.sqrt(n))
    out["one"], out["inf"], out["max"] = step("norms_s", lambda: [
        float(slate.norm(which, A)) for which in ("one", "inf", "max")])
    colmax = step("col_norms_s", lambda: slate.col_norms("max", A))
    out["col_norms_max"] = float(colmax.max())
    out["col_norms_min"] = float(colmax.min())
    L = torch.tril(Aw.array)
    out["trcondest"] = step("trcondest_s", lambda: float(
        slate.trcondest(slate.TriangularMatrix.from_array("lower", L, nb=nb))))
    out["pocondest"] = step("pocondest_s", lambda: float(
        slate.pocondest(L, slate.norm("one", A))))
    del L, Aw, R
    bad = A.clone()
    bad[n // 2, n // 2] = -1.0
    out["non_spd_info"] = step("non_spd_posv_s", lambda: int(
        slate.posv(bad, B, opts, uplo="lower")[1]))
    out["X"] = X
    out["times"] = times
    return out


def check_main_path(res: dict, n: int) -> None:
    require(res["info"] == 0, f"posv info {res['info']} != 0")
    require(res["backward_error"] <= res["backward_tol"],
            f"backward error {res['backward_error']} > {res['backward_tol']}")
    require(torch.isfinite(res["X"]).all().item(), "non-finite solution")
    require(res["non_spd_info"] > 0, "non-SPD matrix reported info 0")
    require(0 < res["trcondest"] <= 1 and 0 < res["pocondest"] <= 1,
            "condition estimates out of (0, 1]")
    require(res["max"] <= res["one"] and res["max"] <= res["inf"]
            and res["col_norms_max"] == res["max"], "norms disagree")


def spd(n: int, gen: torch.Generator, device, dtype) -> torch.Tensor:
    """M M^T / n + 2 I (bench.py:285-289)."""
    M = torch.randn((n, n), generator=gen, device=device, dtype=dtype)
    A = torch.matmul(M, M.T).div_(n)
    A.diagonal().add_(2.0)
    return A


# ---------------------------------------------------------------------------
# the general solvers (LU, least squares, mixed precision), through the public
# API (any device)
# ---------------------------------------------------------------------------

# full width: gesv / CALU at the getrf bench size and blocking (bench.py:329-353),
# least squares at the gels bench shape (bench.py:376-391), the mixed solves at
# n = 16384 f64; the ladder checks at n = 4096
GENERAL = {"n": N, "nrhs": NRHS, "calu_nb": 2048, "calu_ib": 2048,
           "ls_m": 131072, "ls_n": 4096, "ls_nrhs": 16, "mixed_n": N}
SMALL_N = 4096
CHECK_N = 512
PROBES = 4
# each ladder run by run_ladder, and the fault site that breaks its first rung
LADDER_CASES = (("gesv_nopiv", "getrf_nopiv", "dominant"),
                ("gesv_mixed", "gesv_mixed", "general"),
                ("posv_mixed", "posv_mixed", "spd"),
                ("gesv_rbt", "getrf_nopiv", "general"))


def randn(shape, dtype, device, seed: int) -> torch.Tensor:
    """Standard normal data from a generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def gate(dtype, n: int) -> float:
    """The tester's accept threshold, 50 eps sqrt(n) (testing/routines.py:75-79)."""
    return 50.0 * torch.finfo(dtype).eps * math.sqrt(n)


def fro(M) -> float:
    """Frobenius norm through ``slate.norm`` (the col_reduce kernel on the card)."""
    return float(slate.norm("fro", M))


def backward_error(A, X, B) -> float:
    """||B - A X||_F / (||A||_F ||X||_F), the residual by gemm
    (testing/routines.py:342-355)."""
    R = slate.gemm(-1.0, A, X, 1.0, B)
    return fro(R) / (fro(A) * fro(X))


def ls_residual(A, X, B) -> float:
    """The tester's normal-equations residual ||A^H (A X - B)|| / (||A||^2 ||X||)
    (testing/routines.py:537-549)."""
    R = torch.matmul(A, X).sub_(B)
    return fro(torch.matmul(A.mH, R)) / (fro(A) ** 2 * max(fro(X), 1e-10))


def general_path(device, sizes: dict = GENERAL) -> dict:
    """The general solvers at the widths in ``sizes`` on ``device``: gesv with
    its backward error, condition estimates and a singular copy; CALU getrf
    with both panel schemes, checked by probe vectors; gels_cholqr and gels_qr
    under the tester's gate; posv_mixed and gesv_mixed in f64.  Every step ends
    in a device synchronisation; returns the numbers, each step's host time,
    and each factorization's pivot-conversion time (the ``pivots`` phase)."""
    out, (times, step) = {}, _timed(device)
    f32, f64 = torch.float32, torch.float64
    n, k = sizes["n"], sizes["nrhs"]

    A = randn((n, n), f32, device, SEED + 10)
    B = randn((n, k), f32, device, SEED + 11)
    Aw = slate.Matrix.from_array(A)               # getrf writes its factor here
    X, perm, info = step("gesv_s", lambda: slate.gesv(Aw, B))
    out["gesv_pivots_s"] = trace.last_phases("getrf")["pivots"]
    out["gesv_info"] = int(info)
    out["gesv_backward_error"] = step("gesv_residual_s", lambda: backward_error(A, X, B))
    LU = Aw.array
    for kind in ("one", "inf"):
        out[f"gecondest_{kind}"] = step(f"gecondest_{kind}_s", lambda: float(
            slate.gecondest(LU, perm, slate.norm(kind, A), norm_kind=kind)))
    del Aw, LU, X
    sing = A.clone()
    sing[:, n // 3] = 0.0
    out["singular_gesv_info"] = step("singular_gesv_s",
                                     lambda: int(slate.gesv(sing, B)[2]))
    del sing

    a_fro = fro(A)
    V = randn((n, PROBES), f32, device, SEED + 12)
    AV = torch.matmul(A, V)
    for panel in ("tournament", "pp"):
        opts = {"method_lu": "calu", "block_size": sizes["calu_nb"],
                "inner_blocking": sizes["calu_ib"], "lu_panel": panel}
        LU, perm, info = step(f"calu_{panel}_s", lambda: slate.getrf(A, opts))
        out[f"calu_{panel}_pivots_s"] = trace.last_phases("getrf_tntpiv")["pivots"]
        out[f"calu_{panel}_info"] = int(info)
        out[f"calu_{panel}_is_permutation"] = bool(torch.equal(
            torch.sort(perm).values, torch.arange(n, device=perm.device)))
        Uv = torch.matmul(torch.triu(LU), V)
        LUv = torch.matmul(torch.tril(LU, -1), Uv).add_(Uv)
        D = AV[perm].sub_(LUv)
        out[f"calu_{panel}_probe_error"] = max(
            fro(D[:, j:j + 1]) / (a_fro * fro(V[:, j:j + 1])) for j in range(PROBES))
        del LU, Uv, LUv, D
    del A, B, V, AV

    m, ln, lk = sizes["ls_m"], sizes["ls_n"], sizes["ls_nrhs"]
    A = randn((m, ln), f32, device, SEED + 13)
    B = randn((m, lk), f32, device, SEED + 14)
    for name in ("gels_cholqr", "gels_qr"):
        X = step(f"{name}_s", lambda: getattr(slate, name)(A, B))
        out[f"{name}_residual"] = ls_residual(A, X, B)
        del X
    del A, B

    nm = sizes["mixed_n"]
    B = randn((nm, k), f64, device, SEED + 15)
    S = spd(nm, torch.Generator(device=device).manual_seed(SEED + 16), device, f64)
    X, info, iters, rep = step("posv_mixed_s", lambda: slate.posv_mixed(
        S, B, {"solve_report": True}))
    out.update(posv_mixed_info=int(info), posv_mixed_iters=int(iters),
               posv_mixed_chain=rep.fallback_chain,
               posv_mixed_backward_error=backward_error(S, X, B))
    del S, X
    G = randn((nm, nm), f64, device, SEED + 17)
    X, perm, info, iters, rep = step("gesv_mixed_s", lambda: slate.gesv_mixed(
        G, B, {"solve_report": True}))
    out.update(gesv_mixed_info=int(info), gesv_mixed_iters=int(iters),
               gesv_mixed_chain=rep.fallback_chain,
               gesv_mixed_pivots_s=trace.last_phases("gesv_mixed")["pivots"],
               gesv_mixed_backward_error=backward_error(G, X, B))
    out["times"] = times
    return out


def check_general_path(res: dict, sizes: dict = GENERAL) -> None:
    n, f32, f64 = sizes["n"], torch.float32, torch.float64
    require(res["gesv_info"] == 0, f"gesv info {res['gesv_info']}")
    require(res["gesv_backward_error"] <= gate(f32, n),
            f"gesv backward error {res['gesv_backward_error']} > {gate(f32, n)}")
    for kind in ("one", "inf"):
        require(0 < res[f"gecondest_{kind}"] <= 1, f"gecondest {kind} out of (0, 1]")
    require(res["singular_gesv_info"] > 0, "a zero column reported info 0")
    for panel in ("tournament", "pp"):
        require(res[f"calu_{panel}_info"] == 0, f"CALU {panel} info")
        require(res[f"calu_{panel}_is_permutation"], f"CALU {panel} perm")
        require(res[f"calu_{panel}_probe_error"] <= gate(f32, n),
                f"CALU {panel} probe error {res[f'calu_{panel}_probe_error']}")
    ls_gate = 100.0 * gate(f32, max(sizes["ls_m"], sizes["ls_n"]))
    for name in ("gels_cholqr", "gels_qr"):
        require(res[f"{name}_residual"] <= ls_gate,
                f"{name} residual {res[f'{name}_residual']} > {ls_gate}")
    for name in ("posv_mixed", "gesv_mixed"):
        require(res[f"{name}_info"] == 0, f"{name} info")
        require(res[f"{name}_chain"] == ("mixed",), f"{name} chain {res[f'{name}_chain']}")
        require(res[f"{name}_backward_error"] <= gate(f64, sizes["mixed_n"]),
                f"{name} backward error {res[f'{name}_backward_error']}")


def small_general(device, n: int = SMALL_N) -> dict:
    """The remaining general solvers at n in f64: gesv_nopiv (diagonally
    dominant), gesv_rbt, both GMRES-IR solvers (one right-hand side), getri,
    the minimum-norm gels, and one forced escalation per ladder."""
    out, (times, step) = {}, _timed(device)
    f64 = torch.float64
    mats = {"dominant": randn((n, n), f64, device, SEED + 20),
            "general": randn((n, n), f64, device, SEED + 21),
            "spd": spd(n, torch.Generator(device=device).manual_seed(SEED + 22), device, f64)}
    mats["dominant"].diagonal().add_(float(n))
    B = randn((n, NRHS), f64, device, SEED + 23)
    b1 = B[:, :1].clone()

    X, _, info, rep = step("gesv_nopiv_s", lambda: slate.gesv_nopiv(
        mats["dominant"], B, {"solve_report": True}))
    out.update(gesv_nopiv_info=int(info), gesv_nopiv_chain=rep.fallback_chain,
               gesv_nopiv_backward_error=backward_error(mats["dominant"], X, B))
    X, info, iters, rep = step("gesv_rbt_s", lambda: slate.gesv_rbt(
        mats["general"], B, {"solve_report": True}))
    out.update(gesv_rbt_info=int(info), gesv_rbt_iters=int(iters),
               gesv_rbt_chain=rep.fallback_chain,
               gesv_rbt_backward_error=backward_error(mats["general"], X, B))
    X, _, info, restarts = step("gesv_mixed_gmres_s", lambda: slate.gesv_mixed_gmres(
        mats["general"], b1))
    out.update(gesv_mixed_gmres_info=int(info), gesv_mixed_gmres_restarts=int(restarts),
               gesv_mixed_gmres_backward_error=backward_error(mats["general"], X, b1))
    X, info, restarts = step("posv_mixed_gmres_s", lambda: slate.posv_mixed_gmres(
        mats["spd"], b1))
    out.update(posv_mixed_gmres_info=int(info), posv_mixed_gmres_restarts=int(restarts),
               posv_mixed_gmres_backward_error=backward_error(mats["spd"], X, b1))
    G = mats["general"]
    LU, perm, info = slate.getrf(G)
    inv = step("getri_s", lambda: slate.getri(LU, perm))
    eye = torch.eye(n, dtype=f64, device=G.device)
    out["getri_error"] = fro(torch.matmul(G, inv).sub_(eye)) / (fro(G) * fro(inv))
    del LU, inv, eye
    W = randn((n // 2, n), f64, device, SEED + 24)
    BW = B[: n // 2]
    X = step("gels_min_norm_s", lambda: slate.gels(W, BW))
    out["gels_min_norm_residual"] = backward_error(W, X, BW)
    # the minimum-norm solution W^H (W W^H)^{-1} B by the normal equations
    x_mn = torch.matmul(W.mH, torch.cholesky_solve(BW, torch.linalg.cholesky(
        torch.matmul(W, W.mH))))
    out["gels_min_norm_vs_normal_equations"] = fro(X - x_mn) / fro(x_mn)

    for routine, site, kind in LADDER_CASES:
        plan = slate.FaultPlan([slate.FaultSpec(site, "zero_pivot", call_index=0,
                                                index=7)])
        with plan:
            res = step(f"forced_{routine}_s", lambda: getattr(slate, routine)(
                mats[kind], B, {"solve_report": True}))
        rep = res[-1]
        out[f"forced_{routine}"] = {
            "chain": rep.fallback_chain, "recovered": rep.recovered, "info": rep.info,
            "fired": plan.fired,
            "backward_error": backward_error(mats[kind], res[0], B)}
    out["times"] = times
    return out


def check_small_general(res: dict, n: int = SMALL_N) -> None:
    g = gate(torch.float64, n)
    for name in ("gesv_nopiv", "gesv_rbt", "gesv_mixed_gmres", "posv_mixed_gmres"):
        require(res[f"{name}_info"] == 0, f"{name} info")
        require(res[f"{name}_backward_error"] <= g,
                f"{name} backward error {res[f'{name}_backward_error']} > {g}")
    require(res["gesv_nopiv_chain"] == ("nopiv",), "gesv_nopiv escalated")
    require(res["gesv_mixed_gmres_restarts"] >= 0 and res["posv_mixed_gmres_restarts"] >= 0,
            "a GMRES-IR solve fell back to full precision")
    require(res["getri_error"] <= g, f"getri error {res['getri_error']}")
    require(res["gels_min_norm_residual"] <= g, "minimum-norm gels residual")
    require(res["gels_min_norm_vs_normal_equations"] <= 1e-10,
            "gels is not the minimum-norm solution")
    for routine, site, _ in LADDER_CASES:
        r = res[f"forced_{routine}"]
        require(r["fired"] == ((site, "zero_pivot", 0),), f"{routine}: fault not fired")
        require(r["chain"] == slate.robust.LADDERS[routine] and r["recovered"]
                and r["info"] == 0, f"{routine}: forced escalation gave {r}")
        require(r["backward_error"] <= g, f"{routine}: escalated solve {r}")


def general_routines(device, n: int = CHECK_N) -> dict:
    """Every new routine on ``device`` from the same numpy-seeded f64 inputs:
    the solutions (or R / the inverse) and the info codes, for the card
    against the port's CPU path."""
    rng = np.random.default_rng(SEED + 30)

    def t(a):
        return torch.tensor(a, device=device)

    g = rng.standard_normal((n, n))
    dom = g + n * np.eye(n)
    s = g @ g.T / n + 2 * np.eye(n)
    b = rng.standard_normal((n, 3))
    tall = rng.standard_normal((2 * n, n // 2))
    btall = rng.standard_normal((2 * n, 3))
    wide, bwide = tall.T[:, : n].copy(), btall[: n // 2].copy()
    sing = dom.copy()
    sing[:, 5] = sing[5, :] = 0.0
    nan = dom.copy()
    nan[9, 9] = np.nan
    out = {}
    for target in ("xla", "tiled"):
        X, _, info = slate.gesv(t(g), t(b), {"target": target, "block_size": 64})
        out[f"gesv_{target}"], out[f"gesv_{target}_info"] = X, int(info)
    for panel in ("tournament", "pp"):
        LU, perm, info = slate.getrf(t(g), {"method_lu": "calu", "block_size": 128,
                                            "inner_blocking": 32, "lu_panel": panel})
        out[f"calu_{panel}"] = slate.getrs(LU, perm, t(b))
        out[f"calu_{panel}_info"] = int(info)
    LU, perm, _ = slate.getrf(t(g))
    for trans in ("t", "c"):
        out[f"getrs_{trans}"] = slate.getrs(LU, perm, t(b), trans=trans)
    out["getri"] = slate.getri(LU.clone(), perm)
    for kind in ("one", "inf"):
        anorm = np.abs(g).sum(0 if kind == "one" else 1).max()
        out[f"gecondest_{kind}"] = slate.gecondest(LU, perm, anorm, norm_kind=kind)
    X, _, info = slate.gesv_nopiv(t(dom), t(b))
    out["gesv_nopiv"], out["gesv_nopiv_info"] = X, int(info)
    X, _, info, _ = slate.gesv_mixed(t(g), t(b))
    out["gesv_mixed"], out["gesv_mixed_info"] = X, int(info)
    X, _, info, _ = slate.gesv_mixed_gmres(t(g), t(b[:, :1]))
    out["gesv_mixed_gmres"], out["gesv_mixed_gmres_info"] = X, int(info)
    X, info, _ = slate.posv_mixed(t(s), t(b))
    out["posv_mixed"], out["posv_mixed_info"] = X, int(info)
    X, info, _ = slate.posv_mixed_gmres(t(s), t(b[:, :1]))
    out["posv_mixed_gmres"], out["posv_mixed_gmres_info"] = X, int(info)
    X, info, _ = slate.gesv_rbt(t(g), t(b))
    out["gesv_rbt"], out["gesv_rbt_info"] = X, int(info)
    for method in ("qr", "cholqr"):
        out[f"gels_{method}"] = slate.gels(t(tall), t(btall), {"method_gels": method})
    out["gels_wide"] = slate.gels(t(wide), t(bwide))
    out["cholqr_R"] = slate.cholqr(t(tall))[1]
    out["tsqr_absR"] = slate.linalg.tsqr(t(tall), row_blocks=4)[1].abs()
    for method in ("partialpiv", "calu", "nopiv"):
        for name, bad in (("singular", sing), ("nan", nan)):
            out[f"{method}_{name}_info"] = int(slate.getrf(t(bad), {
                "method_lu": method, "block_size": 64, "inner_blocking": 16})[2])
    return out


def compare_general_routines(card: dict, host: dict) -> dict:
    """Card against CPU: tensors to 1e-10 relative (Frobenius), info codes
    identical (a NaN input's too: the card's library LU loses the NaN, and
    ``lu._mark_lost_nan`` restores it).  Returns the relative difference of
    each tensor."""
    diffs = {}
    for key, want in host.items():
        got = card[key]
        if isinstance(want, torch.Tensor):
            got = got.cpu()
            diffs[key] = float(torch.linalg.vector_norm(got - want)
                               / torch.linalg.vector_norm(want))
            require(diffs[key] <= 1e-10, f"{key}: card vs cpu {diffs[key]}")
        else:
            require(got == want, f"{key}: card {got}, cpu {want}")
    return diffs


# ---------------------------------------------------------------------------
# the eigenvalue and SVD family, through the public API (any device)
# ---------------------------------------------------------------------------

# full width: heev values and vectors and svd_vals at bench.py's BASELINE
# size (bench.py:407-417, 434-442); the two-stage values at its two-stage size
# (bench.py:636, 698) with the pipelined chase (bench.py:651, 709); subsets,
# generalized, SVD vectors and the band / indefinite solvers at n = 4096; the
# other tridiagonal methods at n = 512 f64; the card against the CPU at 256
EIG = {"n": N, "two_stage_n": 8192, "small_n": 4096, "method_n": 512,
       "check_n": 256, "range_k": 64, "band_k": 64}


def sym_normal(n: int, dtype, device, seed: int) -> torch.Tensor:
    """(M + M^T) / 2 of a seeded normal M (bench.py:407-411)."""
    M = randn((n, n), dtype, device, seed)
    return (M + M.T).mul_(0.5)


def tfro(M) -> float:
    """Frobenius norm in f64 by PyTorch (no norm kernel: the eig path's
    checks must not launch the kernels the path does not reach)."""
    return float(torch.linalg.vector_norm(M, dtype=torch.float64))


def eig_gate(A, lam, Z) -> float:
    """The tester's eigenvector check, max(||AZ - Z diag(lam)|| / ||A||,
    ||I - Z^H Z|| / n), Frobenius norms (testing/routines.py:644-660)."""
    k = Z.shape[-1]
    R = torch.matmul(A, Z).sub_(Z * lam.to(Z.dtype)[None, :])
    eye = torch.eye(k, dtype=Z.dtype, device=Z.device)
    return max(tfro(R) / tfro(A), tfro(torch.matmul(Z.mH, Z).sub_(eye)) / A.shape[-1])


def svd_gate(A, S, U, VT) -> float:
    """The tester's SVD check, max(||A - U S V^H|| / ||A||, ||I - U^H U|| / k)
    (testing/routines.py:836-851)."""
    k = S.shape[-1]
    R = torch.matmul(U * S.to(U.dtype)[None, :], VT).sub_(A)
    eye = torch.eye(k, dtype=U.dtype, device=U.device)
    return max(tfro(R) / tfro(A), tfro(torch.matmul(U.mH, U).sub_(eye)) / k)


def values_checks(A, lam, prefix: str) -> dict:
    """Ascending order, sum(lam) against tr A, sum(lam^2) against ||A||_F^2."""
    lam64 = lam.double()
    a_fro = tfro(A)
    return {f"{prefix}_ascending": bool(torch.all(lam[1:] >= lam[:-1])),
            f"{prefix}_trace_err": abs(float(lam64.sum()) - float(
                torch.diagonal(A).double().sum())) / (A.shape[-1] * a_fro),
            f"{prefix}_sumsq_err": abs(float((lam64 ** 2).sum()) - a_fro ** 2) / a_fro ** 2}


def with_phase_split(fn):
    """``fn`` run with tracing on, so the driver's timers end each phase in
    a device sync (``utils.trace.Timers``) and hold the device's phase split;
    a plain call stays asynchronous.  When tracing was off, the events the
    run recorded are dropped with it."""
    def run():
        was_on = trace.is_on()
        trace.on()
        try:
            return fn()
        finally:
            if not was_on:
                trace.off()
                trace.finish(os.devnull)
    return run


def eig_path(device, sizes: dict = EIG) -> dict:
    """The eig/SVD main path at the widths in ``sizes`` on ``device``: heev
    values and vectors and svd_vals at n, each timed cold (the first call at
    its shape: the library's workspace is allocated) and then warm, then the
    two-stage values (pipelined chase) of heev and svd at two_stage_n against
    the fused values of the same matrix, with each pipeline's phase split
    (:func:`with_phase_split` — the split bench.py:662-689 and :718-735 print).
    Every step ends in a device synchronisation; returns the numbers and
    each step's host time.  Checks use PyTorch norms, so the path launches no
    norm kernel of its own."""
    out, (times, step) = {}, _timed(device)
    f32 = torch.float32
    n = sizes["n"]
    A = sym_normal(n, f32, device, SEED + 50)
    def values():
        return slate.heev(A, uplo="lower", want_vectors=False)

    step("heev_values_cold_s", values)
    lam, _ = step("heev_values_s", values)
    out.update(values_checks(A, lam, "heev_values"))
    step("heev_vectors_cold_s", lambda: slate.heev(A, uplo="lower"))
    lam_v, Z = step("heev_vectors_s", lambda: slate.heev(A, uplo="lower"))
    out["heev_vectors_gate"] = eig_gate(A, lam_v, Z)
    out["heev_vectors_vs_values"] = float((lam_v - lam).abs().max() / lam.abs().max())
    del Z, A
    G = randn((n, n), f32, device, SEED + 51)
    step("svd_vals_cold_s", lambda: slate.svd_vals(G))
    S = step("svd_vals_s", lambda: slate.svd_vals(G))
    g_fro = tfro(G)
    out["svd_vals_sumsq_err"] = abs(float((S.double() ** 2).sum()) - g_fro ** 2) / g_fro ** 2
    out["svd_vals_descending"] = bool(torch.all(S[1:] <= S[:-1]))
    out["svd_driver"] = str(lsvd._SVD_DRIVER)
    del G

    n2 = sizes["two_stage_n"]
    A = sym_normal(n2, f32, device, SEED + 52)
    lam_f, _ = step("heev_fused_values_two_stage_n_s", lambda: slate.heev(
        A, want_vectors=False))
    lam_2, _ = step("heev_two_stage_values_s", with_phase_split(lambda: slate.heev(
        A, want_vectors=False, method="two_stage", chase_pipeline=True)))
    out["heev_two_stage_vs_fused"] = float((lam_2 - lam_f).abs().max() / lam_f.abs().max())
    out["heev_two_stage_phases"] = dict(slate.heev.timers)
    del A
    G = randn((n2, n2), f32, device, SEED + 53)
    S_f = step("svd_fused_values_two_stage_n_s", lambda: slate.svd_vals(G))
    S_2, _, _ = step("svd_two_stage_values_s", with_phase_split(lambda: slate.svd(
        G, want_u=False, want_vt=False, method="two_stage", chase_pipeline=True)))
    out["svd_two_stage_vs_fused"] = float((S_2 - S_f).abs().max() / S_f.max())
    out["svd_two_stage_phases"] = dict(slate.svd.timers)
    out["refs"] = {"heev_values": lam_2, "svd_values": S_2}
    out["times"] = times
    return out


def check_eig_path(res: dict, sizes: dict = EIG) -> None:
    f32 = torch.float32
    n, n2 = sizes["n"], sizes["two_stage_n"]
    g = gate(f32, n)
    require(res["heev_values_ascending"], "heev values not ascending")
    require(res["heev_values_trace_err"] <= 50 * torch.finfo(f32).eps,
            f"heev trace error {res['heev_values_trace_err']}")
    for key in ("heev_values_sumsq_err", "heev_vectors_gate", "svd_vals_sumsq_err"):
        require(res[key] <= g, f"{key} {res[key]} > {g}")
    require(res["heev_vectors_vs_values"] <= g, "heev vectors' values vs values-only")
    require(res["svd_vals_descending"], "singular values not descending")
    for key in ("heev_two_stage_vs_fused", "svd_two_stage_vs_fused"):
        require(res[key] <= gate(f32, n2), f"{key} {res[key]} > {gate(f32, n2)}")


def small_eig(device, sizes: dict = EIG) -> dict:
    """The rest of the family at small_n f32 (two-stage heev vectors by the
    default method, heev_range, eig_count, hegv, svd vectors fused and
    two-stage, svd_range, pbsv / gbsv / hesv) and at method_n f64 (the QR and
    Bisection methods).  Returns the numbers and each step's host time."""
    out, (times, step) = {}, _timed(device)
    f32, f64 = torch.float32, torch.float64
    n, k, kb = sizes["small_n"], sizes["range_k"], sizes["band_k"]
    A = sym_normal(n, f32, device, SEED + 60)
    lam, Z = step("heev_two_stage_vectors_s", lambda: slate.heev(
        A, method="two_stage", chase_pipeline=True))
    out["heev_two_stage_vectors_gate"] = eig_gate(A, lam, Z)
    del Z
    lam_f = slate.heev(A, want_vectors=False)[0]
    a2 = float(lam_f.abs().max())
    il = n // 2 - k // 2
    lr, Zr = step("heev_range_s", lambda: slate.heev_range(A, il=il, iu=il + k,
                                                           chase_pipeline=True))
    out["heev_range_gate"] = eig_gate(A, lr, Zr)
    out["heev_range_vs_full"] = float((lr - lam_f[il:il + k]).abs().max()) / a2
    # an interval with both ends in the middle of wide gaps of the spectrum
    gaps = lam_f[1:] - lam_f[:-1]
    j1 = n // 4 + int(torch.argmax(gaps[n // 4: n // 2]))
    j2 = n // 2 + int(torch.argmax(gaps[n // 2: 3 * n // 4]))
    vl = float(lam_f[j1] + lam_f[j1 + 1]) / 2
    vu = float(lam_f[j2] + lam_f[j2 + 1]) / 2
    out["eig_count"] = step("eig_count_s", lambda: int(slate.eig_count(A, vl, vu)))
    out["eig_count_full"] = j2 - j1
    Bs = spd(n, torch.Generator(device=device).manual_seed(SEED + 61), device, f32)
    lg, Zg = step("hegv_s", lambda: slate.hegv(1, A, Bs))
    R = torch.matmul(A, Zg).sub_(torch.matmul(Bs, Zg) * lg[None, :])
    out["hegv_residual"] = tfro(R) / ((tfro(A) + tfro(Bs) * float(lg.abs().max()))
                                      * tfro(Zg))
    del Zg, R, Bs

    G = randn((n, n), f32, device, SEED + 62)
    for method in ("fused", "two_stage"):
        S, U, VT = step(f"svd_{method}_vectors_s", lambda: slate.svd(
            G, method=method, chase_pipeline=True))
        out[f"svd_{method}_gate"] = svd_gate(G, S, U, VT)
        del U, VT
    s_max = float(S[0])
    Sr, Ur, VTr = step("svd_range_s", lambda: slate.svd_range(G, il=0, iu=k,
                                                              chase_pipeline=True))
    out["svd_range_vs_full"] = float((Sr - S[:k]).abs().max()) / s_max
    out["svd_range_residual"] = tfro(torch.matmul(G, VTr.mH).sub_(Ur * Sr[None, :])) / (
        tfro(G))
    del G, Ur, VTr

    Bn = randn((n, NRHS), f32, device, SEED + 63)
    r = torch.arange(n, device=device)
    inband = (r[:, None] - r[None, :]).abs() <= kb
    P = torch.where(inband, sym_normal(n, f32, device, SEED + 64), 0.0)
    P.diagonal().add_(2.0 * kb)          # diagonally dominant: SPD
    X, info = step("pbsv_s", lambda: slate.pbsv(torch.tril(P), Bn, kd=kb))
    out["pbsv_info"], out["pbsv_backward_error"] = int(info), backward_error(P, X, Bn)
    Gb = torch.where(inband, randn((n, n), f32, device, SEED + 65), 0.0)
    X, info = step("gbsv_s", lambda: slate.gbsv(Gb, Bn, kl=kb, ku=kb))
    out["gbsv_info"], out["gbsv_backward_error"] = int(info), backward_error(Gb, X, Bn)
    X, info = step("hesv_s", lambda: slate.hesv(A, Bn))
    out["hesv_info"], out["hesv_backward_error"] = int(info), backward_error(A, X, Bn)
    del A, P, Gb, X

    m = sizes["method_n"]
    A = sym_normal(m, f64, device, SEED + 66)
    for method in ("qr", "bisection"):
        lam, Z = step(f"heev_{method}_s", with_phase_split(lambda: slate.heev(
            A, {"method_eig": method}, method="two_stage", chase_pipeline=True)))
        out[f"heev_{method}_gate"] = eig_gate(A, lam, Z)
        out[f"heev_{method}_phases"] = dict(slate.heev.timers)
    out["times"] = times
    return out


def check_small_eig(res: dict, sizes: dict = EIG) -> None:
    f32, f64 = torch.float32, torch.float64
    n = sizes["small_n"]
    g = gate(f32, n)
    for key in ("heev_two_stage_vectors_gate", "heev_range_gate", "heev_range_vs_full",
                "hegv_residual", "svd_fused_gate", "svd_two_stage_gate",
                "svd_range_vs_full", "svd_range_residual"):
        require(res[key] <= g, f"{key} {res[key]} > {g}")
    require(res["eig_count"] == res["eig_count_full"],
            f"eig_count {res['eig_count']} != {res['eig_count_full']}")
    for name in ("pbsv", "gbsv", "hesv"):
        require(res[f"{name}_info"] == 0, f"{name} info {res[f'{name}_info']}")
        require(res[f"{name}_backward_error"] <= g,
                f"{name} backward error {res[f'{name}_backward_error']} > {g}")
    # QR iteration's envelope is the JAX package's own for steqr, 100 n eps
    # (tests/test_steqr.py:35-44): its per-sweep closed-form rotation
    # products leave ~1e-13 at n = 512 in both packages, above 50 eps sqrt(n)
    m = sizes["method_n"]
    for method, gm in (("qr", 100.0 * torch.finfo(f64).eps * m),
                       ("bisection", gate(f64, m))):
        require(res[f"heev_{method}_gate"] <= gm,
                f"heev {method} gate {res[f'heev_{method}_gate']} > {gm}")


def eig_routines(device, n: int = EIG["check_n"]) -> dict:
    """Every new routine on ``device`` from the same numpy-seeded f64 inputs:
    eigenvalues, singular values, (d, e) of both chases, vectors, solutions
    and info codes, for the card against the port's CPU path."""
    rng = np.random.default_rng(SEED + 70)

    def t(a):
        return torch.tensor(a, device=device)

    g = rng.standard_normal((n, n))
    a = (g + g.T) / 2
    s = g @ g.T / n + 2 * np.eye(n)
    b = rng.standard_normal((n, 3))
    kb = 8
    inband = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= kb
    pb = np.where(inband, a, 0.0) + 2 * kb * np.eye(n)
    gb = np.where(inband, g, 0.0)
    lam_a = np.linalg.eigvalsh(a)
    gaps = np.diff(lam_a)
    j1, j2 = n // 4 + int(np.argmax(gaps[n // 4: n // 2])), n // 2 + int(np.argmax(gaps[n // 2:]))
    vl, vu = (lam_a[j1] + lam_a[j1 + 1]) / 2, (lam_a[j2] + lam_a[j2 + 1]) / 2
    nb = leig.default_band_nb(n)
    out = {}
    for method in ("auto", "qr", "bisection"):
        lam, Z = slate.heev(t(a), {"method_eig": method}, method="two_stage",
                            chase_pipeline=True)
        out[f"heev_{method}_values"], out[f"heev_{method}_vectors"] = lam, Z
    out["heev_fused_values"], out["heev_fused_vectors"] = slate.heev(t(a))
    band = slate.he2hb(t(a))[0]
    for pipeline in (False, True):
        d, e = slate.hb2st(band, kd=nb, pipeline=pipeline)
        out[f"hb2st_{pipeline}_d"], out[f"hb2st_{pipeline}_e"] = d, e
        d, e = slate.tb2bd(slate.ge2tb_band(t(g))[0], nb, pipeline=pipeline)
        out[f"tb2bd_{pipeline}_d"], out[f"tb2bd_{pipeline}_e"] = d, e
    lam, Z = slate.heev_range(t(a), il=n // 3, iu=n // 3 + n // 8, chase_pipeline=True)
    out["heev_range_values"], out["heev_range_vectors"] = lam, Z
    out["eig_count"] = int(slate.eig_count(t(a), vl, vu))
    out["hegv_values"], out["hegv_vectors"] = slate.hegv(1, t(a), t(s))
    S, U, VT = slate.svd(t(g), method="two_stage", chase_pipeline=True)
    out["svd_two_stage_values"], out["svd_two_stage_vectors"] = S, U
    out["svd_fused_values"] = slate.svd_vals(t(g))
    S, U, VT = slate.svd_range(t(g), il=0, iu=n // 8, chase_pipeline=True)
    out["svd_range_values"], out["svd_range_vectors"] = S, U
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    for name in ("stedc", "steqr"):
        lam, Z = getattr(slate, name)(t(d), t(e))
        out[f"{name}_values"], out[f"{name}_vectors"] = lam, Z
    out["sterf_bisect_values"] = slate.sterf_bisect(t(d), t(e))
    X, info = slate.pbsv(t(np.tril(pb)), t(b), kd=kb)
    out["pbsv_x"], out["pbsv_info"] = X, int(info)
    X, info = slate.gbsv(t(gb), t(b), kl=kb, ku=kb)
    out["gbsv_x"], out["gbsv_info"] = X, int(info)
    X, info = slate.hesv(t(a), t(b))
    out["hesv_x"], out["hesv_info"] = X, int(info)
    sing = gb.copy()
    sing[:, 7] = 0.0
    out["gbtrf_singular_info"] = int(slate.gbtrf(t(sing), kl=kb, ku=kb)[1])
    bad = pb.copy()
    bad[n // 3, n // 3] = -1e3
    out["pbtrf_non_spd_info"] = int(slate.pbtrf(t(np.tril(bad)), kd=kb)[1])
    return out


def compare_eig_routines(card: dict, host: dict) -> dict:
    """Card against CPU: values and (d, e) within 1e-10 of the largest,
    vectors by the sign-free test |diag(Z_cpu^H Z_card)| >= 1 - 1e-10,
    solutions within 1e-10 relative, info codes identical."""
    diffs = {}
    for key, want in host.items():
        got = card[key]
        if not isinstance(want, torch.Tensor):
            require(got == want, f"{key}: card {got}, cpu {want}")
            continue
        got = got.cpu()
        if key.endswith("_vectors"):     # hegv's are B-orthonormal: normalize
            dots = (want.conj() * got).sum(dim=0).abs() / (
                torch.linalg.vector_norm(want, dim=0) * torch.linalg.vector_norm(got, dim=0))
            diffs[key] = float(1.0 - dots.min())
        elif key.endswith("_x"):
            diffs[key] = float(torch.linalg.vector_norm(got - want)
                               / torch.linalg.vector_norm(want))
        else:
            diffs[key] = float((got - want).abs().max() / want.abs().max())
        require(diffs[key] <= 1e-10, f"{key}: card vs cpu {diffs[key]}")
    return diffs


# ---------------------------------------------------------------------------
# the serving path (slate_tpu_torch.serve), through the public API (any device)
# ---------------------------------------------------------------------------

# the JAX package's serving configuration: the default BucketPolicy, the
# make_requests stream, 1200 requests (bench.py:755), 900 at N in {1, 2, 4}
# (bench.py:788-796), the continuous A/B's policy (bench.py:762-766)
SERVE = {"requests": 1200, "scale_requests": 900, "executor_counts": (1, 2, 4),
         "ab_requests": 300, "ab_rounds": 2, "burst": 40, "check_requests": 96,
         "device_requests": 48, "start_batch": 32, "start_n": 64}
AB_POLICY = {"dims": (16, 32), "nrhs_dims": (1, 4), "batch_dims": (1, 4, 16),
             "max_batch": 16}


def _start_operands(routine: str, batch: int, n: int, device) -> tuple:
    """Well-posed (batch, m, n) stacks for one routine at bucket n (gels
    2n x n), from a seeded generator on ``device``."""
    m = 2 * n if routine == "gels" else n
    A = randn((batch, m, n), torch.float32, device, SEED + 50)
    B = randn((batch, m, 4), torch.float32, device, SEED + 51)
    if routine == "posv":
        A = torch.matmul(A, A.mT).add_(n * torch.eye(n, device=device))
    elif routine == "gesv":
        A = A.add_(n * torch.eye(n, device=device))
    return A, B


def serve_start_no_sync(device, batch: int, n: int) -> dict:
    """``start_batched`` of each routine on operands already on ``device``
    (the cache warmed by one solve first), under ``set_sync_debug_mode
    ("error")`` on the card — any host sync in the launch half raises there;
    ``finish_batched`` runs outside the mode.  Returns per routine the worst
    backward error and the info codes' maximum."""
    out = {}
    cache = serve.ExecutableCache()
    cuda = torch.device(device).type == "cuda"
    for routine in ("gesv", "posv", "gels"):
        name = routine + "_batched"
        A, B = _start_operands(routine, batch, n, device)
        serve.finish_batched(serve.start_batched(name, A, B, cache=cache))
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            pb = serve.start_batched(name, A, B, cache=cache)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
        payload, info, _ = serve.finish_batched(pb)
        X = payload[0]
        R = torch.matmul(A, X).sub_(B)
        if routine == "gels":          # the normal-equations residual
            R = torch.matmul(A.mT, R)
        err = (torch.linalg.matrix_norm(R) / (torch.linalg.matrix_norm(A)
               * torch.linalg.matrix_norm(X)))
        if routine == "gels":
            err = err / torch.linalg.matrix_norm(A)
        out[routine] = {"info_max": int(info.abs().max()),
                        "backward_error": float(err.max()),
                        "hits": cache.stats()["hits"]}
    return out


def serve_chaos(device, burst: int, flight_path: str) -> dict:
    """The serving chaos checks: a zero pivot in element 3 of a 32-element
    gesv batch recovers element-wise (report chain ``("batched",
    "elementwise")``, info 0); a worker crash on executor 0 of a 2-executor
    queue under a ``burst``-request burst fails only its in-flight chunk,
    reroutes the rest, and leaves the survivor serving."""
    out = {}
    A, B = _start_operands("gesv", 32, 16, device)
    plan = slate.FaultPlan([slate.FaultSpec("gesv_batched", "zero_pivot",
                                            call_index=3)])
    with plan:
        X, _, info, reps = serve.gesv_batched(A, B, {"solve_report": True},
                                              cache=serve.ExecutableCache())
    out["zero_pivot"] = {"fired": plan.fired, "chain": reps[3].fallback_chain,
                         "recovered": reps[3].recovered,
                         "info_max": int(info.abs().max()),
                         "finite": bool(torch.isfinite(X).all())}
    rng = np.random.default_rng(SEED + 52)
    reqs = [rng.standard_normal((8, 8)).astype(np.float32) + 8 * np.eye(
        8, dtype=np.float32) for _ in range(burst)]
    rhs = rng.standard_normal((8, 1)).astype(np.float32)
    flight = serve.FlightRecorder(auto_dump_path=flight_path)
    with serve.ServeQueue(policy=serve.BucketPolicy(max_batch=4,
                                                    batch_dims=(1, 4),
                                                    max_wait_ms=2.0),
                          cache=serve.ExecutableCache(), executors=2,
                          flight=flight, device=device) as q:
        with slate.FaultPlan([slate.FaultSpec(serve.SERVE_SITE, "worker_crash",
                                              executor=0)]):
            tickets = [q.submit("gesv", a, rhs) for a in reqs]
            ok = failed = 0
            for t in tickets:
                try:
                    ok += int(t.result(timeout=60.0)[1] == 0)
                except slate.SlateError as e:
                    require("worker thread died" in str(e), f"crash error {e}")
                    failed += 1
        after = q.submit("gesv", reqs[0], rhs)
        survivor = (after.result(timeout=60.0)[1], after.executor)
        out["worker_crash"] = {"ok": ok, "failed": failed,
                               "capacity_fraction": q.capacity_fraction(),
                               "survivor_info": int(survivor[0]),
                               "survivor": survivor[1]}
    return out


def serve_device_operands(device, n_req: int) -> dict:
    """Requests handed in as tensors already on ``device``
    (``make_requests(n_req, seed=9, dims=(8, 13, 24))``).  On the card the
    submit-side normalization of every request and the packing of the
    largest bucket's chunk run under ``set_sync_debug_mode("error")``: a copy
    to the host or a sync raises there.  Then ``solve_many`` of the tensors
    against ``solve_many`` of the numpy arrays (same batches, same programs),
    and a ``ServeQueue`` of the tensors against the same numpy results."""
    reqs = serve.make_requests(n_req, seed=9, dims=(8, 13, 24))
    dev = [(r, torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
           for r, a, b in reqs]
    policy = serve.BucketPolicy()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        groups: dict = {}
        for r, a, b in dev:
            key, item = squeue._normalize_request(policy, r, a, b)
            groups.setdefault(key, []).append(item)
        (routine, bucket, _), items = max(groups.items(),
                                          key=lambda kv: len(kv[1]))
        items = items[:policy.max_batch]
        A, B, _ = sexec._pack_batch(routine, bucket, items,
                                    policy.round_batch(len(items)),
                                    torch.device(device))
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    packed_ok = all(torch.equal(A[i, :it.a.shape[0], :it.a.shape[1]], it.a)
                    for i, it in enumerate(items))
    cache = serve.ExecutableCache()
    want = serve.solve_many(reqs, cache=cache, device=device)
    got = serve.solve_many(dev, cache=cache, device=device)
    with serve.ServeQueue(cache=cache, device=device) as q:
        tickets = [q.submit(r, a, b) for r, a, b in dev]
        queued = [t.result(timeout=60.0) for t in tickets]

    def worst(res):
        return max(float(torch.linalg.vector_norm(x - w[0])
                         / torch.linalg.vector_norm(w[0]))
                   for (x, _), w in zip(res, want))

    return {"requests": len(dev), "packed_chunk": len(items),
            "packed_equal": packed_ok,
            "info_equal": all(g[1] == w[1] == q_[1] == 0
                              for g, w, q_ in zip(got, want, queued)),
            "on_device": all(x.device.type == torch.device(device).type
                             for x, _ in got + queued),
            "solve_many_max_rel": worst(got), "queue_max_rel": worst(queued)}


def serve_check(device, n_req: int) -> dict:
    """``solve_many`` of ``make_requests(n_req, seed=9)`` on ``device``:
    per request the solution, its info and its backward error (the
    tester's gates: ||b - A x||_F / (||A||_F ||x||_F) for gesv/posv, the
    normal-equations residual ||A^T (A x - b)|| / (||A||^2 ||x||) for gels),
    computed in f64 on the host."""
    reqs = serve.make_requests(n_req, seed=9)
    res = serve.solve_many(reqs, device=device)
    out = []
    for (r, a, b), (x, info) in zip(reqs, res):
        xh = x.cpu().numpy().astype(np.float64)
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        resid = a64 @ xh - b64
        if r == "gels":
            err = np.linalg.norm(a64.T @ resid) / (
                np.linalg.norm(a64) ** 2 * np.linalg.norm(xh))
        else:
            err = np.linalg.norm(resid) / (np.linalg.norm(a64)
                                           * np.linalg.norm(xh))
        out.append({"routine": r, "n": a.shape[1], "x": xh, "info": int(info),
                    "backward_error": float(err)})
    return {"requests": out}


def compare_serve_check(card: dict, host: dict) -> dict:
    """Card against CPU on the same requests: info equal, both backward
    errors within the f32 gate (100x for least squares), and the largest
    relative difference of the solutions."""
    worst_be, worst_diff = 0.0, 0.0
    for c, h in zip(card["requests"], host["requests"]):
        require(c["info"] == h["info"] == 0, f"serve check info {c['info']} "
                f"(card) vs {h['info']} (cpu)")
        g = gate(torch.float32, c["n"]) * (100.0 if c["routine"] == "gels" else 1.0)
        for side in (c, h):
            require(side["backward_error"] <= g, f"serve check {c['routine']} "
                    f"n={c['n']}: backward error {side['backward_error']} > {g}")
        worst_be = max(worst_be, c["backward_error"] / g)
        worst_diff = max(worst_diff, float(np.linalg.norm(c["x"] - h["x"])
                                           / np.linalg.norm(h["x"])))
    return {"worst_backward_error_over_gate": worst_be,
            "max_card_vs_cpu_rel": worst_diff}


def serve_path(device, sizes: dict = SERVE, flight_path: str = "") -> dict:
    """The serving path on ``device`` at ``sizes``: the no-sync launch
    check, the mixed workload at one executor, the pool sizes, continuous
    mode at two executors, the A/B, and the chaos checks.  Returns the
    stats of each, and each part's host seconds."""
    out, (times, step) = {}, _timed(device)
    out["start"] = step("start_s", lambda: serve_start_no_sync(
        device, sizes["start_batch"], sizes["start_n"]))
    out["mixed"] = step("mixed_s", lambda: serve.run_mixed_workload(
        num_requests=sizes["requests"], seed=0, device=device))
    out["scale"] = step("scale_s", lambda: serve.run_scale_workload(
        executor_counts=sizes["executor_counts"],
        num_requests=sizes["scale_requests"], seed=0, device=device))
    out["continuous_n2"] = step("continuous_s", lambda: serve.run_scale_workload(
        executor_counts=(2,), num_requests=sizes["scale_requests"], seed=0,
        continuous=True, device=device)["runs"]["2"])
    out["ab"] = step("ab_s", lambda: serve.run_continuous_ab(
        num_requests=sizes["ab_requests"], seed=0, rounds=sizes["ab_rounds"],
        executors=2, dims=(8, 13), policy=serve.BucketPolicy(**AB_POLICY),
        device=device))
    out["chaos"] = step("chaos_s", lambda: serve_chaos(
        device, sizes["burst"], flight_path or os.devnull))
    out["device_operands"] = step("device_operands_s", lambda: serve_device_operands(
        device, sizes["device_requests"]))
    out["times"] = times
    return out


def check_serve_path(res: dict, sizes: dict = SERVE) -> None:
    for routine, r in res["start"].items():
        require(r["info_max"] == 0, f"start_batched {routine} info {r}")
        g = gate(torch.float32, sizes["start_n"]) * (100.0 if routine == "gels"
                                                     else 1.0)
        require(r["backward_error"] <= g, f"start_batched {routine}: {r} > {g}")
    runs = [res["mixed"], res["continuous_n2"]] + list(res["scale"]["runs"].values())
    for r in runs:
        require(r["bad"] == 0, f"serve run with {r['bad']} bad requests")
        require(r["misses_after_warmup"] == 0,
                f"serve run missed {r['misses_after_warmup']} times after warm-up")
    require(res["mixed"]["distinct_buckets"] >= 4, "fewer than 4 buckets")
    require(res["mixed"]["requests"] == sizes["requests"], "mixed request count")
    require(sorted(res["scale"]["runs"]) == sorted(str(n) for n in
                                                   sizes["executor_counts"]),
            "a pool size was not served")
    ab = res["ab"]
    require(all(v is not None for v in ab["queue_wait_p50_ms"].values()),
            "A/B queue-wait p50 missing")
    z = res["chaos"]["zero_pivot"]
    require(z["fired"] == (("gesv_batched", "zero_pivot", 3),)
            and z["chain"] == ("batched", "elementwise") and z["recovered"]
            and z["info_max"] == 0 and z["finite"], f"zero pivot: {z}")
    w = res["chaos"]["worker_crash"]
    require(1 <= w["failed"] <= 4 and w["ok"] == sizes["burst"] - w["failed"]
            and w["capacity_fraction"] == 0.5 and w["survivor_info"] == 0
            and w["survivor"] == "ex1", f"worker crash: {w}")
    d = res["device_operands"]
    # the same packed operands run the same program: equal to rounding of a
    # different batch composition at most (f32)
    require(d["requests"] == sizes["device_requests"] and d["packed_equal"]
            and d["info_equal"] and d["on_device"]
            and d["solve_many_max_rel"] <= 1e-5 and d["queue_max_rel"] <= 1e-4,
            f"device operands: {d}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def header() -> dict:
    smi = nvidia_smi()
    say("nvidia-smi", smi)
    say("torch", torch.__version__)
    say("cuda", torch.version.cuda)
    say("device", torch.cuda.get_device_name(0))
    say("multiprocessors", torch.cuda.get_device_properties(0).multi_processor_count)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    say("matmul.allow_tf32", tf32)
    say("float32_matmul_precision", precision)
    require(tf32 is False, "TF32 matmuls are on")
    require(precision == "highest", f"float32 matmul precision {precision!r}")
    # the CUDA kernels (nvcc), the native host runtime and the C API (g++)
    # build together
    from concurrent.futures import ThreadPoolExecutor
    from slate_tpu_torch import c_api, native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        host = ex.submit(lambda: (native.build(), time.perf_counter() - t0))
        capi = ex.submit(lambda: (c_api.build(), time.perf_counter() - t0))
        path = cn.build()
        say("kernel_build_s", time.perf_counter() - t0)
        host_path, host_s = host.result()
        capi_path_, capi_s = capi.result()
    say("kernel_library", path)
    say("native_build_s", host_s)
    say("native_library", host_path)
    say("c_api_build_s", capi_s)
    say("c_api_library", capi_path_)
    t0 = time.perf_counter()
    say("pivot_library", cp.build())
    say("pivot_build_s", time.perf_counter() - t0)
    for stem, log in cn.BUILD_LOGS.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {stem}:", line.strip())
    # the 16-byte loads in the machine code (cuobjdump ships with the toolkit)
    cuobjdump = os.path.join(os.path.dirname(cn._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    wide = sass.count("LDG.E.128")
    say("sass_16_byte_loads", wide)
    require(wide > 0, "no 16-byte global loads in the built kernels")
    return {"smi": smi}


def _compare(k: torch.Tensor, p: torch.Tensor, exact: bool, rtol: float,
             what: str) -> tuple:
    require(k.shape == p.shape and k.dtype == p.dtype, f"{what}: shape/dtype")
    diff = (k - p).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel = diff / p.abs().clamp_min(torch.finfo(p.dtype).tiny)
    rel_err = float(rel.max()) if rel.numel() else 0.0
    if exact:
        require(torch.equal(k, p), f"{what}: max differs ({abs_err})")
    else:
        require(bool((diff <= rtol * p.abs()).all()), f"{what}: rel err {rel_err}")
    return abs_err, rel_err


def kernel_phase() -> dict:
    """Every kernel against its plain version on the card."""
    say("kernel_tolerance", "max exact; sums rtol 1e-5 (f32), 1e-12 (f64)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    stats = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0, "checks": 0}
             for k in ("col_reduce", "row_sums")}

    def record(name, errs):
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], errs[0])
        s["max_rel_err"] = max(s["max_rel_err"], errs[1])
        s["checks"] += 1

    for shape in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.float64):
            a = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            for mode in MODES:
                for unit in (False, True):
                    for op in ("sum", "max", "sumsq"):
                        what = f"col_reduce {shape} {dtype} mode={mode} unit={unit} {op}"
                        record("col_reduce", _compare(
                            cn.col_reduce(a, mode, unit, op),
                            cn.col_reduce_plain(a, mode, unit, op),
                            op == "max", RTOL[dtype], what))
                    what = f"row_sums {shape} {dtype} mode={mode} unit={unit}"
                    record("row_sums", _compare(cn.row_sums(a, mode, unit),
                                                cn.row_sums_plain(a, mode, unit),
                                                False, RTOL[dtype], what))
            del a
        torch.cuda.synchronize()
    # a row stride larger than the width (a column slice of a wider matrix),
    # and NaN where the mask says the kernel must not read
    g = torch.randn((700, 513), generator=gen, device="cuda")
    view = g[3:, 1:300]
    require(view.stride(0) == 513, "strided view")
    record("col_reduce", _compare(cn.col_reduce(view, cn._MODE_LOWER, False, "sum"),
                                  cn.col_reduce_plain(view, cn._MODE_LOWER, False, "sum"),
                                  False, 1e-5, "col_reduce strided"))
    record("row_sums", _compare(cn.row_sums(view, cn._MODE_UPPER),
                                cn.row_sums_plain(view, cn._MODE_UPPER), False, 1e-5,
                                "row_sums strided"))
    # the variant each input takes: 1-element loads for the unaligned view above,
    # 16-byte loads for an odd-width view whose columns beyond its width hold NaN
    # (a load past the edge would show; full_path reports the main path's matrix)
    variants = {"unaligned_view": (view, 1)}
    for dtype in (torch.float32, torch.float64):
        wide = torch.full((700, 516), float("nan"), device="cuda", dtype=dtype)
        wide[:, :301] = torch.randn((700, 301), generator=gen, device="cuda", dtype=dtype)
        edge = wide[:, :301]
        variants[f"nan_edge_view_{str(dtype)[6:]}"] = (edge, 16 // edge.element_size())
        for mode in MODES:
            for unit in (False, True):
                for op in ("sum", "max", "sumsq"):
                    record("col_reduce", _compare(
                        cn.col_reduce(edge, mode, unit, op),
                        cn.col_reduce_plain(edge, mode, unit, op), op == "max",
                        RTOL[dtype], f"col_reduce NaN-edge {dtype} {mode} {unit} {op}"))
                record("row_sums", _compare(
                    cn.row_sums(edge, mode, unit), cn.row_sums_plain(edge, mode, unit),
                    False, RTOL[dtype], f"row_sums NaN-edge {dtype} {mode} {unit}"))
    for name, (t, want) in variants.items():
        for kind in ("col", "row"):
            vec = cn.kernel_plan(*t.shape, t.dtype, kind, aligned=cn.is_aligned(t))[
                "vector_width"]
            say(f"variant_{name}_{kind}_vector_width", vec)
            require(vec == want, f"{name}: vector width {vec}, expected {want}")
    del variants
    # the fold inside the launch is deterministic: two calls agree bitwise,
    # including the tall and wide inputs with hundreds of splits
    for shape in ((N, N), (131072, 64), (64, 70000)):
        a = torch.randn(shape, generator=gen, device="cuda")
        for op in ("sum", "max", "sumsq"):
            require(torch.equal(cn.col_reduce(a, op=op), cn.col_reduce(a, op=op)),
                    f"col_reduce {op} {shape} differs between two calls")
        require(torch.equal(cn.row_sums(a), cn.row_sums(a)),
                f"row_sums {shape} differs between two calls")
        del a
    say("bitwise_repeat", "equal")
    poisoned = torch.tril(g[:, :500]) + torch.triu(torch.full_like(g[:, :500],
                                                               float("nan")), 1)
    require(bool(torch.isfinite(cn.col_reduce(poisoned, cn._MODE_LOWER, True)).all()
                 and torch.isfinite(cn.row_sums(poisoned, cn._MODE_LOWER)).all()),
            "a kernel read the masked-out triangle")
    try:
        cn.col_reduce(g.T)
    except slate.SlateError:
        pass
    else:
        raise AssertionError("col_reduce took a tensor with non-unit column stride")
    # the norm layer copies such a layout once and still takes the kernel
    require(abs(float(slate.norm("one", g.T)) - float(g.abs().sum(1).max()))
            <= 1e-5 * float(g.abs().sum(1).max()), "norm of a transposed view")
    torch.cuda.synchronize()
    for name, s in stats.items():
        say(f"{name}_checks", s["checks"])
        say(f"{name}_max_abs_err", s["max_abs_err"])
        say(f"{name}_max_rel_err", s["max_rel_err"])
    return stats


def path_shapes_phase(launched, stats: dict) -> None:
    """Each kernel against its plain version at every configuration the paths
    launched it with (``cuda_norms.LAUNCHED``: shape, dtype, row stride,
    base alignment, mask, unit diagonal, op), on new random data laid out
    the same way (a view with that row stride, one element into its buffer
    where the launch's base was not 16-byte aligned)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    op_name = {code: op for op, code in cn._OPS.items()}
    views = {}
    for name, (m, n), dtype, lda, base_aligned, mode, unit, *op in sorted(launched,
                                                                        key=str):
        key = ((m, n), dtype, lda, base_aligned)
        if key not in views:
            views.clear()
            off = 0 if base_aligned else 1
            buf = torch.randn(off + (m - 1) * lda + n, generator=gen, device="cuda",
                              dtype=dtype)
            views[key] = torch.as_strided(buf, (m, n), (lda, 1), off)
        a = views[key]
        require(cn.is_aligned(a) == (base_aligned and lda * a.element_size() % 16 == 0),
                f"{name} {(m, n)}: layout")
        what = f"path shape {name} {(m, n)} {dtype} lda={lda} mode={mode} unit={unit}"
        if name == "col_reduce":
            o = op_name[op[0]]
            errs = _compare(cn.col_reduce(a, mode, bool(unit), o),
                            cn.col_reduce_plain(a, mode, bool(unit), o),
                            o == "max", RTOL[dtype], f"{what} {o}")
        else:
            errs = _compare(cn.row_sums(a, mode, bool(unit)),
                            cn.row_sums_plain(a, mode, bool(unit)),
                            False, RTOL[dtype], what)
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], errs[0])
        s["max_rel_err"] = max(s["max_rel_err"], errs[1])
        s["checks"] += 1
        s["path_shape_checks"] = s.get("path_shape_checks", 0) + 1
    views.clear()
    torch.cuda.synchronize()
    say("path_shapes", json.dumps(sorted({f"{x[0]} {x[1][0]}x{x[1][1]} {str(x[2])[6:]}"
                                          for x in launched})))
    for name, s in stats.items():
        say(f"{name}_path_shape_checks", s.get("path_shape_checks", 0))
        say(f"{name}_max_abs_err", s["max_abs_err"])


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time per call from CUDA events over ``reps`` calls, after
    warm-up.  The 1 GiB operand is 20x the 50 MB L2, so every call reads it
    from HBM."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved(kern, lib) -> tuple:
    """Times (ms) of ``kern`` and ``lib`` over ROUNDS rounds of kernel, library,
    library, kernel, so that both see the same card state."""
    ks, ls = [], []
    for _ in range(ROUNDS):
        ks.append(time_ms(kern))
        if lib:
            ls += [time_ms(lib), time_ms(lib)]
        ks.append(time_ms(kern))
    return ks, ls


def bound(elems: int, out_len: int, dtype) -> tuple:
    """Least time (ms) an H100 SXM needs: bytes (each element the function
    needs read once, the result written once) over the HBM rate vs operations
    (abs + add/max per element) over the peak rate of the type."""
    item = torch.empty((), dtype=dtype).element_size()
    t_bytes = (elems + out_len) * item / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * elems / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_phase() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    full, lower = N * N, N * (N + 1) // 2     # elements a GE / LOWER reduction reads
    out = {}
    for dtype in (torch.float32, torch.float64):
        a = torch.randn((N, N), generator=gen, device="cuda", dtype=dtype)
        rows = {
            # name: (kernel call, plain call, library call of the same function,
            #        elements read, result length, kernel kind)
            "col_reduce": (lambda: cn.col_reduce(a, op="sum"),
                           lambda: cn.col_reduce_plain(a, op="sum"),
                           lambda: torch.linalg.vector_norm(a, 1, dim=0), full, N, "col"),
            "row_sums": (lambda: cn.row_sums(a), lambda: cn.row_sums_plain(a),
                         lambda: torch.linalg.vector_norm(a, 1, dim=1), full, N, "row"),
        }
        if dtype == torch.float32:
            rows.update({
                "col_reduce_max": (lambda: cn.col_reduce(a, op="max"),
                                   lambda: cn.col_reduce_plain(a, op="max"),
                                   lambda: torch.linalg.vector_norm(a, float("inf"), dim=0),
                                   full, N, "col"),
                "col_reduce_sumsq": (lambda: cn.col_reduce(a, op="sumsq"),
                                     lambda: cn.col_reduce_plain(a, op="sumsq"),
                                     lambda: torch.linalg.vector_norm(a, 2, dim=0),
                                     full, N, "col"),
                "col_reduce_lower": (lambda: cn.col_reduce(a, cn._MODE_LOWER, op="sum"),
                                     lambda: cn.col_reduce_plain(a, cn._MODE_LOWER, op="sum"),
                                     None, lower, N, "col"),
                "genorm_fro": (lambda: cn.genorm(a, "fro"), None,
                               lambda: torch.linalg.matrix_norm(a, "fro"), full, 1, "col"),
                "genorm_one": (lambda: cn.genorm(a, "one"), None,
                               lambda: torch.linalg.matrix_norm(a, 1), full, 1, "col"),
                "genorm_inf": (lambda: cn.genorm(a, "inf"), None,
                               lambda: torch.linalg.matrix_norm(a, float("inf")), full, 1,
                               "row"),
            })
        for name, (kern, plain, lib, elems, out_len, kind) in rows.items():
            name = name if dtype == torch.float32 else f"{name}_f64"
            b_ms, b_by = bound(elems, out_len, dtype)
            ks, ls = interleaved(kern, lib)
            r = {"ms": statistics.median(ks), "ms_min": min(ks), "ms_max": max(ks),
                 "library_ms": statistics.median(ls) if ls else None,
                 "library_ms_min": min(ls) if ls else None,
                 "library_ms_max": max(ls) if ls else None,
                 "plain_ms": time_ms(plain) if plain else None,
                 "bound_ms": b_ms, "bound_by": b_by,
                 "vector_width": cn.kernel_plan(N, N, dtype, kind,
                                                aligned=cn.is_aligned(a))["vector_width"]}
            r["library_ratio"] = r["ms"] / r["library_ms"] if ls else None
            r["fraction_of_bound"] = b_ms / r["ms"]
            out[name] = r
            for key, v in r.items():
                say(f"time_{name}_{key}", v)
        del a, rows
        torch.cuda.empty_cache()
    return out


def small_checks() -> None:
    """Small inputs: the main path on the card against numpy and against the
    port's own CPU path, info codes, and the lower-triangle-only invariant of
    the library Cholesky on the card."""
    rng = np.random.default_rng(SEED + 3)
    n = 512
    m = rng.standard_normal((n, n))
    a = m @ m.T / n + 2.0 * np.eye(n)
    b = rng.standard_normal((n, NRHS))
    card = main_path(torch.tensor(a, device="cuda"), torch.tensor(b, device="cuda"), 64)
    host = main_path(torch.tensor(a), torch.tensor(b), 64)
    check_main_path(card, n)
    x_ref = np.linalg.solve(a, b)
    x_err = float(np.linalg.norm(card["X"].cpu().numpy() - x_ref) / np.linalg.norm(x_ref))
    say("small_posv_rel_err_vs_numpy", x_err)
    require(x_err <= 1e-12, "small posv differs from numpy")
    for key in ("one", "inf", "max", "a_fro", "trcondest", "pocondest",
                "col_norms_max"):
        rel = abs(card[key] - host[key]) / abs(host[key])
        say(f"small_{key}_card_vs_cpu_rel", rel)
        require(rel <= 1e-10, f"small {key}: card {card[key]} vs cpu {host[key]}")
    require(card["non_spd_info"] == host["non_spd_info"], "non-SPD info card vs cpu")
    exact_cond = 1.0 / (np.abs(a).sum(0).max() * np.abs(np.linalg.inv(a)).sum(0).max())
    say("small_pocondest_vs_exact", card["pocondest"] / exact_cond)

    # info codes of the JAX package: 1 by default, 4 with exact_info, for an
    # 8 x 8 SPD matrix with a[3, 3] = -50 (tests/test_torch_chol.py)
    r = np.random.default_rng(11).standard_normal((8, 8))
    bad = r @ r.T + 8 * np.eye(8)
    bad[3, 3] = -50.0
    for target in ("tiled", "xla"):
        for exact, want in ((False, 1), (True, 4)):
            _, info = slate.potrf(torch.tensor(bad, device="cuda"),
                                  {"target": target, "exact_info": exact})
            say(f"info_{target}_exact={exact}", int(info))
            require(int(info) == want, f"info {int(info)} != {want}")
    # a NaN at a[20, 20] of a 40 x 40 SPD matrix: info names pivot 21
    m40 = np.random.default_rng(12).standard_normal((40, 40))
    a40 = m40 @ m40.T / 40 + 2 * np.eye(40)
    a40[20, 20] = np.nan
    for target in ("tiled", "xla"):
        _, info = slate.potrf(torch.tensor(a40, device="cuda"),
                              {"target": target, "block_size": 16})
        say(f"info_nan_{target}", int(info))
        require(int(info) == 21, f"NaN-input info {int(info)} != 21")

    # cuSOLVER must read only the lower triangle (the trailing updates keep
    # only the lower half current)
    a300 = a[:300, :300]
    poisoned = torch.tensor(np.tril(a300) + np.triu(np.full((300, 300), np.nan), 1),
                            device="cuda")
    ref = np.linalg.cholesky(a300)
    for name, L in (("cholesky", chol._cholesky(poisoned)),
                    ("chol_blocked", chol._chol_blocked(poisoned)),
                    ("potrf_tiled", slate.potrf(
                        slate.HermitianMatrix.from_array("lower", poisoned, nb=64),
                        {"target": "tiled", "block_size": 64})[0])):
        err = float(np.abs(L.cpu().numpy() - ref).max())
        say(f"lower_only_{name}_max_err", err)
        require(err <= 1e-12, f"{name} read the upper triangle")
    torch.cuda.synchronize()


def full_path() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    A = spd(N, gen, "cuda", torch.float32)
    B = torch.randn((N, NRHS), generator=gen, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    say("main_setup_s", time.perf_counter() - t0)
    for kind in ("col", "row"):
        vec = cn.kernel_plan(N, N, A.dtype, kind, aligned=cn.is_aligned(A))["vector_width"]
        say(f"variant_main_path_matrix_{kind}_vector_width", vec)
        require(vec == 4, f"the main path's matrix takes {vec}-element loads")
    keep = A.clone()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = main_path(A, B, NB)
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    require(torch.equal(A, keep), "the caller's A was modified")
    check_main_path(res, N)
    for key, v in res.items():
        if key not in ("X", "times"):
            say(f"main_{key}", v)
    for key, v in res["times"].items():
        say(f"main_{key}", v)
    say("main_wall_s", wall)
    say("main_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("main_launches", json.dumps(launches))
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched on the main path")
    return launches


def calu_parts() -> dict:
    """Device time (ms, CUDA events, 3 calls after warm-up) of the pieces the
    full-width LUs are made of, at their shapes: the whole-matrix library LU
    of gesv, one library panel LU of the pp scheme (the first, 16384 x 2048),
    one tournament level of batched pair merges (4 x 4096 x 2048), one
    2048-wide nopiv block factor, and the first trailing gemm."""
    from slate_tpu_torch.linalg import lu
    n, w = GENERAL["n"], GENERAL["calu_nb"]
    A = randn((n, n), torch.float32, "cuda", SEED + 40)
    pairs = A[: 4 * 2 * w, :w].reshape(4, 2 * w, w)
    block = A[:w, :w] + w * torch.eye(w, device="cuda")
    C = A[w:, w:].clone()
    parts = {
        "whole_lu_16384": lambda: lu._lu_factor(A),
        "panel_lu_16384x2048": lambda: torch.linalg.lu_factor_ex(A[:, :w]),
        "pair_merges_4x4096x2048": lambda: torch.linalg.lu_factor_ex(pairs),
        "nopiv_block_2048": lambda: lu._lu_nopiv_blocked(block),
        "trailing_gemm_14336x2048x14336": lambda: C.addmm_(A[w:, :w], A[:w, w:], alpha=-1),
    }
    return {name: time_ms(fn, reps=3) for name, fn in parts.items()}


def _say_all(prefix: str, res: dict) -> None:
    for key, v in res.items():
        if key == "times":
            for name, t in v.items():
                say(f"{prefix}_{name}", t)
        else:
            say(f"{prefix}_{key}", v)


def full_general_path() -> dict:
    """The general solvers at full width, with the kernels' launch counters set
    to 0 just before and read just after; then the n = 4096 checks and the
    card against the CPU at n = 512 (outside the counted run)."""
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = general_path("cuda")
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    check_general_path(res)
    _say_all("general", res)
    n, m, ln = GENERAL["n"], GENERAL["ls_m"], GENERAL["ls_n"]
    lu_flops, ls_flops = 2.0 * n ** 3 / 3.0, 2.0 * ln ** 2 * (m - ln / 3.0)
    t = res["times"]
    for name, flops in (("gesv", lu_flops), ("calu_tournament", lu_flops),
                        ("calu_pp", lu_flops), ("gesv_mixed", lu_flops),
                        ("posv_mixed", n ** 3 / 3.0), ("gels_cholqr", ls_flops),
                        ("gels_qr", ls_flops)):
        say(f"general_{name}_gflops", flops / t[f"{name}_s"] / 1e9)
    say("general_wall_s", wall)
    say("general_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("general_launches", json.dumps(launches))
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched on the general path")

    for name, ms in calu_parts().items():
        say(f"general_part_{name}_ms", ms)

    t0 = time.perf_counter()
    small = small_general("cuda")
    check_small_general(small)
    _say_all("small", small)
    say("small_wall_s", time.perf_counter() - t0)

    t0 = time.perf_counter()
    diffs = compare_general_routines(general_routines("cuda"), general_routines("cpu"))
    for key, d in diffs.items():
        say(f"check_{key}_card_vs_cpu_rel", d)
    say("check_wall_s", time.perf_counter() - t0)
    torch.cuda.synchronize()
    return launches


def svd_driver_times(n: int) -> dict:
    """The library SVD's values at n f32 under PyTorch's default driver
    (Jacobi first) and gesvd: host seconds of the second of two calls each,
    and Sigma sigma^2 against ||A||_F^2.  The driver the port passes
    (``_SVD_DRIVER``) must meet the gate; the other is measured only."""
    G = randn((n, n), torch.float32, "cuda", SEED + 54)
    g_fro = tfro(G)
    out = {}
    for driver in (None, "gesvd"):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            S = torch.linalg.svdvals(G, driver=driver)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        out[f"{driver}_s"] = t
        out[f"{driver}_sumsq_err"] = abs(float((S.double() ** 2).sum()) - g_fro ** 2) / g_fro ** 2
    chosen = lsvd._SVD_DRIVER
    require(out[f"{chosen}_sumsq_err"] <= gate(torch.float32, n),
            f"svdvals driver {chosen}: {out[f'{chosen}_sumsq_err']}")
    return out


def full_eig_path() -> dict:
    """The eig/SVD family: the full-width steps with the kernels' launch
    counters set to 0 just before and read just after (no norm kernel is on
    this path: heev scales by an inline max); then the SVD drivers at
    small_n, the n = 4096 and n = 512 checks, and the card against the CPU at
    n = 256 (outside the counted run)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = eig_path("cuda")
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    SINGLE_EIG.update(res.pop("refs"))
    SINGLE_EIG.update(res["times"])
    _say_all("eig", res)
    check_eig_path(res)
    n, n2 = EIG["n"], EIG["two_stage_n"]
    t = res["times"]
    for name, flops in (("heev_values", 4.0 * n ** 3 / 3.0),
                        ("heev_vectors", 4.0 * n ** 3 / 3.0 + 2.0 * n ** 3),
                        ("svd_vals", 8.0 * n ** 3 / 3.0),
                        ("heev_two_stage_values", 4.0 * n2 ** 3 / 3.0),
                        ("svd_two_stage_values", 8.0 * n2 ** 3 / 3.0)):
        say(f"eig_{name}_gflops", flops / t[f"{name}_s"] / 1e9)
    say("eig_wall_s", wall)
    say("eig_launches", json.dumps(launches))
    say("eig_norm_kernel_launches", sum(launches.values()))

    t0 = time.perf_counter()
    for key, v in svd_driver_times(EIG["small_n"]).items():
        say(f"eig_svd_driver_n{EIG['small_n']}_{key}", v)
    small = small_eig("cuda")
    SINGLE_EIG.update(small["times"])
    _say_all("eig_small", small)
    check_small_eig(small)
    say("eig_small_wall_s", time.perf_counter() - t0)

    t0 = time.perf_counter()
    diffs = compare_eig_routines(eig_routines("cuda"), eig_routines("cpu"))
    for key, d in diffs.items():
        say(f"eig_check_{key}_card_vs_cpu", d)
    say("eig_check_wall_s", time.perf_counter() - t0)
    say("eig_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    torch.cuda.synchronize()
    return launches


def full_serve_path() -> dict:
    """The serving path at the JAX package's serving configuration, with the
    kernels' launch counters set to 0 just before and read just after; then
    the card against the CPU on 96 requests (outside the counted run)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = serve_path("cuda", SERVE, FLIGHT_PATH)
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    check_serve_path(res)
    for routine, r in res["start"].items():
        for key, v in r.items():
            say(f"serve_start_{routine}_{key}", v)
    say("serve_start_sync_debug_mode", "error (no host sync in start_batched)")
    m = res["mixed"]
    for key in ("requests", "solves_per_sec", "p50_ms", "p99_ms",
                "queue_wait_p50_ms", "queue_wait_p99_ms", "distinct_buckets",
                "misses_after_warmup", "hits_measured", "wall_s", "bad"):
        say(f"serve_mixed_{key}", m[key])
    say("serve_mixed_warmup_s", m["warmup"]["seconds"])
    say("serve_mixed_warmup_entries", m["warmup"]["misses"])
    sc = res["scale"]["runs"]
    for n, r in sc.items():
        for key in ("solves_per_sec", "p50_ms", "p99_ms", "steals",
                    "misses_after_warmup"):
            say(f"serve_scale_n{n}_{key}", r[key])
    say("serve_scale_n2_over_n1", sc["2"]["solves_per_sec"] / sc["1"]["solves_per_sec"])
    c = res["continuous_n2"]
    for key in ("solves_per_sec", "p50_ms", "p99_ms", "slot_joins",
                "slot_join_rate", "queue_wait_p50_ms", "misses_after_warmup"):
        say(f"serve_continuous_n2_{key}", c[key])
    ab = res["ab"]
    for key in ("offered_rate", "warm_solves_per_sec", "warm_ratio",
                "queue_wait_p50_ms", "queue_wait_p99_ms", "latency_p50_ms",
                "slot_join_rate", "slot_join_rate_closed_loop"):
        say(f"serve_ab_{key}", ab[key])
    for key, v in res["chaos"].items():
        say(f"serve_chaos_{key}", v)
    for key, v in res["device_operands"].items():
        say(f"serve_device_operands_{key}", v)
    say("serve_device_operands_sync_debug_mode",
        "error (submit normalization and packing of card tensors)")
    for key, v in res["times"].items():
        say(f"serve_{key}", v)
    say("serve_wall_s", wall)
    say("serve_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("serve_launches", json.dumps(launches))
    say("serve_norm_kernel_launches", sum(launches.values()))

    t0 = time.perf_counter()
    cmp = compare_serve_check(serve_check("cuda", SERVE["check_requests"]),
                              serve_check("cpu", SERVE["check_requests"]))
    for key, v in cmp.items():
        say(f"serve_check_{key}", v)
    say("serve_check_wall_s", time.perf_counter() - t0)
    serve.shutdown()
    return launches


# ---------------------------------------------------------------------------
# the tester phase: the user-facing entry point (python -m slate_tpu_torch.testing),
# matgen on the card, the emulated-f64 gemm and the LAPACK-style API

TESTER = {"quick": ["all", "--quick", "--type", "s,d"], "quick_rows": 152,
          "n": N, "nb": NB, "repeat": 3,
          "full": ("posv", "gesv", "norm", "gesv_f64ir"), "condest_n": 4096,
          "matgen_n": N, "matgen_kinds": ("randn", "rand", "rands", "randb", "randr"),
          "spectrum_n": 4096, "f64emu_n": 4096, "lapack_n": 2048}
# card vs the CPU port for randn tiles: the erf_inv polynomial's log/log1p/sqrt
# round by the card's libdevice (the CPU port is within 4 ulp of the JAX package)
RANDN_TILE_ULP = 8
# the geo spectrum is powf(c, e_i) with e_i = -i/(n-1) in float32 as the device
# rounds it (the card divides by a scalar as a multiply by its reciprocal, up to
# 1 ulp from the CPU's quotient, which pow scales by ln c); it is held against
# float64 c^e_i of those same e_i rounded to float32, and CUDA's powf is within
# 4 ulp of that (the CUDA C++ Programming Guide's table of maximum ulp errors)
SIGMA_ULP = 4
TILE = 256


def _table_rows(text: str) -> list:
    """The rows of a ``format_table`` output: (routine, type, m, error,
    time_s, gflops, status) per row, read from the fixed-width columns."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("routine "))
    rows = []
    for line in lines[start + 2:]:
        if " tests: " in line and line.split()[0].isdigit():
            break
        c = re.split(r"\s{2,}", line.strip())
        rows.append({"routine": c[0], "type": c[1], "m": int(c[2]), "error": c[7],
                     "time_s": float(c[8]) if c[8] != "-" else 0.0,
                     "gflops": c[9], "status": c[11]})
    return rows


def tester_quick(device, args=TESTER["quick"]) -> dict:
    """``main(["all", "--quick", ...])`` of the tester CLI: its exit code, the
    rows of its table, the summary line and the five slowest rows."""
    from slate_tpu_torch.testing import __main__ as tmain

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(list(args) + ["--device", str(device)])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    rows = _table_rows(text)
    slowest = sorted(rows, key=lambda r: -r["time_s"])[:5]
    return {"rc": rc, "rows": rows, "wall_s": wall,
            "summary": text.strip().splitlines()[-1],
            "slowest": [f"{r['routine']} {r['type']} {r['m']}: {r['time_s']:.4f} s"
                        for r in slowest]}


def tester_full(device, sizes: dict = TESTER) -> dict:
    """The full-width rows through ``run_sweep``: each routine of
    ``sizes["full"]`` at n x n f32 (nb, best of ``repeat``), the norm kernels'
    launches of each row, and ``gecondest`` at ``condest_n`` (its host check,
    ``np.linalg.cond``, is O(n^3) in numpy)."""
    from slate_tpu_torch.testing.driver import run_sweep

    n, out = sizes["n"], {}
    for routine in sizes["full"]:
        before = dict(cn.LAUNCHES)
        (r,) = run_sweep([routine], [(n, n, n)], ["s"], [sizes["nb"]],
                         repeat=sizes["repeat"], device=device)
        out[routine] = {"status": r.status, "message": r.message, "error": r.error,
                        "time_s": r.time_s, "gflops": r.gflops,
                        "launches": {k: cn.LAUNCHES[k] - before[k] for k in before}}
    c = sizes["condest_n"]
    (r,) = run_sweep(["gecondest"], [(c, c, c)], ["s"], [sizes["nb"]],
                     device=device)
    out["gecondest"] = {"status": r.status, "message": r.message,
                        "error": r.error, "time_s": r.time_s, "gflops": None}
    return out


def _ulp_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in ulps of a (float32)."""
    a64, b64 = a.double(), b.double()
    spacing = torch.from_numpy(np.spacing(np.abs(a.numpy()))).double()
    return float(((a64 - b64).abs() / spacing).max())


def matgen_checks(device, sizes: dict = TESTER) -> dict:
    """The random kinds at n x n f32 on ``device``: seconds and peak memory
    of each, and four TILE x TILE tiles (two corners, the far corner, one
    unaligned interior tile) against the CPU port's ``generate_tile``: bit for
    bit for the uniform family, within RANDN_TILE_ULP for randn.  Then
    ``poev_geo`` at spectrum_n against its requested spectrum."""
    from slate_tpu_torch import matgen

    n, out = sizes["matgen_n"], {}
    cuda = torch.device(device).type == "cuda"
    corners = ((0, 0), (0, n - TILE), (n - TILE, n - TILE),
               (n // 2 - 77, n // 3 + 5))
    for kind in sizes["matgen_kinds"]:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        A, _ = matgen.generate_matrix(kind, n, n, dtype=torch.float32, seed=SEED,
                                      device=device)
        if cuda:
            torch.cuda.synchronize()
        out[f"{kind}_s"] = time.perf_counter() - t0
        if cuda:
            out[f"{kind}_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        worst = 0.0
        for i0, j0 in corners:
            got = A[i0:i0 + TILE, j0:j0 + TILE].cpu()
            want = matgen.generate_tile(kind, i0, j0, TILE, TILE, n, n,
                                        dtype=torch.float32, seed=SEED, device="cpu")
            worst = max(worst, _ulp_gap(want, got))
        out[f"{kind}_tile_max_ulp"] = worst
        del A
    m = sizes["spectrum_n"]
    A, S = matgen.generate_matrix("poev_geo", m, m, dtype=torch.float32,
                                  cond=100.0, seed=SEED, device=device)
    # the exponents as the port rounds them on this device, the power in float64
    e = (-torch.arange(m, dtype=torch.float32, device=device) / max(m - 1, 1)).cpu()
    want = torch.pow(torch.tensor(100.0, dtype=torch.float64), e.double()).float()
    lam = torch.linalg.eigvalsh(A.double()).cpu()
    out["poev_geo_sigma_max_ulp"] = _ulp_gap(want, S.cpu())
    out["poev_geo_symmetric"] = bool(torch.equal(A, A.T))
    out["poev_geo_eig_vs_sigma"] = float(
        (lam - torch.sort(S.cpu().double()).values).abs().max() / S.max().item())
    return out


def check_matgen(out: dict, sizes: dict = TESTER) -> None:
    for kind in sizes["matgen_kinds"]:
        bound = RANDN_TILE_ULP if kind == "randn" else 0
        require(out[f"{kind}_tile_max_ulp"] <= bound,
                f"matgen {kind} tiles {out[f'{kind}_tile_max_ulp']} ulp from the "
                f"CPU port's generate_tile (bound {bound})")
    require(out["poev_geo_sigma_max_ulp"] <= SIGMA_ULP,
            f"poev_geo spectrum {out['poev_geo_sigma_max_ulp']} ulp from c^e in float64")
    require(out["poev_geo_symmetric"], "poev_geo is not symmetric")
    require(out["poev_geo_eig_vs_sigma"] <= gate(torch.float32, sizes["spectrum_n"]),
            "poev_geo eigenvalues miss the requested spectrum")


def f64emu_check(device, n: int = TESTER["f64emu_n"]) -> dict:
    """``gemm_f64emu`` of n x n f64 operands against the library's f64 matmul,
    under the JAX package's own bound (tests/test_blas.py:239-262: max
    relative error < 1e-12), with both timed (a warm call each), and
    ``blas.gemm`` under
    ``Options(f64_emulation=True)`` on the same operands."""
    from slate_tpu_torch.ops import f64emu

    A = randn((n, n), torch.float64, device, SEED + 60)
    B = randn((n, n), torch.float64, device, SEED + 61)
    times, step = _timed(device)
    slate.gemm_f64emu(A, B)                 # warm-up: library handles, workspaces
    C = step("gemm_f64emu", lambda: slate.gemm_f64emu(A, B))
    torch.matmul(A, B)
    ref = step("matmul_f64", lambda: torch.matmul(A, B))
    scale = float(ref.abs().max())
    err = float((C - ref).abs().max()) / scale
    C2 = slate.gemm(2.0, A, B, -0.5, torch.ones_like(A), {"f64_emulation": True})
    err2 = float((C2 - (2.0 * ref - 0.5)).abs().max()) / (2.0 * scale)
    return {"max_rel_err": err, "blas_gemm_max_rel_err": err2,
            "bf16_products": f64emu._bf16_products(torch.device(device)),
            "times": times}


def check_f64emu(out: dict) -> None:
    require(out["max_rel_err"] < 1e-12,
            f"gemm_f64emu error {out['max_rel_err']:.3e} >= 1e-12")
    require(out["blas_gemm_max_rel_err"] < 1e-12,
            f"gemm f64_emulation error {out['blas_gemm_max_rel_err']:.3e} >= 1e-12")


def lapack_checks(device, n: int = TESTER["lapack_n"]) -> dict:
    """The LAPACK-style API (numpy in, numpy out, ``info`` returned) on
    ``device`` at n against numpy/scipy: sgesv, dposv, sgels (2n x n), ssyev,
    sgesvd and slange, each ``info`` 0, and a singular sgesv with ``info`` > 0."""
    from slate_tpu_torch import lapack_api as la

    rng = np.random.default_rng(SEED + 70)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, 4)).astype(np.float32)
    out = {}
    x, ipiv, info = la.sgesv(a, b, device=device)
    out["sgesv_info"] = info
    out["sgesv_be"] = float(np.linalg.norm(b - a @ x) / (np.linalg.norm(a) * np.linalg.norm(x)))
    g = rng.standard_normal((n, n))
    spd = g @ g.T / n + 2.0 * np.eye(n)
    bd = rng.standard_normal((n, 4))
    x, info = la.dposv("l", spd, bd, device=device)
    out["dposv_info"] = info
    out["dposv_be"] = float(np.linalg.norm(bd - spd @ x) / (np.linalg.norm(spd) * np.linalg.norm(x)))
    at = rng.standard_normal((2 * n, n)).astype(np.float32)
    bt = rng.standard_normal((2 * n, 2)).astype(np.float32)
    x = la.sgels("n", at, bt, device=device)[:n]
    out["sgels_normal_eq"] = float(np.linalg.norm(at.T @ (at @ x - bt))
                                   / (np.linalg.norm(at) ** 2 * np.linalg.norm(x)))
    sym = ((a + a.T) / 2).astype(np.float32)
    lam, z = la.ssyev("v", "l", sym, device=device)
    ref = np.linalg.eigvalsh(sym.astype(np.float64))
    out["ssyev_values"] = float(np.abs(lam - ref).max() / np.abs(ref).max())
    out["ssyev_residual"] = float(np.linalg.norm(sym @ z - z * lam) / np.linalg.norm(sym))
    s, u, vt = la.sgesvd("s", "s", a, device=device)
    sref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    out["sgesvd_values"] = float(np.abs(s - sref).max() / sref[0])
    out["sgesvd_reconstruction"] = float(np.linalg.norm(a - (u * s) @ vt) / np.linalg.norm(a))
    for which, want in (("m", np.abs(a).max()), ("o", np.abs(a).sum(0).max()),
                        ("i", np.abs(a).sum(1).max()), ("f", np.linalg.norm(a))):
        out[f"slange_{which}"] = abs(la.slange(which, a, device=device) - want) / want
    sing = a.copy()
    sing[:, 7] = 0.0
    out["sgesv_singular_info"] = la.sgesv(sing, b, device=device)[2]
    return out


def check_lapack(out: dict, n: int = TESTER["lapack_n"]) -> None:
    g32 = float(gate(torch.float32, n))
    for key in ("sgesv_info", "dposv_info"):
        require(out[key] == 0, f"{key} = {out[key]}")
    require(out["sgesv_singular_info"] > 0, "singular sgesv gave info 0")
    require(out["sgesv_be"] <= g32, "sgesv backward error over the f32 gate")
    require(out["dposv_be"] <= gate(torch.float64, n), "dposv backward error over the f64 gate")
    require(out["sgels_normal_eq"] <= 100 * g32, "sgels normal-equations residual")
    for key in ("ssyev_values", "ssyev_residual", "sgesvd_values", "sgesvd_reconstruction"):
        require(out[key] <= g32, f"{key} {out[key]:.3e} over the f32 gate")
    for which in "moif":
        require(out[f"slange_{which}"] <= 1e-5, f"slange {which} off")


def check_tester_path(quick: dict, full: dict, sizes: dict = TESTER) -> None:
    rows = quick["rows"]
    require(quick["rc"] == 0, f"the quick sweep exited {quick['rc']}")
    require(len(rows) == sizes["quick_rows"],
            f"{len(rows)} quick rows, not {sizes['quick_rows']}")
    bad = [f"{r['routine']} {r['type']} {r['m']}: {r['status']}" for r in rows
           if r["status"] != "pass"]
    require(not bad, f"quick rows not passing: {bad}")
    for routine, r in full.items():
        require(r["status"] == "pass", f"{routine} row: {r['status']} {r['message']}")


def full_tester_path() -> dict:
    """The tester entry point on the card with the kernels' launch counters set
    to 0 just before and read just after: the quick sweep of every routine
    (s and d) and the full-width rows; then, outside the counted run, matgen
    at full width, ``gemm_f64emu`` and the LAPACK-style API."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    quick = tester_quick("cuda")
    full = tester_full("cuda")
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    say("tester_quick_summary", quick["summary"])
    say("tester_quick_wall_s", quick["wall_s"])
    for i, line in enumerate(quick["slowest"]):
        say(f"tester_quick_slowest_{i + 1}", line)
    for routine, r in full.items():
        for key in ("status", "error", "time_s", "gflops"):
            say(f"tester_{routine}_{key}", r[key])
        if "launches" in r:
            say(f"tester_{routine}_launches", json.dumps(r["launches"]))
    say("tester_wall_s", wall)
    say("tester_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("tester_launches", json.dumps(launches))
    check_tester_path(quick, full)
    for name in ("col_reduce", "row_sums"):
        require(full["norm"]["launches"][name] > 0,
                f"the norm row did not launch {name}")

    t0 = time.perf_counter()
    mg = matgen_checks("cuda")
    _say_all("matgen", mg)
    say("matgen_wall_s", time.perf_counter() - t0)
    emu = f64emu_check("cuda")
    _say_all("f64emu", emu)
    t0 = time.perf_counter()
    lapack = lapack_checks("cuda")
    _say_all("lapack", lapack)
    say("lapack_wall_s", time.perf_counter() - t0)
    check_matgen(mg)
    check_f64emu(emu)
    check_lapack(lapack)
    torch.cuda.synchronize()
    return launches


# ---------------------------------------------------------------------------
# the distributed tier (slate_tpu_torch.parallel) on a 1x1 grid, through the
# public API (any device)
# ---------------------------------------------------------------------------

# full width: the SPD solve and the lookahead pipeline at the potrf bench size
# and blocking (bench.py:284-304, 530-565), gesv and SUMMA at 16384^2, the
# least squares at the gels bench shape (bench.py:376-391), CAQR at 8192^2, the
# mixed SPD solve in f64, the norms, the inverses at 4096^2 f64 and the batched
# solve at the serving configuration (batch 32, bucket 64)
# the single-device two-stage values and step seconds of phase 10, the
# denominators of phase 13's ratios (phase 13 builds its matrices from the
# same seeds and does not run those steps again)
SINGLE_EIG = {}


DIST = {"n": N, "nb": NB, "nrhs": NRHS, "gesv_nb": 256, "ls_m": 131072,
        "ls_n": 4096, "ls_nrhs": 16, "geqrf_n": 8192, "geqrf_nb": 256,
        "mixed_n": N, "inv_n": 4096, "batch": 32, "bucket": 64, "batch_nrhs": 1}


def _rel(X, Y) -> float:
    """||X - Y||_F / ||Y||_F in float64 (no norm kernel)."""
    return float(torch.linalg.norm((X - Y).double()) / torch.linalg.norm(Y.double()))


def _agree(A, X, Y) -> float:
    """How far two solutions of A X = B are apart in the backward sense:
    ||A (X - Y)||_F / (||A||_F ||Y||_F) (no norm kernel)."""
    D = torch.matmul(A, (X - Y).to(A.dtype))
    return float(torch.linalg.norm(D.double())
                 / (torch.linalg.norm(A.double()) * torch.linalg.norm(Y.double())))


def dist_path(device, sizes: dict = DIST) -> dict:
    """Every distributed driver of the slice on a 1x1 grid of ``device``
    (NCCL on the card, gloo on the CPU), each beside the single-device port on
    the same input: seconds of both, the error under the tester's gate and
    the agreement of the two results.  Each step ends in a device sync."""
    import torch.distributed as dist
    from slate_tpu_torch import parallel as par

    grid = par.ProcessGrid.cached(1, 1, device=device)
    out = {"grid": f"{grid.p}x{grid.q} {grid.order}",
           "world_size": dist.get_world_size(), "backend": str(dist.get_backend())}
    times, step = _timed(device)
    f32, f64 = torch.float32, torch.float64
    n, nb, k = sizes["n"], sizes["nb"], sizes["nrhs"]
    g32 = gate(f32, n)

    S = spd(n, torch.Generator(device=device).manual_seed(SEED + 80), device, f32)
    B = randn((n, k), f32, device, SEED + 81)
    Xd = step("posv_dist_s", lambda: par.gather(par.posv_distributed(S, B, grid, nb=nb)))
    Xs = step("posv_single_s", lambda: slate.posv(
        S, B, {"target": "tiled", "block_size": nb}, uplo="lower")[0])
    out["posv_error"] = backward_error(S, Xd, B)
    out["posv_vs_single"] = _rel(Xd, Xs)
    del Xd, Xs
    Ld = step("potrf_pipelined_dist_s", lambda: par.potrf_pipelined(S, grid, nb=nb))
    Ls = step("potrf_pipelined_single_s", lambda: slate.potrf(
        S, {"target": "tiled", "block_size": nb}, uplo="lower")[0])
    V = randn((n, PROBES), f32, device, SEED + 82)
    out["potrf_pipelined_error"] = _rel(torch.matmul(Ld, torch.matmul(Ld.T, V)),
                                        torch.matmul(S, V))
    out["potrf_pipelined_vs_single"] = _rel(Ld, Ls)
    del Ld, Ls, S, B, V

    A = randn((n, n), f32, device, SEED + 83)
    B = randn((n, k), f32, device, SEED + 84)
    Xd, info = step("gesv_dist_s", lambda: par.gesv_distributed(
        A, B, grid, nb=sizes["gesv_nb"]))
    Xd = par.gather(Xd)
    Xs = step("gesv_single_s", lambda: slate.gesv(A, B)[0])
    out["gesv_info"] = int(info)
    out["gesv_error"] = backward_error(A, Xd, B)
    out["gesv_vs_single"] = _agree(A, Xd, Xs)
    del Xd, Xs, B

    for kind in ("one", "inf", "max", "fro"):
        before = dict(cn.LAUNCHES)
        v = step(f"norm_{kind}_dist_s", lambda: float(par.norm_distributed(kind, A, grid)))
        out[f"norm_{kind}_launches"] = {name: cn.LAUNCHES[name] - before[name]
                                        for name in before}
        ref = step(f"norm_{kind}_single_s", lambda: float(slate.norm(kind, A)))
        out[f"norm_{kind}_vs_single"] = abs(v - ref) / ref

    B2 = randn((n, n), f32, device, SEED + 85)
    Cs = step("gemm_single_s", lambda: slate.gemm(1.0, A, B2, 0.0, torch.zeros_like(A)))
    for name in ("gemm_allgather", "gemm_ring"):
        C = step(f"{name}_dist_s", lambda: par.gather(getattr(par, name)(A, B2, grid)))
        out[f"{name}_vs_single"] = _rel(C, Cs)
        del C
    del A, B2, Cs

    m, ln, lk = sizes["ls_m"], sizes["ls_n"], sizes["ls_nrhs"]
    A = randn((m, ln), f32, device, SEED + 86)
    B = randn((m, lk), f32, device, SEED + 87)
    Xd = step("gels_cholqr_dist_s", lambda: par.gels_cholqr_distributed(A, B, grid))
    Xs = step("gels_cholqr_single_s", lambda: slate.gels_cholqr(A, B))
    out["gels_cholqr_error"] = ls_residual(A, Xd, B)
    out["gels_cholqr_vs_single"] = _rel(Xd, Xs)
    del Xd, Xs, B
    Q, R = step("tsqr_dist_s", lambda: par.tsqr_distributed(A, grid))
    Q = par.gather(Q)
    _, Rs = step("tsqr_single_s", lambda: slate.linalg.tsqr(A))
    out["tsqr_error"] = _rel(torch.matmul(Q, R), A)
    out["tsqr_vs_single"] = _rel(R.abs(), Rs.abs())
    del Q, R, Rs, A

    ng = sizes["geqrf_n"]
    A = randn((ng, ng), f32, device, SEED + 88)
    Q, R = step("geqrf_dist_s", lambda: par.geqrf_distributed(A, grid, nb=sizes["geqrf_nb"]))
    Q, R = par.gather(Q), par.gather(R)
    F = step("geqrf_single_s", lambda: slate.geqrf(A))
    QRs = slate.unmqr("left", "n", F, F.R())
    QRd = torch.matmul(Q, R)
    out["geqrf_error"] = _rel(QRd, A)
    out["geqrf_orthogonality"] = float(torch.linalg.norm(
        torch.matmul(Q.T, Q) - torch.eye(ng, device=device)) / math.sqrt(ng))
    out["geqrf_vs_single"] = _rel(QRd, QRs)
    del Q, R, F, QRs, QRd, A

    nm = sizes["mixed_n"]
    S = spd(nm, torch.Generator(device=device).manual_seed(SEED + 89), device, f64)
    B = randn((nm, k), f64, device, SEED + 90)
    Xd, iters, via_ir = step("posv_mixed_dist_s", lambda: par.posv_mixed_distributed(
        S, B, grid, nb=nb))
    Xd = par.gather(Xd)
    Xs = step("posv_mixed_single_s", lambda: slate.posv_mixed(S, B)[0])
    out["posv_mixed_iters"] = int(iters)
    out["posv_mixed_via_ir"] = bool(via_ir)
    out["posv_mixed_error"] = backward_error(S, Xd, B)
    out["posv_mixed_vs_single"] = _rel(Xd, Xs)
    del S, B, Xd, Xs

    ni = sizes["inv_n"]
    G = randn((ni, ni), f64, device, SEED + 91)
    I = torch.eye(ni, dtype=f64, device=device)

    def getri_d():
        LU, perm, _ = par.getrf_distributed(G, grid)
        return par.gather(par.getri_distributed(LU, perm, grid))
    Gd = step("getri_dist_s", getri_d)
    Gs = step("getri_single_s", lambda: slate.getri(*slate.getrf(G.clone())[:2]))
    out["getri_error"] = _rel(torch.matmul(G, Gd), I) / math.sqrt(ni)
    out["getri_vs_single"] = _agree(G, Gd, Gs)
    del G, Gd, Gs
    P = spd(ni, torch.Generator(device=device).manual_seed(SEED + 92), device, f64)
    Lp = torch.linalg.cholesky(P)

    def full(T):
        return torch.tril(T) + torch.tril(T, -1).mH
    Pd = step("potri_dist_s", lambda: full(par.gather(par.potri_distributed(Lp, grid))))
    Ps = step("potri_single_s", lambda: full(slate.potri(Lp.clone(), uplo="lower")))
    out["potri_error"] = _rel(torch.matmul(P, Pd), I) / math.sqrt(ni)
    out["potri_vs_single"] = _rel(Pd, Ps)
    del P, Lp, Pd, Ps, I

    nbat, nbk, nr = sizes["batch"], sizes["bucket"], sizes["batch_nrhs"]
    a = randn((nbat, nbk, nbk), f32, device, SEED + 93)
    b = randn((nbat, nbk, nr), f32, device, SEED + 94)
    xd, perm, info = step("gesv_batched_dist_s", lambda: par.gesv_batched_distributed(
        a, b, grid))
    xd, info = par.gather(xd), par.gather(info)
    xs, _, info_s = step("gesv_batched_single_s", lambda: serve.gesv_batched(a, b))
    r = torch.matmul(a, xd) - b
    out["gesv_batched_error"] = float(max(
        torch.linalg.norm(r[i]) / (torch.linalg.norm(a[i]) * torch.linalg.norm(xd[i]))
        for i in range(nbat)))
    out["gesv_batched_vs_single"] = float(max(_agree(a[i], xd[i], xs[i])
                                              for i in range(nbat)))
    out["gesv_batched_info_equal"] = bool(torch.equal(info.cpu(), info_s.cpu()))
    out["times"] = times
    return out


def check_dist_path(res: dict, sizes: dict = DIST) -> None:
    n, f32, f64 = sizes["n"], torch.float32, torch.float64
    g32, g64 = gate(f32, n), gate(f64, sizes["mixed_n"])
    checks = [("posv_error", g32), ("posv_vs_single", g32),
              ("potrf_pipelined_error", g32), ("potrf_pipelined_vs_single", g32),
              ("gesv_error", g32), ("gesv_vs_single", 2 * g32),
              ("gemm_allgather_vs_single", g32), ("gemm_ring_vs_single", g32),
              ("gels_cholqr_error", 100 * gate(f32, sizes["ls_n"])),
              ("gels_cholqr_vs_single", gate(f32, sizes["ls_n"])),
              ("tsqr_error", gate(f32, sizes["ls_n"])),
              ("tsqr_vs_single", gate(f32, sizes["ls_n"])),
              ("geqrf_error", gate(f32, sizes["geqrf_n"])),
              ("geqrf_orthogonality", gate(f32, sizes["geqrf_n"])),
              ("geqrf_vs_single", 2 * gate(f32, sizes["geqrf_n"])),
              ("posv_mixed_error", g64), ("posv_mixed_vs_single", g64),
              ("getri_error", gate(f64, sizes["inv_n"])),
              ("getri_vs_single", 2 * gate(f64, sizes["inv_n"])),
              ("potri_error", gate(f64, sizes["inv_n"])),
              ("potri_vs_single", gate(f64, sizes["inv_n"])),
              ("gesv_batched_error", gate(f32, sizes["bucket"])),
              ("gesv_batched_vs_single", 2 * gate(f32, sizes["bucket"]))]
    for key, bound in checks:
        require(res[key] <= bound, f"dist {key} {res[key]:.3e} > {bound:.3e}")
    for kind in ("one", "inf", "max", "fro"):
        require(res[f"norm_{kind}_vs_single"] <= RTOL[f32],
                f"dist norm {kind} differs from the single-device port")
    require(res["gesv_info"] == 0, f"gesv_distributed info {res['gesv_info']}")
    require(res["gesv_batched_info_equal"], "batched info differs from serve.gesv_batched")
    require(res["posv_mixed_via_ir"], "posv_mixed_distributed fell back to full precision")


def full_dist_path() -> dict:
    """The distributed tier on a 1x1 grid (a process group of one rank), with
    the kernels' launch counters set to 0 just before and read just after.
    A warm-up solve at n = 256 and one collective of each kind on each axis
    start the process group and its communicators first."""
    from slate_tpu_torch import parallel as par

    grid = par.ProcessGrid.cached(1, 1, device="cuda")
    w = spd(256, torch.Generator(device="cuda").manual_seed(SEED), "cuda", torch.float32)
    par.gather(par.posv_distributed(w, w[:, :2], grid, nb=64))
    # and one all-reduce of each kind and one all-gather on each axis, so no
    # timed step pays for a first call
    for axis in (par.ROW_AXIS, par.COL_AXIS, par.mesh.FLAT):
        for op in ("sum", "max"):
            par.axis_allreduce(w[0], grid, axis, op)
        par.axis_allgather(w[0], grid, axis)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = dist_path("cuda")
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    say("dist_card", nvidia_smi())
    for key, v in res.items():
        if key == "times":
            continue
        say(f"dist_{key}", json.dumps(v) if isinstance(v, dict) else v)
    t = res["times"]
    for name in sorted({k.rsplit("_", 2)[0] for k in t
                        if k.endswith("_dist_s") and not k.startswith("gemm_")}):
        say(f"dist_{name}_s", t[f"{name}_dist_s"])
        say(f"dist_{name}_single_s", t[f"{name}_single_s"])
        say(f"dist_{name}_over_single", t[f"{name}_dist_s"] / t[f"{name}_single_s"])
    for name in ("gemm_allgather", "gemm_ring"):
        say(f"dist_{name}_s", t[f"{name}_dist_s"])
        say(f"dist_{name}_over_single", t[f"{name}_dist_s"] / t["gemm_single_s"])
    say("dist_wall_s", wall)
    say("dist_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("dist_launches", json.dumps(launches))
    check_dist_path(res)
    for name in ("col_reduce", "row_sums"):
        require(sum(res[f"norm_{kind}_launches"][name]
                    for kind in ("one", "inf", "max", "fro")) > 0,
                f"norm_distributed did not launch {name}")
    torch.cuda.synchronize()
    par.mesh.destroy()                  # the world of one ends with the phase
    return launches


# phase 13: the second half of the distributed tier (eig / SVD / generalized /
# band / indefinite) on a 1x1 grid.  Full width: phase 10's two-stage values
# configurations (bench.py:632-735); the rest at phase 10's small_n and
# method_n.  Every matrix comes from phase 10's seed, so its single-device
# seconds serve as the denominators.
DIST_EIG = {"two_stage_n": EIG["two_stage_n"], "small_n": EIG["small_n"],
            "method_n": EIG["method_n"], "range_k": EIG["range_k"],
            "band_k": EIG["band_k"], "nb": 64, "solve_nb": 256, "sterf_n": 512}

# phase 10's single-device steps behind each phase-13 step
DIST_EIG_SINGLE = {
    "heev_values": "heev_two_stage_values_s", "svd_values": "svd_two_stage_values_s",
    "heev_dc": "heev_two_stage_vectors_s", "heev_chase_dist": "heev_two_stage_vectors_s",
    "heev_range": "heev_range_s", "hegv": "hegv_s", "svd_vectors": "svd_two_stage_vectors_s",
    "svd_range": "svd_range_s", "pbsv": "pbsv_s", "gbsv": "gbsv_s", "hesv": "hesv_s",
    "heev_qr": "heev_qr_s", "heev_bisection": "heev_bisection_s"}


def single_eig_refs(device, sizes: dict) -> dict:
    """Phase 10's single-device steps that phase 13 compares with, run here
    (the CPU rehearsal; on the card phase 10 has run them): the two-stage
    values at two_stage_n and each step's seconds."""
    ref = dict(small_eig(device, {**EIG, **sizes})["times"])
    times, step = _timed(device)
    n2 = sizes["two_stage_n"]
    A = sym_normal(n2, torch.float32, device, SEED + 52)
    ref["heev_values"], _ = step("heev_two_stage_values_s", lambda: slate.heev(
        A, want_vectors=False, method="two_stage", chase_pipeline=True))
    G = randn((n2, n2), torch.float32, device, SEED + 53)
    ref["svd_values"], _, _ = step("svd_two_stage_values_s", lambda: slate.svd(
        G, want_u=False, want_vt=False, method="two_stage", chase_pipeline=True))
    ref.update(times)
    return ref


@contextlib.contextmanager
def bind_one_rank_grids():
    """Let a wrapper bind to a grid of one rank (``core.matrix.BIND_MIN_RANKS``),
    so the public drivers take their grid routes on one card."""
    from slate_tpu_torch.core import matrix as cm

    old, cm.BIND_MIN_RANKS = cm.BIND_MIN_RANKS, 1
    try:
        yield
    finally:
        cm.BIND_MIN_RANKS = old


def dist_eig_path(device, sizes: dict = DIST_EIG, single=None) -> dict:
    """The grid routes of the public eig/SVD/band/indefinite drivers on a 1x1
    grid of ``device``, on the matrices of phase 10's steps, with wrappers
    bound to the grid (:func:`bind_one_rank_grids`): each step's seconds, its
    error under that step's gate, its distance from the single-device values
    over ||A||_2, and the factors the band and indefinite routes write back
    into their wrappers, held against the distributed drivers' own results.
    ``hegv`` has no grid route (nor in the JAX package) and runs
    ``hegv_distributed``.  Every other norm in the gates comes from
    ``norm_distributed`` on the grid (the norm kernels on the card)."""
    import torch.distributed as dist
    from slate_tpu_torch import parallel as par
    from slate_tpu_torch.parallel.band_dist import _dense_of
    from slate_tpu_torch.parallel.distribute import is_dist

    single = single if single is not None else single_eig_refs(device, sizes)
    grid = par.ProcessGrid.cached(1, 1, device=device)
    out = {"grid": f"{grid.p}x{grid.q} {grid.order}",
           "world_size": dist.get_world_size(), "backend": str(dist.get_backend())}
    times, step = _timed(device)
    f32, f64 = torch.float32, torch.float64
    nb, snb = sizes["nb"], sizes["solve_nb"]
    opts = {"block_size": nb}

    def dnorm(kind, M) -> float:
        return float(par.norm_distributed(kind, M, grid))

    def dgate_eig(A, lam, Z) -> float:
        Z = par.gather(Z)
        R = torch.matmul(A, Z).sub_(Z * lam.to(Z.dtype)[None, :])
        eye = torch.eye(Z.shape[-1], dtype=Z.dtype, device=Z.device)
        return max(dnorm("fro", R) / dnorm("fro", A),
                   dnorm("fro", torch.matmul(Z.mH, Z).sub_(eye)) / A.shape[-1])

    def dgate_svd(A, S, U, VT) -> float:
        U, VT = par.gather(U), par.gather(VT)
        R = torch.matmul(U * S.to(U.dtype)[None, :], VT).sub_(A)
        eye = torch.eye(S.shape[-1], dtype=U.dtype, device=U.device)
        return max(dnorm("fro", R) / dnorm("fro", A),
                   dnorm("fro", torch.matmul(U.mH, U).sub_(eye)) / S.shape[-1])

    def dbackward(A, X, B) -> float:
        X = par.gather(X)
        return dnorm("fro", torch.matmul(A, X).sub_(B)) / (dnorm("fro", A) * dnorm("fro", X))

    def herm(A):
        return slate.HermitianMatrix.from_array("lower", A, nb=nb, grid=grid)

    def dense(M, tile=nb):
        return slate.Matrix.from_array(M.clone(), nb=tile, grid=grid)

    with bind_one_rank_grids():
        # full width: the two-stage values of phase 10 (n = 8192 f32, nb 64)
        n2 = sizes["two_stage_n"]
        A = sym_normal(n2, f32, device, SEED + 52)
        Aw = herm(A)
        require(is_dist(Aw.storage.array),
                "phase 13: the wrapper did not bind to the 1x1 grid")
        lam, _ = step("heev_values_dist_s", lambda: slate.heev(Aw, opts, want_vectors=False))
        a_fro = dnorm("fro", A)
        lam64 = lam.double()
        a_2 = float(single["heev_values"].abs().max())        # ||A||_2 of a symmetric A
        out["heev_values_ascending"] = bool(torch.all(lam[1:] >= lam[:-1]))
        out["heev_values_trace_err"] = abs(float(lam64.sum()) - float(
            torch.diagonal(A).double().sum())) / (n2 * a_fro)
        out["heev_values_sumsq_err"] = abs(float((lam64 ** 2).sum()) - a_fro ** 2) / a_fro ** 2
        out["heev_values_vs_single"] = float((lam - single["heev_values"]).abs().max()) / a_2
        # max|λ| = ||A||_2 <= ||A||_inf (any induced norm bounds the spectral radius)
        out["heev_values_over_inf_norm"] = float(lam.abs().max()) / dnorm("inf", A)
        del A, Aw
        G = randn((n2, n2), f32, device, SEED + 53)
        S, _, _ = step("svd_values_dist_s", lambda: slate.svd(
            dense(G), opts, want_u=False, want_vt=False))
        g_fro = dnorm("fro", G)
        out["svd_values_descending"] = bool(torch.all(S[1:] <= S[:-1]))
        out["svd_values_sumsq_err"] = abs(float((S.double() ** 2).sum()) - g_fro ** 2) / g_fro ** 2
        out["svd_values_vs_single"] = float((S - single["svd_values"]).abs().max()) / float(
            single["svd_values"][0])
        # σ_max = ||G||_2 <= sqrt(||G||_1 ||G||_inf)
        out["svd_values_over_norm_bound"] = float(S[0]) / math.sqrt(
            dnorm("one", G) * dnorm("inf", G))
        del G

        # small_n f32: phase 10's small_eig steps
        n, k, kb = sizes["small_n"], sizes["range_k"], sizes["band_k"]
        A = sym_normal(n, f32, device, SEED + 60)
        Aw = herm(A)
        lam, Z = step("heev_dc_dist_s", lambda: slate.heev(Aw, opts))
        out["heev_dc_gate"] = dgate_eig(A, lam, Z)
        a_2 = float(lam.abs().max())
        out["heev_dc_over_inf_norm"] = a_2 / dnorm("inf", A)
        del Z
        lam_c, Z = step("heev_chase_dist_dist_s", lambda: slate.heev(
            Aw, opts, chase_distributed=True))
        out["heev_chase_dist_gate"] = dgate_eig(A, lam_c, Z)
        out["heev_chase_dist_vs_dc"] = float((lam_c - lam).abs().max()) / a_2
        del Z
        il = n // 2 - k // 2
        lr, Zr = step("heev_range_dist_s", lambda: slate.heev_range(
            Aw, opts, il=il, iu=il + k))
        out["heev_range_gate"] = dgate_eig(A, lr, Zr)
        out["heev_range_vs_full"] = float((lr - lam[il:il + k]).abs().max()) / a_2
        del Zr
        Bs = spd(n, torch.Generator(device=device).manual_seed(SEED + 61), device, f32)
        lg, Xg = step("hegv_dist_s", lambda: par.hegv_distributed(1, A, Bs, grid, nb=nb))
        Xg = par.gather(Xg)
        R = torch.matmul(A, Xg).sub_(torch.matmul(Bs, Xg) * lg[None, :])
        out["hegv_residual"] = dnorm("fro", R) / (
            (dnorm("fro", A) + dnorm("fro", Bs) * float(lg.abs().max())) * dnorm("fro", Xg))
        del Xg, R, Bs
        G = randn((n, n), f32, device, SEED + 62)
        Gw = dense(G)
        S, U, VT = step("svd_vectors_dist_s", lambda: slate.svd(Gw, opts))
        out["svd_vectors_gate"] = dgate_svd(G, S, U, VT)
        del U, VT
        Sr, Ur, VTr = step("svd_range_dist_s", lambda: slate.svd_range(Gw, opts, il=0, iu=k))
        Ur, VTr = par.gather(Ur), par.gather(VTr)
        out["svd_range_vs_full"] = float((Sr - S[:k]).abs().max()) / float(S[0])
        out["svd_range_residual"] = dnorm("fro", torch.matmul(G, VTr.mH).sub_(
            Ur * Sr[None, :])) / dnorm("fro", G)
        del G, Gw, Ur, VTr

        # the band and indefinite solves: each route's write-back is held
        # bit for bit against the distributed driver's own factor
        sopts = {"block_size": snb}
        Bn = randn((n, NRHS), f32, device, SEED + 63)
        r = torch.arange(n, device=device)
        inband = (r[:, None] - r[None, :]).abs() <= kb
        P = torch.where(inband, sym_normal(n, f32, device, SEED + 64), 0.0)
        P.diagonal().add_(2.0 * kb)
        Pw = slate.HermitianBandMatrix("lower", n, kb, snb, grid=grid, device=device, dtype=f32)
        Pw.set_array(torch.tril(P))
        Bw = dense(Bn, snb)
        X, info = step("pbsv_dist_s", lambda: slate.pbsv(Pw, Bw, sopts))
        out["pbsv_info"], out["pbsv_backward_error"] = int(info), dbackward(P, X, Bn)
        out["pbsv_x_written_back"] = bool(torch.equal(Bw.array, par.gather(X)))
        Lb, _ = par.pbtrf_distributed(par.dense_to_band_lower(P, kb), grid, kb, nb=snb)
        out["pbsv_factor_written_back"] = bool(torch.equal(
            Pw.array, par.gather(_dense_of(Lb, grid, n, kb, 0))))
        Pu = slate.HermitianBandMatrix("upper", n, kb, snb, grid=grid, device=device, dtype=f32)
        Pu.set_array(torch.triu(P))
        Xu, info = slate.pbsv(Pu, dense(Bn, snb), sopts)
        out["pbsv_upper_info"] = int(info)
        out["pbsv_upper_backward_error"] = dbackward(P, Xu, Bn)
        del Pw, Pu, Lb, Xu
        Gb = torch.where(inband, randn((n, n), f32, device, SEED + 65), 0.0)
        Gw = slate.BandMatrix(n, n, kb, kb, snb, grid=grid, device=device, dtype=f32)
        Gw.set_array(Gb)
        X, info = step("gbsv_dist_s", lambda: slate.gbsv(Gw, dense(Bn, snb), sopts))
        out["gbsv_info"], out["gbsv_backward_error"] = int(info), dbackward(Gb, X, Bn)
        # a band wrapper holding kl subdiagonals keeps A (the pivots' wider
        # multipliers would not fit); a dense wrapper takes the factored form
        out["gbsv_band_wrapper_kept"] = bool(torch.equal(Gw.array, Gb))
        Gd = dense(Gb, snb)
        Xd, info = slate.gbsv(Gd, dense(Bn, snb), sopts, kl=kb, ku=kb)
        out["gbsv_dense_info"] = int(info)
        out["gbsv_dense_x_equal"] = bool(torch.equal(par.gather(Xd), par.gather(X)))
        fac, _ = par.gbtrf_distributed(par.dense_to_band_general(Gb, kb, kb, extra=kb), grid,
                                       kb, kb, nb=snb)
        wr = fac.lub.shape[0] - 2 * kb
        out["gbsv_factor_written_back"] = bool(torch.equal(
            Gd.array, par.gather(_dense_of(fac.lub, grid, n, wr - 1, kb, extra=kb))))
        del Gw, Gd, Xd, fac
        Hw, Bw = herm(A), dense(Bn, snb)
        X, info = step("hesv_dist_s", lambda: slate.hesv(Hw, Bw, sopts))
        out["hesv_info"], out["hesv_backward_error"] = int(info), dbackward(A, X, Bn)
        out["hesv_x_written_back"] = bool(torch.equal(Bw.array, par.gather(X)))
        del A, Aw, Hw, P, Gb, X

        # method_n f64: QR iteration (steqr_distributed's rotations) and bisection
        m = sizes["method_n"]
        A = sym_normal(m, f64, device, SEED + 66)
        Aw = herm(A)
        for method in ("qr", "bisection"):
            mopts = {"block_size": nb, "method_eig": method}
            lam, Z = step(f"heev_{method}_dist_s", lambda: slate.heev(Aw, mopts))
            out[f"heev_{method}_gate"] = dgate_eig(A, lam, Z)

        # the library's single-precision eigensolve at n <= 512 on the card
        # (stedc._library_eigh): sterf of the chase's tridiagonal, and the
        # fused, two-stage and grid-route values of phase 13's full-width
        # matrix cut to sterf_n, each against float64 on the host
        ns = sizes["sterf_n"]
        A = sym_normal(ns, f32, device, SEED + 52)
        band, _, _ = leig.he2hb(A, nb=leig.default_band_nb(ns))
        d, e = leig.hb2st(band, kd=leig.default_band_nb(ns), want_vectors=False)
        ref_t = torch.linalg.eigvalsh(leig._assemble_tridiag(d.double().cpu(),
                                                             e.double().cpu()))
        ref = torch.linalg.eigvalsh(A.double().cpu())
        for key, lam, want in (
                ("sterf", leig.sterf(d, e), ref_t),
                ("heev_fused", slate.heev(A, want_vectors=False)[0], ref),
                ("heev_two_stage", slate.heev(A, want_vectors=False, method="two_stage")[0],
                 ref),
                ("heev_grid", slate.heev(herm(A), opts, want_vectors=False)[0], ref)):
            lam = lam.double().cpu()
            out[f"small_{key}_vs_f64"] = float((lam - want).abs().max() / want.abs().max())
            out[f"small_{key}_sumsq_err"] = abs(float((lam ** 2).sum() - (want ** 2).sum())) / float(
                (want ** 2).sum())
    for name, key in DIST_EIG_SINGLE.items():
        times[f"{name}_single_s"] = single[key]
    out["times"] = times
    return out


def check_dist_eig_path(res: dict, sizes: dict = DIST_EIG) -> None:
    f32, f64 = torch.float32, torch.float64
    n2, n, m = sizes["two_stage_n"], sizes["small_n"], sizes["method_n"]
    require(res["heev_values_ascending"], "dist heev values not ascending")
    require(res["svd_values_descending"], "dist singular values not descending")
    require(res["heev_values_trace_err"] <= 50 * torch.finfo(f32).eps,
            f"dist heev trace error {res['heev_values_trace_err']}")
    for key in ("heev_values_sumsq_err", "heev_values_vs_single", "svd_values_sumsq_err",
                "svd_values_vs_single"):
        require(res[key] <= gate(f32, n2), f"dist {key} {res[key]:.3e} > {gate(f32, n2):.3e}")
    g = gate(f32, n)
    for key in ("heev_dc_gate", "heev_chase_dist_gate", "heev_chase_dist_vs_dc",
                "heev_range_gate", "heev_range_vs_full", "hegv_residual",
                "svd_vectors_gate", "svd_range_vs_full", "svd_range_residual"):
        require(res[key] <= g, f"dist {key} {res[key]:.3e} > {g:.3e}")
    for name in ("pbsv", "pbsv_upper", "gbsv", "gbsv_dense", "hesv"):
        require(res[f"{name}_info"] == 0, f"dist {name} info {res[f'{name}_info']}")
    for name in ("pbsv", "pbsv_upper", "gbsv", "hesv"):
        require(res[f"{name}_backward_error"] <= g,
                f"dist {name} backward error {res[f'{name}_backward_error']:.3e} > {g:.3e}")
    for key in ("pbsv_x_written_back", "pbsv_factor_written_back", "gbsv_band_wrapper_kept",
                "gbsv_dense_x_equal", "gbsv_factor_written_back", "hesv_x_written_back"):
        require(res[key], f"dist {key} is False")
    for key in ("heev_values_over_inf_norm", "svd_values_over_norm_bound",
                "heev_dc_over_inf_norm"):
        require(res[key] <= 1.0 + g, f"dist {key} {res[key]:.6f}: above the norm bound")
    gs = gate(f32, sizes["sterf_n"])
    for key in ("sterf", "heev_fused", "heev_two_stage", "heev_grid"):
        for what in ("vs_f64", "sumsq_err"):
            v = res[f"small_{key}_{what}"]
            require(v <= gs, f"{key} at n = {sizes['sterf_n']} f32: {what} {v:.3e} > {gs:.3e}")
    for method, gm in (("qr", 100.0 * torch.finfo(f64).eps * m),
                       ("bisection", gate(f64, m))):
        require(res[f"heev_{method}_gate"] <= gm,
                f"dist heev {method} gate {res[f'heev_{method}_gate']:.3e} > {gm:.3e}")


def full_dist_eig_path() -> dict:
    """Phase 13 on a 1x1 NCCL grid, with the kernels' launch counters set to
    0 just before and read just after (the gates' norms and the drivers'
    scaling launch both kernels); phase 10's single-device steps are the
    denominators."""
    from slate_tpu_torch import parallel as par

    grid = par.ProcessGrid.cached(1, 1, device="cuda")
    w = sym_normal(256, torch.float32, "cuda", SEED)
    par.heev_distributed(w, grid, nb=16)      # start the communicators
    for axis in (par.ROW_AXIS, par.COL_AXIS, par.mesh.FLAT):
        for op in ("sum", "max", "min"):
            par.axis_allreduce(w[0], grid, axis, op)
        par.axis_allgather(w[0], grid, axis)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = dist_eig_path("cuda", single=SINGLE_EIG)
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    say("dist_eig_card", nvidia_smi())
    for key, v in res.items():
        if key != "times":
            say(f"dist_eig_{key}", v)
    t = res["times"]
    for name in DIST_EIG_SINGLE:
        say(f"dist_eig_{name}_s", t[f"{name}_dist_s"])
        say(f"dist_eig_{name}_single_s", t[f"{name}_single_s"])
        say(f"dist_eig_{name}_over_single", t[f"{name}_dist_s"] / t[f"{name}_single_s"])
    say("dist_eig_chase", "pipelined (eig._pipelined on a CUDA tensor) unless "
        "chase_distributed")
    say("dist_eig_wall_s", wall)
    say("dist_eig_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("dist_eig_launches", json.dumps(launches))
    check_dist_eig_path(res)
    for name in ("col_reduce", "row_sums"):
        require(launches[name] > 0, f"phase 13 did not launch {name}")
    torch.cuda.synchronize()
    par.mesh.destroy()
    return launches


# phase 14: the host runtime (native maps, pool, trace capture), checkpoint and
# print, and the ScaLAPACK API at phase 12's and phase 13's full sizes, each p*
# call once with no grid (the LAPACK skin on one device) and once on a 1x1 grid
# (the distributed bodies, core.matrix.BIND_MIN_RANKS lowered to 1)
COMPAT = {"tiles": 2048, "grids": ((8, 4), (4, 8)), "pool_blocks": 65536,
          "n": N, "nb": NB, "nrhs": NRHS, "ls_m": 131072, "ls_n": 4096, "ls_nrhs": 16,
          "inv_n": 4096, "eig_n": 4096}


def native_checks(sizes: dict) -> dict:
    """The native maps against their Python versions (exact) at ``tiles``²
    tiles on each grid of ``sizes`` in both orders (owner map, the tiles of
    three ranks, the plan to the transposed grid in the other order), each
    version's seconds, and a MemoryPool cycle of ``pool_blocks`` blocks on
    both backends with a double free rejected."""
    from slate_tpu_torch import native

    out = {"native_backend": native.backend()}
    t = sizes["tiles"]
    secs = {"native": 0.0, "python": 0.0}
    equal = True
    for p, q in sizes["grids"]:
        for order, other in (("col", "row"), ("row", "col")):
            ranks = (0, p * q // 2, p * q - 1)

            def maps():
                return (native.owner_map(t, t, p, q, order),
                        [native.local_tiles(t, t, p, q, r, order) for r in ranks],
                        native.redist_plan(t, t, (p, q), (q, p), order, other))
            got = {}
            for which in ("native", "python"):
                with (native.use_python() if which == "python"
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    got[which] = maps()
                    secs[which] += time.perf_counter() - t0
            (om, lt, rp), (om2, lt2, rp2) = got["native"], got["python"]
            equal &= (np.array_equal(om, om2) and om.dtype == om2.dtype == np.int32
                      and all(np.array_equal(a, b) for a, b in zip(lt, lt2))
                      and np.array_equal(rp[0], rp2[0]) and np.array_equal(rp[1], rp2[1])
                      and rp[2] == rp2[2])
    out.update(maps_equal=bool(equal), maps_native_s=secs["native"],
               maps_python_s=secs["python"],
               maps_python_over_native=secs["python"] / secs["native"])
    nblk = sizes["pool_blocks"]
    for which in ("native", "python"):
        with native.use_python() if which == "python" else contextlib.nullcontext():
            pool = native.MemoryPool(TILE * TILE * 4, nblk)
            t0 = time.perf_counter()
            ids = [pool.alloc() for _ in range(nblk)]
            exhausted = pool.alloc() == -1
            freed = all(pool.free(i) for i in ids)
            double = pool.free(ids[0])
            out[f"pool_{which}_s"] = time.perf_counter() - t0
            out[f"pool_{which}_ok"] = (pool.backend == which
                                       and sorted(ids) == list(range(nblk)) and exhausted
                                       and freed and not double and pool.in_use == 0
                                       and pool.peak == nblk)
            pool.close()
    return out


def trace_posv(device, sizes: dict, tmp: str) -> dict:
    """Phase 1's posv (A = M Mᵀ/n + 2I, Tiled) once untraced and once under
    ``trace.on()`` with pool tracking on: the native capture's region count
    against the Python buffer's ``trace_block`` regions, the native dump
    parsed as chrome-trace JSON, the tracked storages, their pools' leak
    check, the backward error, and the traced seconds over the untraced."""
    from slate_tpu_torch import native
    from slate_tpu_torch.utils import debug

    n, nb, k = sizes["n"], sizes["nb"], sizes["nrhs"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    A = spd(n, gen, device, torch.float32)
    B = torch.randn((n, k), generator=gen, device=device, dtype=torch.float32)
    opts = {"target": "tiled", "block_size": nb}

    def solve():
        Aw = slate.HermitianMatrix.from_array("lower", A, nb=nb)
        Bw = slate.Matrix.from_array(B, nb=nb)
        X, info = slate.posv(Aw, Bw, opts)
        return Aw, Bw, X, info
    times, step = _timed(device)
    step("posv_warm_s", solve)
    step("posv_untraced_s", solve)
    trace.finish(os.path.join(tmp, "before.json"))      # start from an empty buffer
    native.trace_clear()
    debug.enable_pool_tracking(True)
    trace.on()
    try:
        Aw, Bw, X, info = step("posv_traced_s", solve)
    finally:
        trace.off()
        debug.enable_pool_tracking(False)
    py_path, nat_path = os.path.join(tmp, "python.json"), os.path.join(tmp, "native.json")
    trace.finish(py_path)
    with open(py_path) as f:
        regions = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "slate"]
    dumped = native.trace_dump(nat_path)
    with open(nat_path) as f:
        captured = json.load(f)["traceEvents"]
    live, live_bytes = debug.live_workspace_report()
    pools = [w.storage.pool for w in (Aw, Bw)]
    for w, pool in zip(("A", "B"), pools):
        debug.check_no_leaks(pool, w)
    out = {"trace_python_regions": len(regions), "trace_native_regions": native.trace_count(),
           "trace_dump_ok": bool(dumped), "trace_dump_events": len(captured),
           "trace_names_equal": sorted(e["name"] for e in regions)
           == sorted(e["name"] for e in captured),
           "tracked_storages": live, "tracked_bytes": live_bytes,
           "tracked_pools": all(p is not None and p.in_use == 0 for p in pools),
           "posv_info": int(info), "posv_error": backward_error(A, X, B),
           "trace_overhead": times["posv_traced_s"] / times["posv_untraced_s"]}
    native.trace_clear()
    out.update(times)
    return out


def checkpoint_print(device, sizes: dict, tmp: str) -> dict:
    """``save_matrix`` / ``load_matrix`` of the posv matrix through ``tmp``
    (bit-equal round trip, seconds and GB/s each way), then ``print_matrix``
    at verbose 2 of the card's wrapper against that of its CPU copy."""
    n, nb = sizes["n"], sizes["nb"]
    A = spd(n, torch.Generator(device=device).manual_seed(SEED), device, torch.float32)
    W = slate.Matrix.from_array(A, nb=nb)
    path = os.path.join(tmp, "A.npz")
    gb = A.numel() * A.element_size() / 1e9
    t0 = time.perf_counter()
    slate.save_matrix(path, W)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    L = slate.load_matrix(path, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    out = {"checkpoint_bit_equal": bool(type(L) is slate.Matrix and L.storage.nb == nb
                                        and L.device == A.device
                                        and torch.equal(L.array, A)),
           "checkpoint_gb": gb, "save_s": save_s, "load_s": load_s,
           "save_gb_s": gb / save_s, "load_gb_s": gb / load_s}
    os.remove(path)
    del L
    t0 = time.perf_counter()
    text = slate.print_matrix("A", W, verbose=2, file=io.StringIO())
    out["print_s"] = time.perf_counter() - t0
    host = slate.print_matrix("A", slate.Matrix.from_array(A.cpu(), nb=nb), verbose=2,
                              file=io.StringIO())
    out.update(print_equal=text == host, print_lines=text.count("\n") + 1,
               print_has_ellipsis="..." in text)
    return out


@contextlib.contextmanager
def timed_copies(device):
    """Time the numpy skins' copies (``lapack_api._as`` to the device,
    ``lapack_api._host`` back, which ``scalapack_api`` calls too): the card is
    synced before and after each, so a copy is timed to its end and never
    with the compute queued before it.  Yields the seconds by direction."""
    from slate_tpu_torch import lapack_api as la

    seconds = {"h2d": 0.0, "d2h": 0.0}
    plain = {"h2d": la._as, "d2h": la._host}
    on_card = torch.device(device).type == "cuda"

    def timed(direction):
        def copy(*args):
            if on_card:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = plain[direction](*args)
            if on_card:
                torch.cuda.synchronize(device)
            seconds[direction] += time.perf_counter() - t0
            return out
        return copy

    la._as, la._host = timed("h2d"), timed("d2h")
    try:
        yield seconds
    finally:
        la._as, la._host = plain["h2d"], plain["d2h"]


def scalapack_steps(device, sizes: dict) -> dict:
    """Each p* step of phase 14 with no grid and on a 1x1 grid: seconds of
    both routes, the share of each spent copying operands to the device and
    results back (:func:`timed_copies`), each answer's error under its
    gate (PERF.md §2) and the two answers' agreement; the route each call
    took (``scalapack_api.ROUTES``) and the norm kernels' launches of each
    call."""
    import torch.distributed as dist
    from slate_tpu_torch import scalapack_api as sa
    from slate_tpu_torch.linalg import pivots_to_perm

    f32, f64 = torch.float32, torch.float64
    n, k = sizes["n"], sizes["nrhs"]
    grid = sa.gridinit(1, 1, device=device)
    sa.gridexit()
    steps = {"grid": f"{grid.p}x{grid.q} {grid.order}",
             "world_size": dist.get_world_size(), "backend": str(dist.get_backend())}

    def h(t):
        return t.cpu().numpy()

    def d(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def run(key, name, *args):
        """(no-grid result, grid result) of one p* call, each timed (ending
        in its numpy result) and its route checked."""
        out, res = {}, {}
        for route in ("single", "grid"):
            before, launches = dict(sa.ROUTES), dict(cn.LAUNCHES)
            copies = sum(copy_seconds.values())
            kw = {"device": device} if route == "single" else {}
            if route == "grid":
                sa.gridinit(1, 1, device=device)
            t0 = time.perf_counter()
            try:
                res[route] = getattr(sa, name)(*args, **kw)
            finally:
                sa.gridexit()
            out[f"{route}_s"] = time.perf_counter() - t0
            want = "lapack" if route == "single" else "distributed"
            out[f"{route}_route_ok"] = (sa.ROUTES[want] - before[want] == 1 and
                                        sum(sa.ROUTES.values()) - sum(before.values()) == 1)
            out[f"{route}_launches"] = {c: cn.LAUNCHES[c] - launches[c] for c in launches}
            out[f"{route}_copy_share"] = ((sum(copy_seconds.values()) - copies)
                                          / out[f"{route}_s"])
        out["grid_over_single"] = out["grid_s"] / out["single_s"]
        steps[key] = out
        return res["single"], res["grid"]

    with bind_one_rank_grids(), timed_copies(device) as copy_seconds:
        # gemm 16384^2 f32: probe vectors against alpha A (B V) + beta C V
        A, Bm, C = (randn((n, n), f32, device, SEED + 140 + i) for i in range(3))
        a, b, c = h(A), h(Bm), h(C)
        rs, rg = run("gemm", "psgemm", "n", "n", 1.5, a, b, 0.5, c)
        V = randn((n, PROBES), f32, device, SEED + 143).double()
        ref = (1.5 * torch.matmul(A.double(), torch.matmul(Bm.double(), V))
               + 0.5 * torch.matmul(C.double(), V))
        scale = (1.5 * tfro(A) * tfro(Bm) + 0.5 * tfro(C)) * tfro(V)
        for route, r in (("single", rs), ("grid", rg)):
            steps["gemm"][f"{route}_error"] = tfro(torch.matmul(d(r).double(), V)
                                                   - ref) / scale
        steps["gemm"].update(agreement=_rel(d(rg), d(rs)), gate=gate(f32, n))
        # the norms of A: one / inf launch col_reduce / row_sums on both routes
        for kind, char in (("one", "1"), ("inf", "i"), ("fro", "f"), ("max", "m")):
            vs, vg = run(f"lange_{kind}", "pslange", char, a)
            steps[f"lange_{kind}"].update(single_value=vs, grid_value=vg,
                                          agreement=abs(vg - vs) / vs, gate=RTOL[f32])
        del A, Bm, C, a, b, c, rs, rg, ref
        # posv: phase 1's matrix and right-hand sides
        gen = torch.Generator(device=device).manual_seed(SEED)
        S = spd(n, gen, device, f32)
        B = torch.randn((n, k), generator=gen, device=device, dtype=f32)
        s_np, b_np = h(S), h(B)
        (xs, is_), (xg, ig) = run("posv", "psposv", "l", s_np, b_np)
        steps["posv"].update(single_info=is_, grid_info=ig,
                             single_error=backward_error(S, d(xs), B),
                             grid_error=backward_error(S, d(xg), B),
                             agreement=_agree(S, d(xg), d(xs)), gate=gate(f32, n))
        del S, s_np, xs, xg
        # gesv and getrf 16384 f32: tournament against partial pivoting, so the
        # factors are held by P A = L U on probe vectors, not by their pivots
        G = randn((n, n), f32, device, SEED + 144)
        g_np = h(G)
        (xs, _, is_), (xg, _, ig) = run("gesv", "psgesv", g_np, b_np)
        steps["gesv"].update(single_info=is_, grid_info=ig,
                             single_error=backward_error(G, d(xs), B),
                             grid_error=backward_error(G, d(xg), B),
                             agreement=_agree(G, d(xg), d(xs)), gate=gate(f32, n))
        del xs, xg
        fs, fg = run("getrf", "psgetrf", g_np)
        V = randn((n, PROBES), f32, device, SEED + 145)
        for route, (lu_, ipiv, info) in (("single", fs), ("grid", fg)):
            LU = d(lu_)
            perm = torch.from_numpy(pivots_to_perm(ipiv)).to(device)
            UV = torch.matmul(torch.triu(LU), V)
            R = torch.matmul(G[perm], V).sub_(torch.matmul(torch.tril(LU, -1), UV)).sub_(UV)
            steps["getrf"][f"{route}_info"] = int(info)
            steps["getrf"][f"{route}_error"] = tfro(R) / (tfro(G) * tfro(V))
        steps["getrf"].update(agreement=max(steps["getrf"]["single_error"],
                                            steps["getrf"]["grid_error"]),
                              gate=gate(f32, n))
        del G, g_np, fs, fg, LU, UV, R, B, b_np
        # gels 131072 x 4096 f32, 16 right-hand sides
        m, ln, lk = sizes["ls_m"], sizes["ls_n"], sizes["ls_nrhs"]
        L = randn((m, ln), f32, device, SEED + 146)
        R = randn((m, lk), f32, device, SEED + 147)
        l_np, r_np = h(L), h(R)
        xs, xg = run("gels", "psgels", "n", l_np, r_np)
        # the reference solution by the normal equations in f64: a Gaussian
        # m x n matrix with m = 32 n has kappa ~ 1.4, so kappa^2 eps_64 is far
        # below the f32 gate, and the forward error sees a wrong X (2 X reads 1)
        Ld = L.double()
        X_ref = torch.cholesky_solve(torch.matmul(Ld.mT, R.double()),
                                     torch.linalg.cholesky(torch.matmul(Ld.mT, Ld)))
        del Ld
        steps["gels"].update(single_error=_rel(d(xs), X_ref), grid_error=_rel(d(xg), X_ref),
                             single_ls_residual=ls_residual(L, d(xs), R),
                             grid_ls_residual=ls_residual(L, d(xg), R),
                             agreement=_rel(d(xg), d(xs)), gate=gate(f32, ln))
        del L, R, l_np, r_np, xs, xg, X_ref
        # condition estimates and inverses at 4096 f64 from the LAPACK skins' factors
        ni = sizes["inv_n"]
        G = randn((ni, ni), f64, device, SEED + 148)
        P = spd(ni, torch.Generator(device=device).manual_seed(SEED + 149), device, f64)
        g_np, p_np = h(G), h(P)
        I = torch.eye(ni, dtype=f64, device=device)
        lu_, ipiv, _ = sa.pdgetrf(g_np, device=device)
        lf, _ = sa.pdpotrf("l", p_np, device=device)
        xs, xg = run("getri", "pdgetri", lu_, ipiv)
        Xs, Xg = d(xs), d(xg)
        steps["getri"].update(single_error=_rel(torch.matmul(G, Xs), I) / math.sqrt(ni),
                              grid_error=_rel(torch.matmul(G, Xg), I) / math.sqrt(ni),
                              agreement=_agree(G, Xg, Xs), gate=gate(f64, ni))
        true_g = 1.0 / (float(torch.linalg.matrix_norm(G, 1))
                        * float(torch.linalg.matrix_norm(Xs, 1)))
        cs, cg = run("gecon", "pdgecon", "1", lu_, ipiv, np.abs(g_np).sum(0).max())
        steps["gecon"].update(single_value=cs, grid_value=cg, true_rcond=true_g,
                              single_error=max(cs / true_g, true_g / cs),
                              grid_error=max(cg / true_g, true_g / cg),
                              agreement=max(cg / cs, cs / cg))

        def full(T):
            return torch.tril(T) + torch.tril(T, -1).mH
        xs, xg = run("potri", "pdpotri", "l", lf)
        Xs, Xg = full(d(xs)), full(d(xg))
        steps["potri"].update(single_error=_rel(torch.matmul(P, Xs), I) / math.sqrt(ni),
                              grid_error=_rel(torch.matmul(P, Xg), I) / math.sqrt(ni),
                              agreement=_rel(Xg, Xs), gate=gate(f64, ni))
        true_p = 1.0 / (float(torch.linalg.matrix_norm(P, 1))
                        * float(torch.linalg.matrix_norm(Xs, 1)))
        cs, cg = run("pocon", "pdpocon", "l", lf, np.abs(p_np).sum(0).max())
        steps["pocon"].update(single_value=cs, grid_value=cg, true_rcond=true_p,
                              single_error=max(cs / true_p, true_p / cs),
                              grid_error=max(cg / true_p, true_p / cg),
                              agreement=max(cg / cs, cs / cg))
        del G, P, I, Xs, Xg, xs, xg
        # the eigensolvers and the SVD at 4096 f32, under phase 13's gates
        ne = sizes["eig_n"]
        E = sym_normal(ne, f32, device, SEED + 150)
        e_np = h(E)
        (ls, zs), (lg, zg) = run("syev", "pssyev", "v", "l", e_np)
        lam_s, lam_g = d(ls), d(lg)
        steps["syev"].update(single_error=eig_gate(E, lam_s, d(zs)),
                             grid_error=eig_gate(E, lam_g, d(zg)),
                             agreement=float((lam_g - lam_s).abs().max())
                             / float(lam_s.abs().max()), gate=gate(f32, ne))
        # values alone: sum(lam^2) against ||E||_F^2, sum(lam) against tr E
        (ls, zs), (lg, zg) = run("syevd", "pssyevd", "n", "l", e_np)
        chk = {route: values_checks(E, d(v), "v") for route, v in (("single", ls),
                                                                    ("grid", lg))}
        steps["syevd"].update(
            {f"{r}_{k}": v for r, c in chk.items() for k, v in
             (("error", c["v_sumsq_err"]), ("trace_err", c["v_trace_err"]),
              ("ascending", c["v_ascending"]))},
            vectors=[zs, zg], agreement=float(np.abs(lg - ls).max() / np.abs(ls).max()),
            gate=gate(f32, ne), trace_gate=50 * torch.finfo(f32).eps)
        Gs = randn((ne, ne), f32, device, SEED + 151)
        gs_np = h(Gs)
        (ss, us, vts), (sg, ug, vtg) = run("gesvd", "psgesvd", "s", "s", gs_np)
        steps["gesvd"].update(single_error=svd_gate(Gs, d(ss), d(us), d(vts)),
                              grid_error=svd_gate(Gs, d(sg), d(ug), d(vtg)),
                              agreement=float(np.abs(sg - ss).max() / ss.max()),
                              gate=gate(f32, ne))
    return steps


def compat_path(device, sizes: dict = COMPAT, tmp_dir=None) -> dict:
    """Phase 14 on ``device``: the native runtime, the traced posv, the
    checkpoint and print, and the ScaLAPACK steps.  The checkpoint and the
    traces go through a temporary directory under ``tmp_dir`` that is removed
    afterwards."""
    import shutil
    import tempfile

    out = {}
    times, step = _timed(device)
    tmp = tempfile.mkdtemp(dir=tmp_dir)
    try:
        out.update(step("native_s", lambda: native_checks(sizes)))
        out["trace"] = step("trace_s", lambda: trace_posv(device, sizes, tmp))
        out["checkpoint"] = step("checkpoint_s", lambda: checkpoint_print(device, sizes, tmp))
    finally:
        shutil.rmtree(tmp)
    steps = step("scalapack_s", lambda: scalapack_steps(device, sizes))
    for key in ("grid", "world_size", "backend"):
        out[key] = steps.pop(key)
    out["steps"] = steps
    out["times"] = times
    return out


def check_compat_path(res: dict, sizes: dict = COMPAT) -> None:
    require(res["native_backend"] == "native",
            f"native backend {res['native_backend']}, not the compiled library")
    require(res["maps_equal"], "native maps differ from their Python versions")
    for which in ("native", "python"):
        require(res[f"pool_{which}_ok"], f"MemoryPool cycle failed on {which}")
    tr = res["trace"]
    require(tr["trace_native_regions"] == tr["trace_python_regions"] > 0,
            f"native capture {tr['trace_native_regions']} regions, "
            f"trace_block {tr['trace_python_regions']}")
    require(tr["trace_dump_ok"] and tr["trace_dump_events"] == tr["trace_native_regions"]
            and tr["trace_names_equal"], "native trace dump disagrees with trace_block")
    require(tr["tracked_storages"] >= 2 and tr["tracked_pools"],
            "pool tracking did not see the posv storages")
    require(tr["posv_info"] == 0 and tr["posv_error"] <= gate(torch.float32, sizes["n"]),
            f"traced posv backward error {tr['posv_error']:.3e}")
    ck = res["checkpoint"]
    require(ck["checkpoint_bit_equal"], "checkpoint round trip not bit-equal")
    require(ck["print_equal"] and ck["print_has_ellipsis"],
            "print_matrix of the card's matrix differs from the CPU copy's")
    for key, st in res["steps"].items():
        for route in ("single", "grid"):
            require(st[f"{route}_route_ok"], f"p* {key} {route}: wrong route")
            if f"{route}_info" in st:
                require(st[f"{route}_info"] == 0, f"p* {key} {route} info {st[f'{route}_info']}")
        if key in ("gecon", "pocon"):
            # Hager/Higham estimates: within 10x of the true rcond, 2x of each other
            for route in ("single", "grid"):
                require(st[f"{route}_error"] <= 10.0, f"p* {key} {route} estimate "
                        f"{st[f'{route}_value']:.3e} vs {st['true_rcond']:.3e}")
            require(st["agreement"] <= 2.0, f"p* {key} routes disagree")
            continue
        for what in ("single_error", "grid_error"):
            if what in st:
                require(st[what] <= st["gate"], f"p* {key} {what} {st[what]:.3e} > "
                        f"{st['gate']:.3e}")
        if key == "syevd":
            require(st["vectors"] == [None, None], "pssyevd 'n' returned vectors")
            for route in ("single", "grid"):
                require(st[f"{route}_ascending"] and
                        st[f"{route}_trace_err"] <= st["trace_gate"],
                        f"p* syevd {route} values: trace error "
                        f"{st[f'{route}_trace_err']:.3e}")
        bound = st.get("agreement_gate",
                       2 * st["gate"] if key in ("gesv", "getri") else st["gate"])
        require(st["agreement"] <= bound, f"p* {key} routes disagree: "
                f"{st['agreement']:.3e} > {bound:.3e}")


def full_compat_path() -> dict:
    """Phase 14 on a 1x1 NCCL grid, with the kernels' launch counters set to 0
    just before and read just after.  One collective of each kind on each
    axis starts the process group and its communicators first."""
    from slate_tpu_torch import parallel as par

    grid = par.ProcessGrid.cached(1, 1, device="cuda")
    w = torch.ones(256, device="cuda")
    for axis in (par.ROW_AXIS, par.COL_AXIS, par.mesh.FLAT):
        for op in ("sum", "max"):
            par.axis_allreduce(w, grid, axis, op)
        par.axis_allgather(w, grid, axis)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = compat_path("cuda")
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    say("compat_card", nvidia_smi())
    for key in ("native_backend", "maps_equal", "maps_native_s", "maps_python_s",
                "maps_python_over_native", "pool_native_s", "pool_python_s",
                "pool_native_ok", "pool_python_ok", "grid", "world_size", "backend"):
        say(f"compat_{key}", res[key])
    say("compat_trace", json.dumps(res["trace"]))
    say("compat_checkpoint", json.dumps(res["checkpoint"]))
    for key, st in res["steps"].items():
        say(f"compat_{key}", json.dumps(st))
    say("compat_times", json.dumps(res["times"]))
    say("compat_wall_s", wall)
    say("compat_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("compat_launches", json.dumps(launches))
    check_compat_path(res)
    for name in ("col_reduce", "row_sums"):
        require(launches[name] > 0, f"phase 14 did not launch {name}")
    for kind, name in (("one", "col_reduce"), ("inf", "row_sums")):
        for route in ("single", "grid"):
            require(res["steps"][f"lange_{kind}"][f"{route}_launches"][name] > 0,
                    f"pslange {kind} ({route}) did not launch {name}")
    torch.cuda.synchronize()
    par.mesh.destroy()
    return launches

# phase 15: the cost audit and the analysis tier on a 1x1 grid.  The scaling
# registry at its audit shape (n = 128, nb = 32), then three of its specs at
# the smoke's full width, counted.  The counts depend on n and nb only, so
# counted flops over the spec's model must come within flop_tol of the ratio
# these shapes give (the H100 runs of PERF.md §5), and the LAPACK ops each
# routine calls must count flops (FlopCounterMode alone counts them 0).
AUDIT = {"n": N, "nb": NB, "seed": SEED + 150,
         "full": ("gemm_allgather", "potrf_distributed", "getrf_distributed"),
         "flop_ratio": {"gemm_allgather": 1.000, "potrf_distributed": 1.172,
                        "getrf_distributed": 1.407},
         "flop_tol": 0.01,
         "lapack_ops": {"potrf_distributed": ("aten.linalg_cholesky_ex",
                                              "aten.linalg_solve_triangular"),
                        "getrf_distributed": ("aten.linalg_lu_factor_ex",
                                              "aten.linalg_solve_triangular")}}


def _sync_s(fn, device) -> float:
    """Host seconds of ``fn()``, between two device syncs on the card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def audit_path(device, sizes: dict = AUDIT) -> dict:
    """Phase 15's steps on a 1x1 grid of ``device``, through the public
    entry points: ``obs.scaling.rank_passes(1)`` (the scaling registry's 31
    specs, counted once), ``analysis.collective_audit.audit_pass`` (every
    spec's collective log of that pass through the auditor), the linter's
    ``--check`` gate in process, and ``gemm_allgather`` /
    ``potrf_distributed`` / ``getrf_distributed`` at ``sizes`` n, nb: each
    run once uncounted (warm), then timed uncounted and counted, with its
    counted flops over the spec's model flops."""
    from slate_tpu_torch import parallel as par
    from slate_tpu_torch.analysis.__main__ import main as lint_main
    from slate_tpu_torch.analysis.collective_audit import audit_pass
    from slate_tpu_torch.obs import costaudit, scaling

    res = {}
    t0 = time.perf_counter()
    per_rank = scaling.rank_passes(1, device=device)
    res["rows"] = [e["row"] for e in per_rank[0]]
    res["registry_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tier_b = audit_pass(per_rank, 1)
    res["tier_b_s"] = time.perf_counter() - t0
    res["tier_b"] = {r["routine"]: r.get("findings", [r.get("error") or r.get("skipped")])
                     for r in tier_b}
    res["tier_b_sites"] = sum(r.get("collective_sites", 0) for r in tier_b)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res["lint_rc"] = lint_main(["--check"])
    res["lint_s"] = time.perf_counter() - t0
    res["lint_summary"] = out.getvalue().strip().splitlines()[-1]

    n, nb = sizes["n"], sizes["nb"]
    grid = scaling.make_grid(1, device)
    models = {s.name: s.model_flops for s in scaling.build_specs(n, nb)}
    f32 = torch.float32
    A = randn((n, n), f32, device, sizes["seed"])
    B = randn((n, n), f32, device, sizes["seed"] + 1)
    S = spd(n, torch.Generator(device=device).manual_seed(sizes["seed"] + 2), device, f32)
    calls = {"gemm_allgather": lambda: par.gemm_allgather(A, B, grid),
             "potrf_distributed": lambda: par.potrf_distributed(S, grid, nb=nb),
             "getrf_distributed": lambda: par.getrf_distributed(A, grid, nb=nb)}
    res["full"] = {}
    for name in sizes["full"]:
        fn = calls[name]
        _sync_s(fn, device)                                  # warm
        off = _sync_s(fn, device)
        with costaudit.counted() as run:
            on = _sync_s(fn, device)
        h = costaudit.harvest(run)
        res["full"][name] = {
            "n": n, "nb": nb, "flops": h["flops"], "model_flops": models[name],
            "flops_over_model": h["flops"] / models[name],
            "bytes_accessed": h["bytes_accessed"],
            "collective_count": h["collective_count"],
            "collective_bytes": h["collective_bytes"],
            "off_s": off, "on_s": on, "on_over_off": on / off, "ops": run.ops,
            "counted_us_per_op": 1e6 * (on - off) / max(run.ops, 1),
            "flops_by_op": dict(sorted(((op, f) for op, f in run.flops_by_op.items()
                                        if f), key=lambda kv: -kv[1]))}
    del A, B, S
    return res


def check_audit_path(res: dict, sizes: dict = AUDIT) -> None:
    rows = res["rows"]
    from slate_tpu_torch.obs import scaling

    require([r["routine"] for r in rows] == scaling.spec_names(),
            "phase 15 did not audit the whole registry")
    for r in rows:
        require(not r.get("error") and not r.get("skipped"),
                f"audit {r['routine']}: {r.get('error') or r.get('skipped')}")
        require(r["bytes_accessed"] > 0, f"audit {r['routine']}: no bytes counted")
        if r["model_flops"] > 0:
            require(r["flops"] > 0, f"audit {r['routine']}: no flops counted")
    for name, findings in res["tier_b"].items():
        require(findings == [], f"collective audit {name}: {findings[:2]}")
    require(list(res["tier_b"]) == scaling.spec_names(),
            "the collective audit did not cover the registry")
    require(res["lint_rc"] == 0, f"slate-lint --check: {res['lint_summary']}")
    tol = sizes["flop_tol"]
    for name, st in res["full"].items():
        want = sizes["flop_ratio"][name]
        require(abs(st["flops_over_model"] - want) <= tol,
                f"audit {name}: counted / model flops {st['flops_over_model']:.4f}, "
                f"not {want} +- {tol}")
        for op in sizes["lapack_ops"].get(name, ()):
            require(st["flops_by_op"].get(op, 0) > 0,
                    f"audit {name}: {op} counted no flops")
        require(math.isfinite(st["on_over_off"]) and st["on_over_off"] > 0,
                f"audit {name}: no counted time")


def full_audit_path() -> dict:
    """Phase 15 on a 1x1 NCCL grid, with the kernels' launch counters set to 0
    just before and read just after.  One collective of each kind on each
    axis starts the process group and its communicators first."""
    from slate_tpu_torch import parallel as par
    from slate_tpu_torch.obs import scaling

    grid = scaling.make_grid(1, "cuda")
    w = torch.ones(256, device="cuda")
    for axis in (par.ROW_AXIS, par.COL_AXIS, par.mesh.FLAT):
        for op in ("sum", "max"):
            par.axis_allreduce(w, grid, axis, op)
        par.axis_allgather(w, grid, axis)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = audit_path("cuda")
    wall = time.perf_counter() - t0
    launches = dict(cn.LAUNCHES)
    say("audit_card", nvidia_smi())
    for r in res["rows"]:
        say("audit_row", json.dumps({k: r.get(k) for k in (
            "routine", "grid", "flops", "model_flops", "bytes_accessed",
            "collective_count", "collective_bytes", "collectives", "error",
            "skipped")}))
    say("audit_registry_s", res["registry_s"])
    say("audit_tier_b", json.dumps({"routines": len(res["tier_b"]),
                                    "events": res["tier_b_sites"], "s": res["tier_b_s"],
                                    "findings": sum(map(len, res["tier_b"].values()))}))
    say("audit_lint", json.dumps({"rc": res["lint_rc"], "s": res["lint_s"],
                                  "summary": res["lint_summary"]}))
    for name, st in res["full"].items():
        say(f"audit_full_{name}", json.dumps(st))
    say("audit_wall_s", wall)
    say("audit_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("audit_launches", json.dumps(launches))
    check_audit_path(res)
    require(launches["col_reduce"] > 0, "phase 15 did not launch col_reduce")
    torch.cuda.synchronize()
    par.mesh.destroy()
    return launches


# phase 16: the C API (``csrc/slate_c_api.cpp`` over ``c_api.py``) on the card.
# (a) real C programs linked against the port's library, and the port's
# examples, each in its own process; (b) the posv main path's matrix and the
# smoke's full-width operands through the same library loaded in this process
# (ctypes), each C call beside the Python p* call it wraps (no grid), on the
# same inputs: the C-over-Python ratio is the boundary's cost.
CAPI = {"n": N, "nrhs": NRHS, "seed": SEED + 160,
        "programs": {"c_api_check": ("tests/c_api_check.c", "C_API PASS"),
                     "ex05_blas": ("examples/c/ex05_blas.c", "ex05 OK"),
                     "example_gesv": ("examples/c/example_gesv.c", "PASS")},
        "examples": 19, "example_jobs": 6, "timeout": 600, "lange_rtol": 1e-12,
        # slate_sgemm's |C - ref|_F / |ref|_F: about u * sqrt(k) = 7.6e-6 for
        # f32 at k = 16384; a dropped beta * C0 term (2.6e-3 of ref) or a
        # wrong alpha is far above it
        "gemm_rtol": 1e-5}
REPO = os.path.dirname(os.path.abspath(__file__))


def c_programs(lib_path: str, device, out_dir: str, sizes: dict = CAPI) -> dict:
    """Each C program of ``sizes["programs"]`` compiled with gcc against the
    library, then all run at once on ``device`` (``SLATE_TPU_TORCH_DEVICE``)
    with this interpreter's ``sys.path``: its exit code, seconds, whether its
    pass line printed, and c_api_check's per-check verdicts."""
    from concurrent.futures import ThreadPoolExecutor

    from slate_tpu_torch import c_api

    lib_dir, name = os.path.dirname(lib_path), os.path.basename(lib_path)[3:-3]
    env = c_api.child_env(str(device))

    def run(key):
        src, marker = sizes["programs"][key]
        exe = os.path.join(out_dir, key)
        subprocess.run(["gcc", os.path.join(REPO, src), "-I", os.path.join(REPO, "include"),
                        "-L", lib_dir, f"-l{name}", f"-Wl,-rpath,{lib_dir}", "-lm", "-o", exe],
                       capture_output=True, text=True, timeout=120, check=True)
        t0 = time.perf_counter()
        proc = subprocess.run([exe], capture_output=True, text=True, timeout=sizes["timeout"],
                              env=env)
        words = [ln.split() for ln in proc.stdout.splitlines()]
        res = {"rc": proc.returncode, "s": time.perf_counter() - t0,
               "passed": marker.split() in words,
               "stderr": proc.stderr[-1500:] if proc.returncode else ""}
        if key == "c_api_check":
            res["checks"] = {w[0]: "skipped" if w[1] == "skipped" else w[-1]
                             for w in words if len(w) >= 2 and w[0] != "C_API"}
        return res

    with ThreadPoolExecutor(len(sizes["programs"])) as pool:
        futures = {key: pool.submit(run, key) for key in sizes["programs"]}
        return {key: f.result() for key, f in futures.items()}


def run_examples(device, sizes: dict = CAPI) -> dict:
    """``examples_torch/run_tests.py --device <device>`` (``example_jobs`` at
    a time): exit code, seconds, the pass count it printed and the failing
    lines."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.join(REPO, "examples_torch", "run_tests.py"),
                          "--device", str(device), "--jobs", str(sizes["example_jobs"])],
                         capture_output=True, text=True, timeout=sizes["timeout"])
    m = re.search(r"(\d+)/(\d+) examples pass", run.stdout)
    return {"rc": run.returncode, "s": time.perf_counter() - t0,
            "passed": int(m.group(1)) if m else 0, "count": int(m.group(2)) if m else 0,
            "failed": [ln for ln in run.stdout.splitlines() if ln.endswith("FAILED")],
            "tail": "" if run.returncode == 0 else run.stdout[-2000:] + run.stderr[-2000:]}


def capi_calls(lib, device, sizes: dict = CAPI) -> dict:
    """The full-width C calls through ``lib`` (the library in this process):
    ``slate_sposv`` on the posv main path's matrix, ``slate_sgesv``,
    ``slate_sgemm`` and ``slate_dlange`` ('1', 'i', 'f', 'm') on f64 data.
    Each C call and the Python p* call it wraps (``scalapack_api``, no grid,
    on the C-order copy of the same matrix) run in the order C, Python,
    Python, C; each keeps its faster time.  Operands live on the host in
    column-major buffers, as a C caller holds them; results are checked on
    ``device``.  Each step records the norm kernels' launches."""
    from slate_tpu_torch import scalapack_api as sa

    f32, f64 = torch.float32, torch.float64
    n, k = sizes["n"], sizes["nrhs"]
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def colmajor(T):
        """T in a column-major host buffer (transposed on the device)."""
        return T.mT.contiguous().cpu().numpy().T

    def d(x):
        """A host result on the device (a column-major one transposed there)."""
        if x.flags.f_contiguous and not x.flags.c_contiguous:
            return torch.from_numpy(x.T).to(dev).mT
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t0

    steps = {}

    def compare(key, c_call, py_call, reset=None):
        """C, Python, Python, C; the launches of the first C call
        (``launches``) and of both (``c_launches``, what the phase counts:
        the Python calls and the checks are not the C API's)."""
        c_s, py_s, out = [], [], {"c_launches": dict.fromkeys(cn.LAUNCHES, 0)}
        for which in ("c", "py", "py", "c"):
            if reset is not None and which == "c":
                reset()
            before = dict(cn.LAUNCHES)
            r, s = timed(c_call if which == "c" else py_call)
            if which == "c":
                c_s.append(s)
                delta = {x: cn.LAUNCHES[x] - before[x] for x in before}
                for x in delta:
                    out["c_launches"][x] += delta[x]
                out.setdefault("launches", delta)
                out.setdefault("c_result", r)
            else:
                py_s.append(s)
                out.setdefault("py_result", r)
        out.update(c_s=min(c_s), py_s=min(py_s), c_all_s=c_s, py_all_s=py_s,
                   c_over_py=min(c_s) / min(py_s))
        steps[key] = out
        return out

    # sposv 'l': the posv main path's matrix and right-hand sides (phase 1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    S = spd(n, gen, dev, f32)
    B = torch.randn((n, k), generator=gen, device=dev, dtype=f32)
    s_np, b_np = S.cpu().numpy(), B.cpu().numpy()
    a_f, b_f = colmajor(S), colmajor(B)
    a_keep, b_keep = a_f.copy(order="F"), b_f.copy(order="F")

    def reset_posv():
        np.copyto(a_f, a_keep)
        np.copyto(b_f, b_keep)
    st = compare("sposv", lambda: lib.slate_sposv(b"l", n, k, a_f.ctypes.data, n,
                                                  b_f.ctypes.data, n),
                 lambda: sa.psposv("l", s_np, b_np, device=dev), reset_posv)
    X = d(b_f)
    V = randn((n, PROBES), f32, dev, sizes["seed"])
    L = torch.tril(d(a_f))
    st.update(info=st.pop("c_result"), py_info=st.pop("py_result")[1],
              error=backward_error(S, X, B), gate=gate(f32, n),
              factor_error=tfro(torch.matmul(L, torch.matmul(L.mT, V)) - torch.matmul(S, V))
              / (tfro(S) * tfro(V)),
              upper_kept=torch.equal(torch.triu(d(a_f), 1), torch.triu(S, 1)))
    del S, X, L, s_np, a_f, a_keep

    # sgesv: a general matrix, the same right-hand sides
    G = randn((n, n), f32, dev, sizes["seed"] + 1)
    g_np = G.cpu().numpy()
    g_f, g_keep = colmajor(G), None
    g_keep = g_f.copy(order="F")
    ipiv = np.zeros(n, np.int64)

    def reset_gesv():
        np.copyto(g_f, g_keep)
        np.copyto(b_f, b_keep)
    st = compare("sgesv", lambda: lib.slate_sgesv(n, k, g_f.ctypes.data, n, ipiv.ctypes.data,
                                                  b_f.ctypes.data, n),
                 lambda: sa.psgesv(g_np, b_np, device=dev), reset_gesv)
    st.update(info=st.pop("c_result"), py_info=st.pop("py_result")[2],
              error=backward_error(G, d(b_f), B), gate=gate(f32, n),
              ipiv_in_range=bool(ipiv.min() >= 1 and ipiv.max() <= n))
    del G, g_np, g_f, g_keep, b_f, b_keep, B

    # sgemm: C = 1.5 A B - 0.5 C0, against the float64 product on the device
    A = randn((n, n), f32, dev, sizes["seed"] + 2)
    Bm = randn((n, n), f32, dev, sizes["seed"] + 3)
    C0 = randn((n, n), f32, dev, sizes["seed"] + 4)
    a_np, bm_np, c_np = A.cpu().numpy(), Bm.cpu().numpy(), C0.cpu().numpy()
    af, bf, cf = colmajor(A), colmajor(Bm), colmajor(C0)
    c_keep = cf.copy(order="F")
    st = compare("sgemm", lambda: lib.slate_sgemm(b"n", b"n", n, n, n, 1.5, af.ctypes.data, n,
                                                  bf.ctypes.data, n, -0.5, cf.ctypes.data, n),
                 lambda: sa.psgemm("n", "n", 1.5, a_np, bm_np, -0.5, c_np, device=dev),
                 lambda: np.copyto(cf, c_keep))
    ref = torch.matmul(A.double(), Bm.double()).mul_(1.5).sub_(C0.double(), alpha=0.5)
    st.update(info=st.pop("c_result"), error=tfro(d(cf).double() - ref) / tfro(ref),
              gate=sizes["gemm_rtol"])
    st["writeback_s"] = writeback(cf, st.pop("py_result"), dev)
    del A, Bm, C0, a_np, bm_np, c_np, af, bf, cf, c_keep, ref

    # dlange on a 16384^2 f64 matrix: '1' launches col_reduce, 'i' row_sums
    D = randn((n, n), f64, dev, sizes["seed"] + 5)
    d_np, d_f = D.cpu().numpy(), colmajor(D)
    want = {"1": float(D.abs().sum(0).max()), "i": float(D.abs().sum(1).max()),
            "f": float(torch.linalg.matrix_norm(D)), "m": float(D.abs().max())}
    for c in "1ifm":
        st = compare(f"dlange_{c}", lambda: lib.slate_dlange(c.encode(), n, n, d_f.ctypes.data, n),
                     lambda: sa.pdlange(c, d_np, device=dev))
        st.update(value=st.pop("c_result"), py_value=st.pop("py_result"), want=want[c])
        st["rel_error"] = abs(st["value"] - want[c]) / want[c]
    del D, d_np, d_f
    return steps


def writeback(dst: np.ndarray, src: np.ndarray, dev) -> dict:
    """Seconds to write a row-major host result into a column-major host
    buffer three ways: numpy's strided copy, torch's CPU copy, and a trip
    through the device (up, transposed there, down)."""
    def host_view():
        return torch.from_numpy(dst.T)

    ways = {"numpy": lambda: np.copyto(dst, src),
            "torch_cpu": lambda: host_view().copy_(torch.from_numpy(src).T),
            "device": lambda: host_view().copy_(torch.from_numpy(src).to(dev).mT.contiguous())}
    rng = np.random.default_rng(SEED)
    at = tuple(rng.integers(0, size, 4096) for size in src.shape)
    out = {}
    for key, fn in ways.items():
        dst.fill(0)
        t0 = time.perf_counter()
        fn()
        out[key] = time.perf_counter() - t0
        require(np.array_equal(dst[at], src[at]), f"write-back {key} is wrong")
    out["threads"] = torch.get_num_threads()
    return out


def capi_path(device, sizes: dict = CAPI, programs: bool = True, tmp_dir=None) -> dict:
    """Phase 16 on ``device``: build the library; with ``programs`` the C
    programs and the examples (a), side by side, then the full-width calls in
    this process (b), the runtime's device set to ``device`` first."""
    import shutil
    import tempfile

    from slate_tpu_torch import c_api

    out = {}
    t0 = time.perf_counter()
    path = c_api.build()
    out["build_s"] = time.perf_counter() - t0
    out["library"] = path
    if programs:
        from concurrent.futures import ThreadPoolExecutor

        tmp = tempfile.mkdtemp(dir=tmp_dir)
        try:
            with ThreadPoolExecutor(2) as pool:      # the programs beside the examples
                progs = pool.submit(c_programs, path, device, tmp, sizes)
                examples = pool.submit(run_examples, device, sizes)
                out["programs"], out["examples"] = progs.result(), examples.result()
        finally:
            shutil.rmtree(tmp)
    os.environ[c_api.DEVICE_ENV] = str(device)
    lib = c_api.load(path)
    require(lib.slate_init() == 0, "slate_init failed")
    out["version"] = lib.slate_version().decode()
    out["device"] = str(c_api.runtime().device)
    out["steps"] = capi_calls(lib, device, sizes)
    lib.slate_finalize()
    return out


def check_capi_path(res: dict, sizes: dict = CAPI, programs: bool = True) -> None:
    require(res["version"] == "slate_tpu_torch-c-api 2.0", f"version {res['version']}")
    if programs:
        for key, pr in res["programs"].items():
            require(pr["rc"] == 0 and pr["passed"], f"C program {key}: rc {pr['rc']}, "
                    f"{pr.get('checks')} {pr['stderr']}")
        checks = res["programs"]["c_api_check"]["checks"]
        require(checks.pop("grid-posv") == "skipped" and set(checks.values()) == {"ok"},
                f"c_api_check: {checks}")
        ex = res["examples"]
        require(ex["rc"] == 0 and ex["passed"] == ex["count"] == sizes["examples"],
                f"examples_torch: {ex['passed']}/{ex['count']} {ex['failed']} {ex['tail']}")
    st = res["steps"]
    for key in ("sposv", "sgesv"):
        require(st[key]["info"] == 0 and st[key]["error"] <= st[key]["gate"],
                f"slate_{key}: info {st[key]['info']}, backward error {st[key]['error']:.3e}")
    require(st["sposv"]["factor_error"] <= st["sposv"]["gate"] and st["sposv"]["upper_kept"],
            "slate_sposv: the factor in A is wrong or the upper triangle was written")
    require(st["sgesv"]["ipiv_in_range"], "slate_sgesv: pivots out of range")
    require(st["sgemm"]["info"] == 0 and st["sgemm"]["error"] <= st["sgemm"]["gate"],
            f"slate_sgemm: error {st['sgemm']['error']:.3e}")
    for c in "1ifm":
        require(st[f"dlange_{c}"]["rel_error"] <= sizes["lange_rtol"],
                f"slate_dlange {c}: {st[f'dlange_{c}']['value']} vs {st[f'dlange_{c}']['want']}")


def capi_launches(res: dict) -> dict:
    """The norm kernels' launches by the C calls of phase 16 (b), both C
    calls of each step; the p* calls they are timed against and the checks'
    norms are left out."""
    out = dict.fromkeys(cn.LAUNCHES, 0)
    for st in res["steps"].values():
        for x, k in st["c_launches"].items():
            out[x] += k
    return out


def full_capi_path() -> dict:
    """Phase 16 on the card, with the kernels' launch counters set to 0 just
    before and read just after; the path's count is the C calls' own
    (:func:`capi_launches`; the C programs' and the examples' launches are
    their own processes')."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in cn.LAUNCHES:
        cn.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = capi_path("cuda")
    wall = time.perf_counter() - t0
    every = dict(cn.LAUNCHES)
    launches = capi_launches(res)
    say("c_api_card", nvidia_smi())
    for key in ("library", "build_s", "version", "device"):
        say(f"c_api_{key}", res[key])
    for key, pr in res["programs"].items():
        say(f"c_api_program_{key}", json.dumps(pr))
    say("c_api_examples", json.dumps(res["examples"]))
    for key, st in res["steps"].items():
        say(f"c_api_{key}", json.dumps(st))
    say("c_api_wall_s", wall)
    say("c_api_peak_memory_gib", torch.cuda.max_memory_allocated() / 2**30)
    say("c_api_launches", json.dumps(launches))
    say("c_api_launches_with_checks", json.dumps(every))
    check_capi_path(res)
    for c, name in (("1", "col_reduce"), ("i", "row_sums")):
        require(res["steps"][f"dlange_{c}"]["launches"][name] > 0,
                f"slate_dlange '{c}' did not launch {name}")
    torch.cuda.synchronize()
    return launches


# the serve chaos check's flight-recorder dump (git ignores this file)
FLIGHT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "flight_records.json")


# ---------------------------------------------------------------------------
# phase 17: the pivot kernels and getrf's lookahead route
# ---------------------------------------------------------------------------

LU_ROUTE = {"check_n": (4096, 49152), "info_n": 4096,
            "crossover_n": (2048, 4096, 8192, 16384, 49152),
            "sweep_n": 49152, "nb_sweep": (256, 384, 512, 768, 1024), "reps": 3,
            "move_n": 49152, "move_nb": (256, 512, 1024), "mover_shape": (4096, 3000),
            "hpl_mover": (49152, 1024), "panel_shape": (16384, 1024)}
# (w, mw, row0) of the pivot-list cases: one row, a last square panel (every
# target inside it), the HPL cell's panels at nb 256 / 512 / 1024 (the width
# Target.Auto takes there) at the top and near the bottom, and the widest
# panel the driver takes
PIVOT_CASES = ((1, 1, 0), (7, 7, 93), (256, 49152, 0), (512, 49152, 0),
               (1024, 49152, 0), (512, 700, 48452), (1024, 1500, 47652),
               (4096, 49152, 0))


def random_ipiv(w: int, mw: int, seed: int) -> torch.Tensor:
    """A valid LAPACK ipiv (1-based, ipiv[k] >= k + 1) of ``w`` swaps in a
    window of ``mw`` rows, with self swaps and one target named again and
    again; int32 on the CPU."""
    rng = np.random.default_rng(seed)
    piv = np.array([rng.integers(k, mw) for k in range(w)], dtype=np.int64)
    piv[::5] = np.arange(w)[::5]
    piv[1::7] = mw - 1
    return torch.from_numpy((piv + 1).astype(np.int32))


def pivot_kernel_checks(device, cases=PIVOT_CASES,
                        mover_shape=LU_ROUTE["mover_shape"],
                        hpl_mover=LU_ROUTE["hpl_mover"],
                        panel_shape=LU_ROUTE["panel_shape"]) -> dict:
    """pivot_moves and move_rows against their plain versions, bit for bit,
    move_rows also at the HPL cell's shape (the 2 nb pairs of a first panel
    over the n x (n - 2 nb) f64 columns the main stream moves at nb =
    ``hpl_mover[1]``), and getrf_panel against the library LU."""
    out = {}
    for i, (w, mw, row0) in enumerate(cases):
        ipiv = random_ipiv(w, mw, i)
        got = cp.pivot_moves(ipiv.to(device), row0, mw).cpu()
        want = cp.pivot_moves_plain(ipiv, row0, mw)
        require(torch.equal(got, want), f"pivot_moves differs at w={w} mw={mw}")
        perm = cp.move_rows_plain(torch.arange(row0 + mw), want)[row0:] - row0
        replay = llu._ipiv_perm(ipiv, mw, trace.Timers())
        require(torch.equal(perm, torch.from_numpy(replay)),
                f"the row-move list of w={w} mw={mw} is not the host replay")
        out[f"pivot_moves_w{w}_mw{mw}_live"] = int((want[:, 0] >= 0).sum())
    m, ncols = mover_shape
    row0 = m // 4
    ipiv = random_ipiv(min(512, (m - row0) // 2), m - row0, 99)
    moves = cp.pivot_moves(ipiv.to(device), row0, m - row0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    for dtype in (torch.float32, torch.float64, torch.complex128, torch.int64):
        if dtype == torch.int64:
            M = torch.randint(0, 2**62, (m, ncols + 37), generator=gen, device=device)
        else:
            M = torch.randn((m, ncols + 37), generator=gen, device=device, dtype=dtype)
        k, p = M.clone(), M.clone()
        cp.move_rows(k[:, 17:17 + ncols], moves)
        cp.move_rows_plain(p[:, 17:17 + ncols], moves)
        require(torch.equal(k, p), f"move_rows differs in {dtype}")
        require(not torch.equal(k, M), f"move_rows moved nothing in {dtype}")
    v = torch.arange(m, device=device)
    k, p = cp.move_rows(v.clone(), moves), cp.move_rows_plain(v.clone(), moves)
    require(torch.equal(k, p), "move_rows differs on a vector")
    del M, k, p
    n, nb = hpl_mover
    moves = cp.pivot_moves(random_ipiv(nb, n, 98).to(device), 0, n)
    out[f"move_rows_hpl_n{n}_pairs"] = moves.shape[0]
    k = hpl_matrix(n, SEED + 1, device)
    p = k.clone()
    cp.move_rows(k[:, 2 * nb:], moves)
    cp.move_rows_plain(p[:, 2 * nb:], moves)
    require(torch.equal(k, p), f"move_rows differs on {moves.shape[0]} f64 pairs "
                               f"over {n} rows")
    del k, p
    v = torch.arange(n, device=device)
    k, p = cp.move_rows(v.clone(), moves), cp.move_rows_plain(v.clone(), moves)
    require(torch.equal(k, p) and not torch.equal(k, v),
            f"move_rows differs on the perm vector of {n}")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out.update(panel_lu_checks(device, panel_shape))
    return out


def panel_lu_checks(device, shape) -> dict:
    """cuda_pivots.getrf_panel (cuSOLVER's getrf called directly on the card)
    against ``torch.linalg.lu_factor_ex`` of the same panel, in each dtype the
    driver takes: equal pivots and a factor within 20 eps sqrt(m) of it in
    Frobenius norm relative to the panel."""
    out = {}
    m, n = shape
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    for dtype in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        P = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        lu, piv = cp.getrf_panel(P)
        ref, ref_piv, _ = torch.linalg.lu_factor_ex(P)
        diff = float(torch.linalg.norm(lu - ref) / torch.linalg.norm(P))
        out[f"panel_lu_{str(dtype)[6:]}_diff"] = diff
        gate = 20 * torch.finfo(dtype).eps * math.sqrt(m)
        require(torch.equal(piv, ref_piv) and diff < gate,
                f"getrf_panel differs from the library LU of a {m} x {n} {dtype} "
                f"panel: pivots equal {torch.equal(piv, ref_piv)}, factor {diff}")
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float or complex tensor (a view where it is
    contiguous), so NaNs compare too."""
    r = torch.view_as_real(t) if t.is_complex() else t
    return r.contiguous().view(torch.int32 if r.element_size() == 4 else torch.int64)


def _guard_inputs(dtype, layout: str, shape, device, gen):
    """A (m, n) matrix of ``dtype`` in ``layout``: row-major, a view of
    padded rows, a view one element off a 16-byte boundary, a transposed view,
    one row, or one strided column."""
    m, n = shape
    def draw(*sh):
        return torch.randn(sh, generator=gen, device=device, dtype=dtype)
    if layout == "padded":
        return draw(m, n + 3)[:, :n]
    if layout == "unaligned":
        return draw(m, n + 1)[:, 1:]
    if layout == "transposed":
        return draw(n, m).mT
    if layout == "one_row":
        return draw(1, n)
    if layout == "one_column":
        return draw(m, 3)[:, 1:2]
    return draw(m, n)


def nan_guard_checks(device, shape=(37, 29), hpl_n=LU_ROUTE["move_n"]) -> dict:
    """copy_scan_nan and guard_lost_nan against their plain versions, bit for
    bit (the copy, the first NaN column, the guarded factor; the factor also
    against ``lu._mark_lost_nan``): at ``shape`` in f32 / f64 / c64 / c128 over
    six layouts, clean, with a NaN lost or kept by the factor, in the first
    or the last column, several, ±Inf, an imaginary NaN; then at the HPL
    cell's hpl_n² f64, clean and with a NaN the factor lost, whose ``info``
    names the first NaN column."""
    out = {}
    nan = float("nan")
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    cases = 0
    for dtype in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        for layout in ("row_major", "padded", "unaligned", "transposed", "one_row",
                       "one_column"):
            for case in ("clean", "lost", "kept", "first", "last", "several", "inf",
                         "imaginary"):
                if case == "imaginary" and not dtype.is_complex:
                    continue
                A = _guard_inputs(dtype, layout, shape, device, gen)
                m, n = A.shape
                at = {"lost": [(m // 2, n // 2)], "kept": [(m // 2, n // 2)],
                      "first": [(m - 1, 0)], "last": [(0, n - 1)],
                      "several": [(0, n - 1), (m - 1, n // 3), (m // 2, n // 2)],
                      "imaginary": [(m // 3, n // 2)]}.get(case, [])
                for r, c in at:
                    A[r, c] = complex(float(A[r, c].real), nan) \
                        if case == "imaginary" else nan
                if case == "inf":
                    A[0, 0], A[m - 1, n - 1] = float("inf"), -float("inf")
                k_copy, k_first = cp.copy_scan_nan(A)
                p_copy, p_first = cp.copy_scan_nan_plain(A)
                where = f"{dtype} {layout} {case}"
                require(k_copy.is_contiguous() and torch.equal(_bits(k_copy), _bits(p_copy)),
                        f"copy_scan_nan's copy differs: {where}")
                require(torch.equal(k_first, p_first) and
                        int(k_first) == (min(c for _, c in at) + 1 if at else 0),
                        f"copy_scan_nan's first column {int(k_first)} differs from "
                        f"{int(p_first)}: {where}")
                P = torch.randn((m, n), generator=gen, device=device, dtype=dtype)
                if case == "kept":
                    P[m - 1, n - 1] = nan
                K = cp.guard_lost_nan(P.clone(), k_first)
                require(torch.equal(_bits(K), _bits(cp.guard_lost_nan_plain(P.clone(),
                                                                            p_first))),
                        f"guard_lost_nan differs from its plain version: {where}")
                require(torch.equal(_bits(K), _bits(llu._mark_lost_nan(A, P.clone()))),
                        f"guard_lost_nan differs from _mark_lost_nan: {where}")
                cases += 1
    out["nan_guard_small_cases"] = cases
    n = hpl_n
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    A = hpl_matrix(n, SEED + 3, device)
    copy, first = cp.copy_scan_nan(A)
    require(int(first) == 0 and torch.equal(copy, A),
            f"copy_scan_nan at {n}^2 f64: first {int(first)}, copy equal "
            f"{torch.equal(copy, A)}")
    cp.guard_lost_nan(copy, first)
    require(torch.equal(copy, A), f"guard_lost_nan wrote into a clean {n}^2 factor")
    del copy
    c = n // 2 + 7
    A[n // 3, c] = nan
    A[n - 1, c + 11] = nan
    copy, first = cp.copy_scan_nan(A)
    want = int(first_bad_index_batched(torch.isnan(A).any(dim=-2)))
    require(int(first) == want == c + 1 and torch.equal(_bits(copy), _bits(A)),
            f"copy_scan_nan at {n}^2 f64 with a NaN: first {int(first)}, plain {want}")
    del copy
    P = hpl_matrix(n, SEED + 4, device)         # a finite factor: the NaN lost
    K = cp.guard_lost_nan(P.clone(), first)
    llu._mark_lost_nan(A, P)
    info = int(llu._lu_info(K.diagonal()))
    require(torch.equal(_bits(K), _bits(P)) and info == c + 1,
            f"guard_lost_nan at {n}^2 f64 with a lost NaN: equal "
            f"{torch.equal(_bits(K), _bits(P))}, info {info} (want {c + 1})")
    out[f"nan_guard_hpl_n{n}_info"] = info
    del A, P, K
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def nan_guard_times(n: int = LU_ROUTE["move_n"]) -> dict:
    """At the HPL cell's n² f64: copy_scan_nan beside the ``clone`` it
    replaces (interleaved rounds) and its bound (A read once, the copy written
    once); the guard's early exit on a clean factor; the plain versions and
    the library route's ``_mark_lost_nan`` on the same clean inputs."""
    out = {}
    A = hpl_matrix(n, SEED, "cuda")
    ks, ls = interleaved(lambda: cp.copy_scan_nan(A),
                         lambda: A.clone(memory_format=torch.contiguous_format))
    out["copy_scan_nan_ms"] = statistics.median(ks)
    out["copy_scan_nan_range_ms"] = (min(ks), max(ks))
    out["clone_ms"] = statistics.median(ls)
    out["clone_range_ms"] = (min(ls), max(ls))
    out["copy_scan_nan_bound_ms"] = cp.move_bound_ms(n, n, 8)
    out["copy_scan_nan_plain_ms"] = time_ms(lambda: cp.copy_scan_nan_plain(A), reps=3)
    copy, first = cp.copy_scan_nan(A)
    out["guard_lost_nan_clean_ms"] = time_ms(lambda: cp.guard_lost_nan(copy, first),
                                             reps=200)
    out["guard_lost_nan_plain_ms"] = time_ms(
        lambda: cp.guard_lost_nan_plain(copy, first), reps=3)
    out["mark_lost_nan_ms"] = time_ms(lambda: llu._mark_lost_nan(A, copy), reps=3)
    del A, copy
    torch.cuda.empty_cache()
    return out


def pivot_kernel_times(n: int = LU_ROUTE["move_n"],
                       nbs=LU_ROUTE["move_nb"]) -> dict:
    """Each kernel's time on the card (CUDA events, mean of 20 calls after
    warm-up) at the HPL cell's shapes: the list of a panel of nb columns over
    n rows, and the rows it moves across the full width of an n x n f64
    matrix, beside the bound (the moved rows read once and written once)."""
    out = {}
    A = torch.empty((n, n), dtype=torch.float64, device="cuda").uniform_(-0.5, 0.5)
    for nb in nbs:
        ipiv = random_ipiv(nb, n, nb).cuda()
        out[f"pivot_moves_nb{nb}_ms"] = time_ms(lambda: cp.pivot_moves(ipiv, 0, n))
        out[f"pivot_moves_nb{nb}_plain_ms"] = time_ms(
            lambda: cp.pivot_moves_plain(ipiv, 0, n), reps=3)
        moves = cp.pivot_moves(ipiv, 0, n)
        rows = int((moves[:, 0] >= 0).sum())
        out[f"move_rows_nb{nb}_rows"] = rows
        out[f"move_rows_nb{nb}_ms"] = time_ms(lambda: cp.move_rows(A, moves))
        out[f"move_rows_nb{nb}_bound_ms"] = cp.move_bound_ms(rows, n, 8)
        out[f"move_rows_nb{nb}_plain_ms"] = time_ms(
            lambda: cp.move_rows_plain(A, moves), reps=3)
    del A
    torch.cuda.empty_cache()
    return out


def hpl_matrix(n: int, seed: int, device) -> torch.Tensor:
    """A uniform in (-0.5, 0.5), as HPL draws it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, n), generator=gen, device=device,
                      dtype=torch.float64).sub_(0.5)


def probe_error(A: torch.Tensor, LU: torch.Tensor, perm: torch.Tensor,
                k: int = 4, block: int = 4096) -> float:
    """||A[perm] X - L (U X)||_F / (||A||_F ||X||_F) for k random probe
    columns, the triangles of the square factor cut out a row block at a
    time (no n x n temporary)."""
    n = A.shape[0]
    gen = torch.Generator(device=A.device).manual_seed(SEED)
    X = torch.randn((n, k), generator=gen, device=A.device, dtype=A.dtype)
    UX, LUX = torch.empty_like(X), torch.empty_like(X)
    for r0 in range(0, n, block):
        UX[r0:r0 + block] = torch.triu(LU[r0:r0 + block], diagonal=r0) @ X
    for r0 in range(0, n, block):
        LUX[r0:r0 + block] = (torch.tril(LU[r0:r0 + block], diagonal=r0 - 1) @ UX
                              + UX[r0:r0 + block])
    err = torch.linalg.norm((A @ X)[perm] - LUX)
    return float(err / (torch.linalg.norm(A) * torch.linalg.norm(X)))


def getrf_ms(A: torch.Tensor, opts: dict, reps: int) -> list:
    """Device time (ms, CUDA events on the caller's stream) of whole getrf
    calls, each after the last ended."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = slate.getrf(A, opts)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
        del res
    return out


def lu_route_checks(device, sizes: dict = LU_ROUTE) -> dict:
    """The lookahead route against the library route: probe error, info (on
    a diagonally dominant matrix, a singular copy and a copy with a NaN on
    the diagonal), the route's own devices for perm and info, and no host
    sync in ``getrf`` or ``gesv``."""
    out = {}
    tiled, library = {"target": "tiled"}, {"target": "xla"}
    n = sizes["info_n"]
    A = hpl_matrix(n, SEED, device)
    A.diagonal().add_(float(n))
    sing, nan = A.clone(), A.clone()
    sing[:, n // 3] = 0.0
    sing[n // 3, :] = 0.0
    nan[n // 2, n // 2] = float("nan")
    for name, M in (("regular", A), ("singular", sing), ("nan", nan)):
        i_t = int(slate.getrf(M, tiled)[2])
        i_l = int(slate.getrf(M, library)[2])
        out[f"info_{name}"] = (i_t, i_l)
        require(i_t == i_l, f"info {i_t} (lookahead) != {i_l} (library) on {name}")
        require((i_t == 0) == (name == "regular"), f"info {i_t} on the {name} matrix")
    del sing, nan
    if torch.device(device).type == "cuda":
        slate.getrf(A, tiled)
        torch.cuda.synchronize()
        b = torch.ones((n, 1), dtype=A.dtype, device=A.device)
        slate.gesv(A, b, tiled)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            LU, perm, info = slate.getrf(A, tiled)
            X, _, x_info = slate.gesv(A, b, tiled)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        require(perm.is_cuda and info.is_cuda and perm.dtype == torch.int64
                and X.is_cuda and x_info.is_cuda, "perm and info left the card")
        out["no_sync"] = True
    routes = slate.obs.REGISTRY.counter("slate_lu_route_total")
    for n in sizes["check_n"]:
        A = hpl_matrix(n, SEED + n, device)
        # Target.Auto itself where it takes the lookahead route, with its panel
        # width; Tiled (block_size 256) below the crossover
        auto = llu._lu_route(A.device.type, A.shape, Target.Auto) == "lookahead"
        infos = []
        for route, opts in (("lookahead", {} if auto else tiled), ("library", library)):
            before = routes.value(route=route)
            LU, perm, info = slate.getrf(A, opts)
            require(routes.value(route=route) == before + 1,
                    f"getrf with {opts} at n={n} did not take the {route} route")
            err = probe_error(A, LU, perm)
            out[f"probe_error_{route}_n{n}"] = err
            infos.append(int(info))
            gate = 20 * torch.finfo(A.dtype).eps * math.sqrt(n)
            require(int(info) == 0 and err < gate,
                    f"{route} at n={n}: info {int(info)}, probe error {err} (gate {gate})")
            del LU, perm, info
        out[f"info_n{n}"] = tuple(infos)
        if auto:
            out[f"auto_nb_n{n}"] = llu._panel_width(Target.Auto, 256, n, n)
        del A
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def lu_route_times(sizes: dict = LU_ROUTE) -> dict:
    """Factor time of both routes at each size (the crossover), the panel
    width sweep at the HPL cell's N, the route Target.Auto takes there, its
    peak memory and the kernels' launches on one call."""
    out = {}
    reps = sizes["reps"]
    for n in sizes["crossover_n"]:
        A = hpl_matrix(n, SEED, "cuda")
        nb = llu._panel_width(Target.Auto, 256, n, n)     # what Auto takes there
        lib = getrf_ms(A, {"target": "xla"}, reps + 1)[1:]
        la = getrf_ms(A, {"target": "tiled", "block_size": nb}, reps + 1)[1:]
        out[f"crossover_n{n}_nb"] = nb
        out[f"crossover_n{n}_library_ms"] = statistics.median(lib)
        out[f"crossover_n{n}_lookahead_ms"] = statistics.median(la)
        del A
        torch.cuda.empty_cache()
    n = sizes["sweep_n"]
    A = hpl_matrix(n, SEED, "cuda")
    for nb in sizes["nb_sweep"]:
        ms = getrf_ms(A, {"target": "tiled", "block_size": nb}, reps)
        out[f"sweep_n{n}_nb{nb}_ms"] = ms
    reg = slate.obs.REGISTRY.counter("slate_lu_route_total")
    before = reg.value(route="lookahead")
    for k in cp.LAUNCHES:
        cp.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = slate.getrf(A)
    torch.cuda.synchronize()
    out["auto_route_lookahead_calls"] = reg.value(route="lookahead") - before
    out["auto_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["auto_launches"] = dict(cp.LAUNCHES)
    require(out["auto_route_lookahead_calls"] == 1,
            f"Target.Auto did not take the lookahead route at n={n}")
    del res, A
    torch.cuda.empty_cache()
    return out


def full_lu_route_path() -> dict:
    t0 = time.perf_counter()
    for k in cp.LAUNCHES:
        cp.LAUNCHES[k] = 0
    res = pivot_kernel_checks("cuda")
    res.update(nan_guard_checks("cuda"))
    checks = dict(cp.LAUNCHES)
    require(all(v > 0 for v in checks.values()), f"a pivot kernel did not launch: {checks}")
    res["check_launches"] = checks
    res.update(pivot_kernel_times())
    res.update(nan_guard_times())
    res.update(lu_route_checks("cuda"))
    res.update(lu_route_times())
    res["phase_s"] = time.perf_counter() - t0
    _say_all("lu", res)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    head = header()
    if sys.argv[1:] == ["--only", "lu"]:
        full_lu_route_path()
        say("total_s", time.perf_counter() - t_start)
        print(head["smi"])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    stats = kernel_phase()
    times = timing_phase()
    small_checks()
    cn.LAUNCHED.clear()
    paths = {"posv": full_path(), "general": full_general_path(),
             "serve": full_serve_path(), "eig": full_eig_path(),
             "tester": full_tester_path(), "dist": full_dist_path(),
             "dist_eig": full_dist_eig_path(), "compat": full_compat_path(),
             "audit": full_audit_path(), "c_api": full_capi_path()}
    full_lu_route_path()
    path_shapes_phase(set(cn.LAUNCHED), stats)
    kernels = []
    for name in ("col_reduce", "row_sums"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            # the serve and eig paths launch neither kernel (their counts,
            # 0, are kept in launches_by_path); the tester's norm and
            # gecondest rows, the distributed norms, phase 13's scaling
            # and gates, phase 14's p?lange, condition estimates and gates,
            # phase 15's norm_distributed spec and phase 16's slate_dlange do
            "launches": sum(p[name] for p in paths.values()),
            "launches_by_path": {path: p[name] for path, p in paths.items()},
            "max_abs_err": stats[name]["max_abs_err"],
            "max_rel_err": stats[name]["max_rel_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_ratio": t["library_ratio"], "vector_width": t["vector_width"],
        })
    say("total_s", time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(head["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
