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
   with the kernels' launch counters set to 0 just before and read just after.

The last lines are a JSON line of per-kernel numbers, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import slate_tpu_torch as slate
from slate_tpu_torch.linalg import chol
from slate_tpu_torch.ops import cuda_norms as cn

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
# the main path's shapes (A, and R and X of B - A X), the ragged test shapes, and
# tall-skinny / short-wide inputs that split the reduced dimension
KERNEL_SHAPES = [(N, N), (N, NRHS), (5, 3), (1, 129), (257, 131), (8, 8), (300, 200),
                 (3, 200), (131072, 64), (64, 70000)]

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


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    out, times = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        r = fn()
        _sync(A)
        times[name] = time.perf_counter() - t0
        return r

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
    t0 = time.perf_counter()
    path = cn.build()
    say("kernel_build_s", time.perf_counter() - t0)
    say("kernel_library", path)
    for line in cn.BUILD_LOG.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    head = header()
    stats = kernel_phase()
    times = timing_phase()
    small_checks()
    launches = full_path()
    kernels = []
    for name in ("col_reduce", "row_sums"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
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
