#!/usr/bin/env python3
"""How accurate the library's Hermitian eigensolve is on one CUDA card, and
what ``stedc._library_eigh`` (single precision widened to double for
n <= 512 on the card) does about it.

    python3 chip_eigh_sweep.py

Three parts, each printed as ``key: value`` lines:

1. ``sweep_<n>_<kind>_*``: for n from 8 to 1024, a seeded symmetric normal
   matrix (``dense``) and a seeded symmetric tridiagonal (``tridiag``) in
   float32 on the card, the largest eigenvalue error of ``eigvalsh``, of
   ``eigh`` and of ``eigvalsh`` in float64, each over max|λ| of the float64
   solve on the host; then the seconds of one ``eigvalsh`` at n = 512 in
   float32 and float64.
2. ``sterf_*``: the tridiagonal of ``chip_smoke.py``'s two-stage matrix cut
   to n = 512 (``sym_normal(512, SEED + 52)``, he2hb at nb 64, the
   pipelined chase), its eigenvalues through ``sterf`` with and without the
   widening, through Sturm bisection, and on the host, each as the largest
   error over max|λ| and as the Σλ² error, against the gate 50·eps·√n.
3. ``unwidened_*``: ``chip_smoke.py``'s phase 13 at small sizes with the
   widening switched off; its check must fail (``unwidened_check_failed:
   True``).

Exits non-zero without CUDA, or when part 3's check passes.
"""

from __future__ import annotations

import importlib
import sys
import time

import torch


def say(key: str, value) -> None:
    print(f"{key}: {value}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_eigh_sweep: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from slate_tpu_torch.linalg import eig as leig
    from slate_tpu_torch.linalg import sturm
    from slate_tpu_torch.parallel import mesh

    stedc = importlib.import_module("slate_tpu_torch.linalg.stedc")
    say("card", cs.nvidia_smi())
    say("torch", f"{torch.__version__} cuda {torch.version.cuda}")

    def err(lam, ref) -> float:
        return float((lam.double().cpu() - ref).abs().max() / ref.abs().max())

    def sumsq_err(lam, ref) -> float:
        r2 = float((ref ** 2).sum())
        return abs(float((lam.double().cpu() ** 2).sum()) - r2) / r2

    gen = torch.Generator().manual_seed(1)
    for n in (8, 16, 32, 33, 64, 128, 200, 256, 257, 384, 500, 511, 512, 513, 600, 1024):
        for kind in ("dense", "tridiag"):
            if kind == "dense":
                M = torch.randn(n, n, generator=gen, dtype=torch.float64)
                A = (M + M.T) / 2
            else:
                A = leig._assemble_tridiag(torch.randn(n, generator=gen, dtype=torch.float64),
                                           torch.randn(n - 1, generator=gen,
                                                       dtype=torch.float64))
            ref = torch.linalg.eigvalsh(A)
            a = A.float().cuda()
            say(f"sweep_{n}_{kind}_eigvalsh_f32", err(torch.linalg.eigvalsh(a), ref))
            say(f"sweep_{n}_{kind}_eigh_f32", err(torch.linalg.eigh(a)[0], ref))
            say(f"sweep_{n}_{kind}_eigvalsh_f64", err(torch.linalg.eigvalsh(a.double()), ref))
    T = leig._assemble_tridiag(torch.randn(512, generator=gen),
                               torch.randn(511, generator=gen)).cuda()
    for dt in (torch.float32, torch.float64):
        x = T.to(dt)
        torch.linalg.eigvalsh(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            torch.linalg.eigvalsh(x)
        torch.cuda.synchronize()
        say(f"sweep_eigvalsh_512_{str(dt).removeprefix('torch.')}_ms",
            (time.perf_counter() - t0) / 10 * 1e3)

    n, nb = 512, leig.default_band_nb(512)
    A = cs.sym_normal(n, torch.float32, "cuda", cs.SEED + 52)
    band, _, _ = leig.he2hb(A, nb=nb)
    d, e = leig.hb2st(band, kd=nb, want_vectors=False, pipeline=True)
    ref = torch.linalg.eigvalsh(leig._assemble_tridiag(d.double().cpu(), e.double().cpu()))
    old = stedc._LIB_EIGH_WIDEN_MAX
    runs = {"widened": lambda: leig.sterf(d, e), "bisection": lambda: sturm.sterf_bisect(d, e),
            "host": lambda: leig.sterf(d.cpu(), e.cpu())}
    for name, fn in runs.items():
        lam = fn()
        say(f"sterf_{name}_err", err(lam, ref))
        say(f"sterf_{name}_sumsq_err", sumsq_err(lam, ref))
    stedc._LIB_EIGH_WIDEN_MAX = 0
    try:
        lam = leig.sterf(d, e)
        say("sterf_unwidened_err", err(lam, ref))
        say("sterf_unwidened_sumsq_err", sumsq_err(lam, ref))
        say("sterf_gate", cs.gate(torch.float32, n))

        sizes = {"two_stage_n": 256, "small_n": 256, "method_n": 64, "range_k": 16,
                 "band_k": 16, "nb": 32, "solve_nb": 64, "sterf_n": 512}
        res = cs.dist_eig_path("cuda", sizes)
        for key, v in res.items():
            if key.startswith("small_"):
                say(f"unwidened_{key}", v)
        try:
            cs.check_dist_eig_path(res, sizes)
            failed = False
        except AssertionError as exc:
            say("unwidened_check", exc)
            failed = True
        say("unwidened_check_failed", failed)
    finally:
        stedc._LIB_EIGH_WIDEN_MAX = old
        mesh.destroy()
    return 0 if failed else 1


if __name__ == "__main__":
    sys.exit(main())
