"""slate_tpu_torch — the PyTorch/CUDA port of slate_tpu (SLATE-style dense linear
algebra), for NVIDIA Hopper.

The port has the public surface of ``slate_tpu`` for the routines it covers so far:
the matrix wrappers and enums, the BLAS-3 and norm drivers, the Cholesky family
(``potrf``/``potrs``/``posv``/``trtri``/``trtrm``/``potri`` and the
mixed-precision ``posv_mixed``/``posv_mixed_gmres``), the LU family (``getrf``
with partial, tournament (CALU) or no pivoting, ``getrs``/``gesv``/``getri`` and
the ``gesv_nopiv``/``gesv_mixed``/``gesv_mixed_gmres``/``gesv_rbt`` ladders), the
QR/least-squares family (``geqrf``/``gelqf``/``unmqr``/``unmlq``/``tsqr``/
``cholqr``/``gels``), the condition estimators, the Hermitian eigensolvers and
the SVD (``heev``/``svd`` fused and two-stage, ``stedc``/``steqr``/``sterf``,
bisection, the subset and generalized solvers), the band solvers
(``gbsv``/``pbsv`` and the band BLAS), the Hermitian-indefinite solvers
(``hesv``), the verb-style aliases (:mod:`slate_tpu_torch.simplified`), the
escalation-ladder engine
(:mod:`slate_tpu_torch.robust`), and the batched solver service
(:mod:`slate_tpu_torch.serve`: batched drivers, prepared-program cache,
serving queue with admission control, executor pool, flight recorder), the
test-matrix generator (:mod:`slate_tpu_torch.matgen`), the emulated-f64 gemm and
refinement solves (``gemm_f64emu``/``gesv_f64ir``/``posv_f64ir``), the routine
tester (``python -m slate_tpu_torch.testing``), the LAPACK- and ScaLAPACK-style
APIs (:mod:`slate_tpu_torch.lapack_api`, :mod:`slate_tpu_torch.scalapack_api`),
the native host runtime (:mod:`slate_tpu_torch.native`) and the printing,
checkpoint and debug utilities (``print_matrix``, ``save_matrix`` /
``load_matrix``, :mod:`slate_tpu_torch.utils.debug`).  Entry
points place new data on ``cuda`` unless a ``device`` is given; matrix and
triangular norms of real f32/f64 data on the card run hand-written CUDA kernels
(:mod:`slate_tpu_torch.ops.cuda_norms`).  It imports neither JAX nor the JAX
package.
"""

from .core import (BandMatrix, BaseMatrix, ConvergenceError,
                   DeadlineExceededError, Diag, GridOrder,
                   HermitianBandMatrix, HermitianMatrix, Layout, Matrix,
                   MethodCholQR, MethodEig, MethodGels, MethodGemm, MethodHemm,
                   MethodLU, MethodSVD, MethodTrsm, Norm, NormScope,
                   NumericalError, Op, Options, QueueOverloadError, Side,
                   SingularMatrixError, SlateError, SymmetricMatrix, Target,
                   TileKind, TrapezoidMatrix, TriangularBandMatrix,
                   TriangularMatrix, Uplo, func)
from .blas import (add, col_norms, copy, gemm, gemmA, gemmC, hemm, hemmA,
                   hemmC, her2k, herk, norm, scale, scale_row_col, set,
                   set_from_function, set_lambdas, symm, syr2k, syrk, trmm,
                   trsm, trsmA, trsmB)
# the JAX package's top-level names; the cores, the pivot encodings, tsqr,
# rbt_generate, TriangularFactors, BandLU and HermitianFactors live in .linalg,
# as they do there
from .linalg import (bdsqr, cholqr, gbmm, gbsv, gbtrf, gbtrs, ge2tb, ge2tb_band,
                     gecondest, gelqf, gels, gels_cholqr, gels_qr, geqrf, gerbt,
                     gesv, gesv_mixed, gesv_mixed_gmres, gesv_nopiv, gesv_rbt,
                     getrf, getrf_nopiv, getrf_tntpiv, getri, getri_oop, getrs,
                     getrs_nopiv, hb2st, hbmm, he2hb, he2hb_q, heev, heev_range,
                     eig_count, hegst, hegv_range, hegv, hesv, hetrf, hetrs,
                     norm1est, pbsv, pbtrf, pbtrs, pocondest, posv, posv_mixed,
                     posv_mixed_gmres, potrf, potri, potrs, stedc, stedc_deflate,
                     stedc_merge, stedc_secular, stedc_solve, stedc_sort,
                     stedc_z_vector, stein, steqr, steqr2, sterf, sterf_bisect,
                     svd, svd_range, svd_vals, syev, sygst, sygv, sysv, sytrf,
                     sytrs, tb2bd, tbsm, tbsm_pivots, tbsmPivots, trcondest,
                     trtri, trtrm, unmbr_ge2tb, unmbr_tb2bd, unmlq, unmqr,
                     unmtr_hb2st, unmtr_he2hb)
from . import linalg, obs, robust, serve
from . import simplified
from .robust import (FaultPlan, FaultSpec, RetryPolicy, SolveReport,
                     reduce_info)
from .serve import gels_batched, gesv_batched, posv_batched
from . import matgen
from . import native
from .utils import debug, load_matrix, print_matrix, save_matrix, trace
from .matgen import generate_matrix
from .ops.f64emu import gemm_f64emu, gesv_f64ir, posv_f64ir
from . import lapack_api
from . import scalapack_api

__version__ = "0.1.0"
VERSION = 2026_07_00   # yyyymmrr, the reference's integer form (version.cc)


def version() -> int:
    """Library version as the reference's yyyymmrr integer
    (src/version.cc: slate::version())."""
    return VERSION


def id() -> str:  # noqa: A001 - reference name (slate::id)
    """Git commit hash of this build, or "unknown" (src/version.cc: slate::id()).
    A hash is reported only when git tracks this package's directory, so a
    copy under an unrelated enclosing repository reads "unknown"."""
    import os
    import subprocess

    try:
        pkg = os.path.realpath(__path__[0])
        tracked = subprocess.run(
            ["git", "ls-files", "--error-unmatch", pkg], capture_output=True,
            text=True, timeout=5, cwd=pkg)
        if tracked.returncode != 0:
            return "unknown"
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=5, cwd=pkg).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
