"""slate_tpu_torch — the PyTorch/CUDA port of slate_tpu (SLATE-style dense linear
algebra), for NVIDIA Hopper.

The port has the public surface of ``slate_tpu`` for the routines it covers so far:
the matrix wrappers and enums, the BLAS-3 and norm drivers, the Cholesky family
(``potrf``/``potrs``/``posv``/``trtri``/``trtrm``/``potri``) and the condition
estimators.  Entry points place new data on ``cuda`` unless a ``device`` is given;
matrix and triangular norms of real f32/f64 data on the card run hand-written CUDA
kernels (:mod:`slate_tpu_torch.ops.cuda_norms`).  It imports neither JAX nor the
JAX package.
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
from .linalg import (gecondest, norm1est, pocondest, posv, potrf, potri, potrs,
                     trcondest, trtri, trtrm)
from . import obs, robust
from .robust import FaultPlan, FaultSpec, SolveReport, reduce_info
from .utils import trace

__version__ = "0.1.0"
