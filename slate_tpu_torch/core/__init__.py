"""Core runtime: types, tile-grid metadata, matrix hierarchy (reference L2)."""

from .exceptions import (ConvergenceError, DeadlineExceededError,
                         NumericalError, QueueOverloadError,
                         SingularMatrixError, SlateError, slate_assert)
from .types import (Diag, GridOrder, Layout, MethodCholQR, MethodEig, MethodGels,
                    MethodGemm, MethodHemm, MethodLU, MethodSVD, MethodTrsm, Norm,
                    NormScope, Op, Options, Side, Target, TileKind, Uplo)
from .matrix import (BandMatrix, BaseBandMatrix, BaseMatrix, BaseTrapezoidMatrix,
                     HermitianBandMatrix, HermitianMatrix, Matrix, MatrixStorage,
                     SymmetricMatrix, TrapezoidMatrix, TriangularBandMatrix,
                     TriangularMatrix, as_array, distribution_grid,
                     from_reference_state, resolve_device, to_tensor, write_back)
from . import grid as func  # reference include/slate/func.hh namespace name
