"""Solvers ported so far: the Cholesky, LU and QR/least-squares families (with
their mixed-precision and escalation-ladder variants) and the condition
estimators."""

from .chol import (posv, posv_core, posv_mixed, posv_mixed_gmres, potrf, potri,
                   potrs, trtri, trtrm)
from .lu import (gerbt, gesv, gesv_core, gesv_mixed, gesv_mixed_gmres,
                 gesv_nopiv, gesv_rbt,
                 getrf, getrf_nopiv, getrf_tntpiv, getri, getri_oop, getrs,
                 getrs_nopiv, perm_to_pivots, pivots_to_perm, rbt_generate)
from .qr import (TriangularFactors, cholqr, gelqf, gels, gels_cholqr, gels_core,
                 gels_qr, geqrf, tsqr, unmlq, unmqr)
from .condest import gecondest, norm1est, pocondest, trcondest
