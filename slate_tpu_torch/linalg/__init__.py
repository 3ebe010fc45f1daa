"""Driver algorithms: the Cholesky, LU and QR/least-squares families (with
their mixed-precision and escalation-ladder variants), the condition
estimators, the Hermitian eigensolvers and SVD (fused and two-stage, with the
tridiagonal and subset solvers), the band solvers and the Hermitian-indefinite
(Aasen) solvers."""

from .chol import (posv, posv_core, posv_mixed, posv_mixed_gmres, potrf, potri,
                   potrs, trtri, trtrm)
from .lu import (gerbt, gesv, gesv_core, gesv_mixed, gesv_mixed_gmres,
                 gesv_nopiv, gesv_rbt,
                 getrf, getrf_nopiv, getrf_tntpiv, getri, getri_oop, getrs,
                 getrs_nopiv, perm_to_pivots, pivots_to_perm, rbt_generate)
from .qr import (TriangularFactors, cholqr, gelqf, gels, gels_cholqr, gels_core,
                 gels_qr, geqrf, tsqr, unmlq, unmqr)
# the submodule import must come first: importing .stedc binds the module
# object onto the package as attribute "stedc", and the .eig import below
# re-binds that name to the driver *function* (the public contract)
from .stedc import (stedc_deflate, stedc_merge, stedc_secular, stedc_solve,
                    stedc_sort, stedc_z_vector)
from .eig import (eig_count, hb2st, he2hb, he2hb_q, heev, heev_range,
                  hegst, hegv, hegv_range, stedc, steqr,
                  steqr2, sterf, syev, sygst, sygv, unmtr_hb2st, unmtr_he2hb)
from .svd import (svd_range, bdsqr, ge2tb, ge2tb_band, svd, svd_vals, tb2bd,
                  unmbr_ge2tb, unmbr_ge2tb_factors, unmbr_tb2bd)
from .condest import gecondest, norm1est, pocondest, trcondest
from .sturm import stein, sterf_bisect
from .band import (BandLU, gbmm, gbsv, gbtrf, gbtrs, hbmm, pbsv, pbtrf, pbtrs,
                   tbsm, tbsm_pivots, tbsmPivots)
from .indefinite import (HermitianFactors, hesv, hetrf, hetrs, sysv, sytrf,
                         sytrs)
