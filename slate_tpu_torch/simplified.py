"""Verb-style convenience API (≅ include/slate/simplified_api.hh).

The reference pairs every LAPACK-named driver with a task-descriptive verb name:
``multiply`` = gemm, ``chol_factor`` = potrf, ``least_squares_solve`` = gels, and so
on.  These are thin aliases of the port's routines — same arguments, same returns
— with the names and grouping of the JAX package's ``simplified`` module.
"""

from __future__ import annotations

from . import blas as _blas
from . import linalg as _la
from . import serve as _serve

__all__ = [
    # BLAS-3
    "multiply", "triangular_multiply", "triangular_solve",
    "hermitian_multiply", "symmetric_multiply",
    "rank_k_update", "rank_2k_update", "band_multiply", "triangular_band_solve",
    # LU
    "lu_factor", "lu_factor_nopiv", "lu_solve", "lu_solve_nopiv",
    "lu_solve_using_factor", "lu_solve_using_factor_nopiv",
    "lu_inverse_using_factor", "lu_inverse_using_factor_out_of_place",
    "lu_condest_using_factor",
    # Cholesky
    "chol_factor", "chol_solve", "chol_solve_using_factor",
    "chol_inverse_using_factor", "chol_condest_using_factor",
    # indefinite
    "indefinite_factor", "indefinite_solve", "indefinite_solve_using_factor",
    # band
    "band_lu_factor", "band_lu_solve", "band_chol_factor", "band_chol_solve",
    # least squares / QR / LQ
    "least_squares_solve", "qr_factor", "qr_multiply_by_q",
    "lq_factor", "lq_multiply_by_q",
    # eig / svd
    "eig", "eig_vals", "svd", "svd_vals",
    # misc
    "triangular_inverse", "triangular_condest",
    # batched serving tier (slate_tpu_torch.serve)
    "batched_lu_solve", "batched_chol_solve", "batched_least_squares_solve",
    "submit", "solve_many",
]

# --- BLAS-3 (simplified_api.hh Level 3 section) ---
multiply = _blas.gemm                       # gemm
triangular_multiply = _blas.trmm            # trmm
triangular_solve = _blas.trsm               # trsm
hermitian_multiply = _blas.hemm             # hemm
symmetric_multiply = _blas.symm             # symm
rank_k_update = _blas.herk                  # herk (syrk for real/symmetric)
rank_2k_update = _blas.her2k                # her2k
band_multiply = _la.gbmm                    # gbmm
triangular_band_solve = _la.tbsm            # tbsm

# --- LU (simplified_api.hh linear-systems section) ---
lu_factor = _la.getrf
lu_factor_nopiv = _la.getrf_nopiv
lu_solve = _la.gesv
lu_solve_nopiv = _la.gesv_nopiv
lu_solve_using_factor = _la.getrs
lu_solve_using_factor_nopiv = _la.getrs_nopiv
lu_inverse_using_factor = _la.getri
lu_inverse_using_factor_out_of_place = _la.getri_oop
lu_condest_using_factor = _la.gecondest

# --- Cholesky ---
chol_factor = _la.potrf
chol_solve = _la.posv
chol_solve_using_factor = _la.potrs
chol_inverse_using_factor = _la.potri
chol_condest_using_factor = _la.pocondest

# --- Hermitian/symmetric indefinite ---
indefinite_factor = _la.hetrf
indefinite_solve = _la.hesv
indefinite_solve_using_factor = _la.hetrs

# --- band solvers ---
band_lu_factor = _la.gbtrf
band_lu_solve = _la.gbsv
band_chol_factor = _la.pbtrf
band_chol_solve = _la.pbsv

# --- least squares / orthogonal factors ---
least_squares_solve = _la.gels
qr_factor = _la.geqrf
qr_multiply_by_q = _la.unmqr
lq_factor = _la.gelqf
lq_multiply_by_q = _la.unmlq

# --- eigenvalues / SVD ---
eig = _la.heev


def eig_vals(A, opts=None, uplo=None):
    """Eigenvalues only (simplified_api.hh eig_vals = heev without vectors)."""
    lam, _ = _la.heev(A, opts, uplo, want_vectors=False)
    return lam


svd = _la.svd
svd_vals = _la.svd_vals


# --- misc ---
triangular_inverse = _la.trtri
triangular_condest = _la.trcondest

# --- batched serving tier (slate_tpu_torch.serve; no reference analogue — the
# verb names extend the simplified_api.hh vocabulary to the batch axis) ---
batched_lu_solve = _serve.gesv_batched
batched_chol_solve = _serve.posv_batched
batched_least_squares_solve = _serve.gels_batched
submit = _serve.submit                      # async single request
solve_many = _serve.solve_many              # sync mixed-traffic packer
