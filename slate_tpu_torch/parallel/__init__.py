"""Distributed execution layer over ``torch.distributed`` — the counterpart of
MPI + process grids.

Reference analogue (SURVEY.md §2.6, §5.8): SLATE distributes tiles over a p×q
MPI grid (func.hh:100-217) and moves them with tile broadcasts and reductions
(BaseMatrix.hh:1999-2452, internal_comm.cc:72-123).  Here the process grid is
a 2-D ``DeviceMesh`` over one process per rank (:class:`ProcessGrid`), an
operand lives as a ``DTensor`` in the block layout (or row-sharded, or
replicated), and every driver is a shard-local body with explicit
collectives over the grid's dims (:mod:`.collectives`: all-reduce,
all-gather, point-to-point) — NCCL on the card, gloo on the CPU.

Every module of the JAX package's ``parallel`` has its counterpart here: the
grid, the placement helpers, SUMMA and the BLAS-3, the distributed norms, the
Cholesky / LU / RBT / QR / LQ solvers, the inverses and condition estimates,
the batched solvers, the two-stage eigenvalue / SVD / generalized drivers
with the segment-parallel chases and the sharded secular solve, and the band
and Hermitian-indefinite solvers on compact storage.
"""

from .mesh import COL_AXIS, ProcessGrid, ROW_AXIS
from .collectives import (axis_allgather, axis_allreduce, axis_bcast, axis_index,
                          axis_reduce_scatter, ring_shift)
from .distribute import (block_spec, blocked_to_cyclic, ceil_mult, cyclic_permutation,
                         cyclic_to_blocked, distribute, gather, lcm, pad2d,
                         redistribute, redistribute_matrix, replicate)
from .summa import (gemm_allgather, gemm_distributed, gemm_padded, gemm_ring,
                    summa_gemm)
from .blas3_dist import (gbmm_distributed, hbmm_distributed, hemm_distributed,
                         her2k_distributed, herk_distributed, symm_distributed,
                         syr2k_distributed, syrk_distributed, trmm_distributed)
from .eig_dist import (col_norms_distributed, ge2tb_distributed, he2hb_distributed,
                       heev_distributed, heev_range_distributed, hegv_distributed,
                       norm_distributed, steqr_distributed, svd_distributed,
                       svd_range_distributed, unmtr_he2hb_distributed)
from .chase_dist import hb2st_chase_distributed, tb2bd_chase_distributed
from .pivot import (exchange_rows, extract_rows, partialpiv_piv, scatter_rows,
                    select_pivots, step_permutation, tournament_piv)
from .solvers import (cholqr_distributed, gels_cholqr_distributed,
                      posv_distributed, posv_mixed_distributed,
                      posv_mixed_gmres_distributed, potrf_distributed,
                      trsm_distributed, trsmA_distributed)
from .pipeline import potrf_pipelined
from .lu_dist import (gesv_distributed, gesv_mixed_distributed,
                      gesv_mixed_gmres_distributed, getrf_distributed,
                      getrf_tall_distributed, getrs_distributed)
from .rbt import gesv_rbt_distributed, getrf_nopiv_distributed
from .qr_dist import (gelqf_distributed, gels_caqr_distributed,
                      gels_lq_distributed, gels_qr_distributed, geqrf_distributed,
                      tsqr_distributed, unmlq_distributed, unmqr_distributed)
from .inverse import (gecondest_distributed, getri_distributed,
                      pocondest_distributed, potri_distributed,
                      trcondest_distributed, trtri_distributed, trtrm_distributed)
from .band_dist import (band_general_to_dense, band_lower_to_dense,
                        dense_to_band_general, dense_to_band_lower, gbsv_distributed,
                        gbtrf_distributed, gbtrs_distributed, pbsv_distributed,
                        pbtrf_distributed, pbtrs_distributed, tbsm_distributed)
from .indefinite_dist import (HermitianFactorsDist, hesv_distributed,
                              hetrf_distributed, hetrs_distributed)
from .batched import gesv_batched_distributed, posv_batched_distributed
