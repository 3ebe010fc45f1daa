"""Solvers ported so far: the Cholesky family and the condition estimators."""

from .chol import posv, posv_core, potrf, potri, potrs, trtri, trtrm
from .condest import gecondest, norm1est, pocondest, trcondest
