"""Plain dense solves and the checks that judge the program's answers.

* HPL's acceptance test (HPL 2.3, ``HPL_pdtest``): the scaled residual
  ‖Ax − b‖∞ / (ε (‖A‖∞ ‖x‖∞ + ‖b‖∞) N), with ε the unit roundoff of f64,
  passes under 16.  The reference computes it from A and b, which the
  harness draws again from the seed, and the program's x, in blocks of rows
  in f64 on the card.
* A served request's answer, solved again in f64 on the host from the same
  operands (``numpy.linalg.solve`` / ``lstsq``), and the normwise relative
  gap ‖x − x_ref‖∞ / ‖x_ref‖∞.
* The controls: the same reference one precision below the configuration's
  (f32 for HPL's f64; TF32 for the served f32, whose products on this card
  would otherwise run in f32), put in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS = 4096
F64_EPS = float(np.finfo(np.float64).eps) / 2      # unit roundoff, HPL's eps


def hpl_scaled_residual(A: torch.Tensor, x: torch.Tensor,
                        b: torch.Tensor) -> float:
    """HPL's scaled residual of ``x`` for A x = b (all f64 on one device)."""
    n = A.shape[0]
    r_inf = 0.0
    a_inf = 0.0
    for r0 in range(0, n, ROWS):
        blk = A[r0:r0 + ROWS]
        r = torch.addmm(b[r0:r0 + ROWS], blk, x, alpha=1.0, beta=-1.0)
        r_inf = max(r_inf, float(r.abs().max()))
        a_inf = max(a_inf, float(blk.abs().sum(dim=1).max()))
    x_inf = float(x.abs().max())
    b_inf = float(b.abs().max())
    return r_inf / (F64_EPS * (a_inf * x_inf + b_inf) * n)


def solve_f32(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """HPL's control: A x = b by LU in f32 on A's device, x returned in f64."""
    return torch.linalg.solve(A.float(), b.float()).double()


def solve_f64(routine: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One served request solved in f64: ``gesv`` and ``posv`` exactly
    square, ``gels`` in the least-squares sense."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if routine == "gels":
        return np.linalg.lstsq(a, b, rcond=None)[0]
    return np.linalg.solve(a, b)


def tf32(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def solve_tf32(routine: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The served mix's control: the operands as TF32 holds them, solved."""
    return solve_f64(routine, tf32(a), tf32(b))


def rel_gap(x: np.ndarray, ref: np.ndarray) -> float:
    x = np.asarray(x, dtype=np.float64).reshape(ref.shape)
    gap = float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))
    return gap if np.isfinite(gap) else float("inf")
