"""Operation and byte models of the work the benchmark asks for.

These count what the problem needs, from its shapes, never what a kernel
happens to do: padding, ghost slots and re-reads are left out, so a share of
a peak computed from them cannot pass 100 % unless the timing is wrong.

* HPL (netlib HPL 2.3, ``HPL_pdtest``): 2N³/3 + 3N²/2 per solve of one
  right-hand side, the count HPL divides by the wall time.
* LAPACK's operation counts (LAWN 41) for the served routines: ``gesv``
  2n³/3 + 2n²r, ``posv`` n³/3 + 2n²r, ``gels`` (tall, m ≥ n)
  2mn² − 2n³/3 + 4mnr (QR, Qᴴb and the triangular solve).
* Bytes: each operand read once and the solution written once.
"""

from __future__ import annotations


def hpl_flops(n: int) -> float:
    return 2.0 * n ** 3 / 3.0 + 1.5 * n ** 2


def solve_flops(routine: str, m: int, n: int, nrhs: int) -> float:
    if routine == "gesv":
        return 2.0 * n ** 3 / 3.0 + 2.0 * n * n * nrhs
    if routine == "posv":
        return n ** 3 / 3.0 + 2.0 * n * n * nrhs
    if routine == "gels":
        return 2.0 * m * n * n - 2.0 * n ** 3 / 3.0 + 4.0 * m * n * nrhs
    raise ValueError(f"no operation count for {routine!r}")


def solve_bytes(m: int, n: int, nrhs: int, itemsize: int) -> float:
    """A (m×n) and B (m×r) read once, X (n×r) written once."""
    return float(itemsize) * (m * n + m * nrhs + n * nrhs)
