"""Tridiagonal divide & conquer eigensolver (stedc).

Reference analogue: ``src/stedc.cc`` + ``stedc_{sort,deflate,z_vector,secular,
merge,solve}.cc``: sort, deflate, secular solve, Loewner eigenvectors, and the
gemm with the block eigenbasis, per merge.

The JAX package's design carries over unchanged: a host-side recursion tree of
rank-one merges; deflation as structure (minimal diagonal spacing by a
cumulative max and a z² floor, so every bracket keeps a strictly interior
root); a closer-pole bisection of all m secular roots at once; Gu's corrected
z (log-space products) for orthogonal Loewner vectors; and up to two gated
Newton–Schulz sweeps that repair orthogonality inside many-fold clusters.

What differs in eager PyTorch:

* The secular bisection materializes each (m, chunk) temporary that XLA fuses
  away.  Brackets are therefore processed in chunks of at most
  ``_SECULAR_BUFFER`` elements of the (m, chunk) denominator, so the largest
  merge's peak stays near 4 temporaries of that size (256 MiB each in f32)
  whatever m is.  Each of the 90 bisection steps is about 8 launches per chunk.
* The two ``lax.cond`` repair gates are host branches: one device→host sync
  per merge (the gate on the first Gram matrix), a second only on the merges
  whose first sweep trips it.
* ``argsort`` is stable (``torch.argsort(stable=True)``, as ``jnp.argsort``
  is), and ``lax.cummax`` is ``torch.cummax``.
* With a ``grid`` the recursion runs on every rank (it needs the same (d, e)
  bits everywhere, which the distributed drivers guarantee); each merge of at
  least ``_DIST_MERGE_MIN`` shards its secular bisection over the brackets
  (:mod:`..parallel.secular`) and its two basis-update gemms over the grid
  (:func:`..parallel.summa.gemm_padded`), and gathers the merged basis, so
  every rank holds the same Q.  The gates' branches read only values that
  are the same on every rank, so every rank makes the same collectives.

``stedc(d, e, Z)`` matches steqr's contract: (ascending eigenvalues, Z @ Q).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.matrix import as_array

_BASE_N = 32       # below this, one library eigh is faster than a merge
_BISECT_ITERS = 90  # geometric descent to tiny roots + full mantissa refinement
# elements of one (m, chunk) temporary of the secular bisection
_SECULAR_BUFFER = 1 << 26
# merges below this size gain nothing from the grid (collective latency
# dwarfs the gemm); the top log2(n/threshold) merges carry ~all the flops
_DIST_MERGE_MIN = 1024


def _secular_f(d, z2, rho, pole, off):
    """f(lam_j = pole_j + off_j) for a chunk of brackets, pole-relative: the
    denominator is (d_i - pole_j) - off_j, which keeps laed4's relative
    precision of the gap (the pole is subtracted exactly first)."""
    den = (d[:, None] - pole[None, :]) - off[None, :]
    return 1.0 + rho * torch.sum(z2[:, None] / den, dim=0)


def _secular_prep(d, z2, rho):
    """Per-bracket setup of the secular solve: bracket widths and closer-pole
    selection (one f sweep).  Returns (pole, sigma, gaps, use_lower)."""
    eps = torch.finfo(d.dtype).eps
    width = rho * torch.sum(z2) + eps * (d[-1].abs() + 1)
    gaps = torch.cat([d[1:] - d[:-1], width[None]])
    d_up = torch.cat([d[1:], (d[-1] + width)[None]])   # upper pole per bracket
    # closer-pole selection: f increasing per bracket; f(mid) >= 0 -> root in
    # the lower half (solve in u = lam - d_j), else upper (u = d_{j+1} - lam)
    c = _chunk(d)
    use_lower = torch.cat([_secular_f(d, z2, rho, d[c0:c0 + c],
                                      0.5 * gaps[c0:c0 + c]) >= 0
                           for c0 in range(0, d.shape[0], c)])
    one = torch.ones((), dtype=d.dtype, device=d.device)
    sigma = torch.where(use_lower, one, -one)
    pole = torch.where(use_lower, d, d_up)
    return pole, sigma, gaps, use_lower


def _chunk(d) -> int:
    """Brackets per chunk of the secular solve (see _SECULAR_BUFFER)."""
    return max(1, min(d.shape[0], _SECULAR_BUFFER // max(d.shape[0], 1)))


def _secular_bisect(d, z2, rho, pole, sigma, gaps, use_lower):
    """The O(m · m · iters) bisection for all brackets, chunked over brackets
    (each chunk runs its own 90 steps: brackets are independent)."""
    ts, ss, lams = [], [], []
    c = _chunk(d)
    for c0 in range(0, pole.shape[0], c):
        p, sg = pole[c0:c0 + c], sigma[c0:c0 + c]
        lo = torch.zeros(p.shape, dtype=d.dtype, device=d.device)
        hi = 0.5 * gaps[c0:c0 + c]
        for _ in range(_BISECT_ITERS):
            u = 0.5 * (lo + hi)
            f = _secular_f(d, z2, rho, p, sg * u)
            bigger = sg * f < 0                  # root at larger u
            lo = torch.where(bigger, u, lo)
            hi = torch.where(bigger, hi, u)
        u = 0.5 * (lo + hi)
        ul = use_lower[c0:c0 + c]
        g = gaps[c0:c0 + c]
        ts.append(torch.where(ul, u, g - u))
        ss.append(torch.where(ul, g - u, u))
        lams.append(p + sg * u)
    return torch.cat(ts), torch.cat(ss), torch.cat(lams)


def _secular_roots(d, z2, rho):
    """All m roots of 1 + rho * sum_i z2_i / (d_i - lam) = 0 (laed4 analogue),
    each solved in the gap variable of its closer pole.  Returns (t, s, lam):
    t = lam - d_j and s = d_{j+1} - lam, both accurate near their poles."""
    pole, sigma, gaps, use_lower = _secular_prep(d, z2, rho)
    return _secular_bisect(d, z2, rho, pole, sigma, gaps, use_lower)


def _deflate(d_sorted, z_sorted, rho):
    """Structural deflation on the sorted union: minimal spacing for equal
    diagonals, z² floor for tiny couplings.  Returns (d, z2, scale, eps)."""
    dt = d_sorted.dtype
    m = d_sorted.shape[0]
    scale = torch.maximum(d_sorted[0].abs(), d_sorted[-1].abs()) + rho
    eps = torch.finfo(dt).eps
    gap_min = 8 * eps * scale
    ar = torch.arange(m, dtype=dt, device=d_sorted.device)
    d = torch.cummax(d_sorted - gap_min * ar, dim=0).values + gap_min * ar
    # floor z² so every bracket keeps a pole on each side and a strictly
    # interior root (the perturbation is ~m eps² scale, far below one ulp)
    z2 = z_sorted * z_sorted + (eps * scale) ** 2 / torch.clamp(rho, min=eps)
    return d, z2, scale, eps


def _gram_off(G: torch.Tensor) -> float:
    """max |G - I| on the host (the repair gate's one sync)."""
    return float(torch.max((G - torch.eye(G.shape[0], dtype=G.dtype,
                                          device=G.device)).abs()))


def _merge(d1, Q1, d2, Q2, rho_raw, grid=None):
    """One D&C merge (stedc_merge + stedc_z_vector + stedc_secular +
    stedc_solve): the rank-one update D + rho z z^T in the blkdiag(Q1, Q2)
    basis.  Host syncs: 1, or 2 when the first repair sweep runs.  With
    ``grid`` the secular bisection and the two basis-update gemms run over
    the grid (module docstring)."""
    dt = d1.dtype
    n1 = d1.shape[0]
    m = n1 + d2.shape[0]
    dev = d1.device
    rho = rho_raw.abs()  # e is sign-normalized by the driver; guard anyway
    d = torch.cat([d1, d2])
    z = torch.cat([Q1[-1, :], Q2[0, :]])
    order = torch.argsort(d, stable=True)
    d = d[order]
    z = z[order]
    d, z2, scale, eps = _deflate(d, z, rho)
    if grid is not None:
        from ..parallel.secular import secular_roots_sharded

        t, s, lam = secular_roots_sharded(d, z2, rho, grid)
    else:
        t, s, lam = _secular_roots(d, z2, rho)

    # Gu's corrected |z~_i|^2 = prod_j (lam_j - d_i) / prod_{j != i} (d_j - d_i)
    M = lam[None, :] - d[:, None]                     # (i, j): lam_j - d_i
    # the two near-pole entries take the exactly-solved gap offsets
    idx = torch.arange(m, device=dev)
    M[idx, idx] = t
    if m > 1:
        M[idx[1:], idx[:-1]] = -s[:-1]
    absM = M.abs()
    num = torch.log(torch.where(absM > 0, absM, torch.ones_like(absM))).sum(dim=1)
    zero_num = (absM == 0).any(dim=1)
    del absM
    Dd = (d[:, None] - d[None, :]).abs_()
    Dd.diagonal().fill_(1.0)
    den = Dd.log_().sum(dim=1)
    del Dd
    one = torch.ones((), dtype=dt, device=dev)
    sign_z = torch.where(z >= 0, one, -one)            # sign(0) must be 1, not 0
    ztilde = torch.where(zero_num, torch.zeros((), dtype=dt, device=dev),
                         sign_z * torch.exp(0.5 * (num - den)))

    # Loewner eigenvectors v_j[i] = z~_i / (d_i - lam_j); the z-floor keeps
    # every root strictly interior, so denominators never vanish
    M.neg_()                                          # (i, j): d_i - lam_j
    safe = torch.where(M.abs() > 0, M, eps * scale)
    del M
    V = ztilde[:, None] / safe
    del safe
    # exact pole hits (t or s underflowed to 0, only when rho ~ 0 decouples
    # the problem): the eigenpair is exactly (d_i, e_i)
    pin_lo = t == 0
    pin_up = (~pin_lo) & (s == 0)
    eye_m = torch.eye(m, dtype=dt, device=dev)
    up_shift = torch.roll(eye_m, -1, dims=1)
    V = torch.where(pin_lo[None, :], eye_m, torch.where(pin_up[None, :], up_shift, V))
    del up_shift
    V = V / torch.linalg.vector_norm(V, dim=0, keepdim=True)

    # cluster repair: up to two gated Newton–Schulz sweeps toward the polar
    # factor (Löwdin orthogonalization); healthy merges pay one Gram product
    ns_tol = 64 * eps * (float(m) ** 0.5)
    G0 = torch.matmul(V.T, V)
    if _gram_off(G0) > ns_tol:
        V = 1.5 * V - 0.5 * torch.matmul(V, G0)
        G1 = torch.matmul(V.T, V)
        if _gram_off(G1) > ns_tol:
            V = 1.5 * V - 0.5 * torch.matmul(V, G1)
    del G0

    # back to the original basis: undo the sort on V's rows, then the two
    # diagonal blocks separately (laed3's structure)
    Vp = torch.empty_like(V)
    Vp[order] = V
    if grid is not None:
        return lam, torch.cat([_gemm_grid(Q1, Vp[:n1], grid),
                               _gemm_grid(Q2, Vp[n1:], grid)], dim=0)
    Ztop = torch.matmul(Q1, Vp[:n1])
    Zbot = torch.matmul(Q2, Vp[n1:])
    return lam, torch.cat([Ztop, Zbot], dim=0)


def _gemm_grid(a, b, grid):
    """a @ b over the grid for operands that are the same on every rank: each
    rank multiplies its block (SUMMA), and the product is gathered back."""
    from ..parallel.distribute import gather
    from ..parallel.summa import gemm_padded

    return gather(gemm_padded(a, b, grid))


# PyTorch's cuSOLVER route for a Hermitian matrix of n <= 512 loses accuracy
# in single precision: 2.0e-4 · max|λ| at n = 512 f32, where the gates allow
# 50·eps·√n = 1.35e-4, against 3e-9 in double and 3e-7 at n = 513 (H100 80GB
# HBM3, torch 2.11 + CUDA 12.8; ``chip_eigh_sweep.py``).  Such calls solve in
# double on the card; chip_smoke.py's phase 13 holds sterf and heev at
# n = 512 f32 to float64.
_LIB_EIGH_WIDEN_MAX = 512


def _library_eigh(a: torch.Tensor, want_vectors: bool = True):
    """``torch.linalg.eigh(a)`` (or ``eigvalsh`` without vectors): (lam, Z or
    None).  A single-precision CUDA operand of n <= ``_LIB_EIGH_WIDEN_MAX``
    is solved in double and the result cast back; everything else goes to the
    library as it is."""
    widen = (a.is_cuda and a.dtype in (torch.float32, torch.complex64)
             and a.shape[-1] <= _LIB_EIGH_WIDEN_MAX)
    x = a.to(torch.complex128 if a.is_complex() else torch.float64) if widen else a
    if want_vectors:
        lam, z = torch.linalg.eigh(x)
    else:
        lam, z = torch.linalg.eigvalsh(x), None
    if widen:
        lam = lam.to(a.real.dtype)
        z = None if z is None else z.to(a.dtype)
    return lam, z


def _assemble_tridiag(d, e) -> torch.Tensor:
    """Dense symmetric tridiagonal from (diag, offdiag)."""
    T = torch.diag_embed(d)
    if d.shape[-1] > 1:
        T = T + torch.diag_embed(e, offset=-1) + torch.diag_embed(e, offset=1)
    return T


def _stedc_rec(d, e, grid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    n = d.shape[0]
    if n <= _BASE_N:
        return _library_eigh(_assemble_tridiag(d, e))
    mid = n // 2
    rho = e[mid - 1]
    d1 = torch.cat([d[: mid - 1], (d[mid - 1] - rho)[None]])
    d2 = torch.cat([(d[mid] - rho)[None], d[mid + 1:]])
    lam1, Z1 = _stedc_rec(d1, e[: mid - 1], grid)
    lam2, Z2 = _stedc_rec(d2, e[mid:], grid)
    return _merge(lam1, Z1, lam2, Z2, rho,
                  grid if n >= _DIST_MERGE_MIN else None)


def stedc(d, e, Z: Optional[torch.Tensor] = None, opts=None, grid=None):
    """Divide & conquer tridiagonal eigensolver (src/stedc.cc family).

    Returns (ascending eigenvalues, Q), premultiplied by ``Z`` when given.
    The off-diagonal may be signed: a diagonal similarity normalizes it
    nonnegative first (signs folded into Q).  ``grid`` (a ProcessGrid):
    merges at and above ``_DIST_MERGE_MIN`` run their secular solve and
    basis-update gemms over it, as does the final Z @ Q product; every rank
    must call with the same (d, e) and gets the same (lam, Q).  Host syncs:
    one per merge (:func:`_merge`), about n / 16 in all."""
    d = as_array(d)
    e = as_array(e, device=d.device)
    n = d.shape[-1]
    if n == 0:
        Q = torch.zeros((0, 0), dtype=d.dtype, device=d.device)
        return d, (Q if Z is None else Z)
    if n > 1:
        one = torch.ones((1,), dtype=d.dtype, device=d.device)
        sgn = torch.where(e < 0, -one, one)
        S = torch.cat([one, torch.cumprod(sgn, 0)])
        lam, Q = _stedc_rec(d, e.abs(), grid)
        Q = S[:, None] * Q
    else:
        lam, Q = d, torch.ones((1, 1), dtype=d.dtype, device=d.device)
    if Z is not None:
        Zc = as_array(Z, device=d.device)
        Zc = Zc.to(Q.dtype) if Zc.dtype != Q.dtype else Zc
        Q = (_gemm_grid(Zc, Q, grid) if grid is not None and n >= _DIST_MERGE_MIN
             else torch.matmul(Zc, Q))
    return lam, Q


# ---------------------------------------------------------------------------
# Stage entry points (the reference exposes each D&C stage publicly,
# slate.hh:1210-1264)
# ---------------------------------------------------------------------------


def stedc_z_vector(Q1, Q2):
    """Coupling vector of a merge: last row of Q1 over first row of Q2
    (src/stedc_z_vector.cc)."""
    Q1 = as_array(Q1)
    return torch.cat([Q1[-1, :], as_array(Q2, device=Q1.device)[0, :]])


def stedc_sort(d, Q):
    """Ascending eigenvalue sort with the matching (stable) column permutation
    of Q (src/stedc_sort.cc).  Returns (d_sorted, Q_sorted)."""
    d = as_array(d)
    order = torch.argsort(d, stable=True)
    return d[order], as_array(Q, device=d.device)[:, order]


def stedc_deflate(rho, d, z):
    """Deflation stage on the sorted union (src/stedc_deflate.cc), as a
    backward-error perturbation: minimal diagonal spacing plus a z² floor.
    Returns (d_hat, z2_hat), the input of stedc_secular."""
    d = as_array(d)
    rho = torch.as_tensor(as_array(rho, device=d.device)).abs()
    d_hat, z2_hat, _, _ = _deflate(d, as_array(z, device=d.device), rho)
    return d_hat, z2_hat


def stedc_secular(rho, d, z2):
    """Secular equation stage (src/stedc_secular.cc / laed4): all m roots by
    closer-pole bisection.  Returns the ascending eigenvalues."""
    d = as_array(d)
    _, _, lam = _secular_roots(d, as_array(z2, device=d.device),
                               as_array(rho, device=d.device).abs())
    return lam


def stedc_merge(d1, Q1, d2, Q2, rho):
    """One full merge of two solved halves (src/stedc_merge.cc).
    Returns (eigenvalues, blkdiag(Q1, Q2) @ U)."""
    d1 = as_array(d1)
    dev = d1.device
    return _merge(d1, as_array(Q1, device=dev), as_array(d2, device=dev),
                  as_array(Q2, device=dev), as_array(rho, device=dev))


def stedc_solve(d, e):
    """The recursive D&C solve without a pre-multiplied Z
    (src/stedc_solve.cc).  Returns (ascending eigenvalues, Q)."""
    return stedc(d, e)
