"""Double-precision-class gemm from exact low-precision slices, and the
iterative-refinement solves built on it.

The JAX package uses this on TPUs, which have no f64 ALUs.  Hopper has native
FP64, so here it is a parity path (``Options(f64_emulation=True)``), not the
default.  The scheme is the same:

**Ozaki-scheme splitting, made exact.**  After a per-row power-of-two scale,
each operand decomposes on a fixed-point grid

    a = 2^e_row · Σ_i c_i · 2^(-7-8i),   c_i integer, |c_i| ≤ 128,

so every slice is exactly representable in bfloat16, every product c_i·c_j is
an integer of magnitude ≤ 2^14, and a 256-long chunk of such products sums to
an integer below 2^24 — exactly representable in float32.  The contraction is
chunked at 256, each chunk sum is exact, and the chunk results (scaled by their
power of two, also exact) accumulate in double-f32 (hi, lo) through the 2Sum
error-free transformation.

Exactness needs every chunk sum formed exactly in float32:

* on the card, bfloat16 slices through ``torch.bmm(..., out_dtype=float32)``
  where the installed torch has it (tensor cores, float32 accumulation), else
  float32 slices with TF32 off;
* on the CPU, float32 slices (``aten::bmm.dtype`` has no CPU kernel), which
  hold the same integers; the chunk sums are exact in any summation order.

Either way the products are library calls, as XLA's are in the JAX package.
``slices=7`` covers 56 mantissa bits (≥ f64's 53); pairs with i + j ≥ s fall
below 2^(-8s) and are skipped, so a product costs s(s+1)/2 = 28 slice gemms.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ..core.exceptions import slate_assert
from ..core.matrix import to_tensor

_CHUNK = 256             # 2^(24 - 16): exact f32 accumulation length


def _exact_pow2(e, dtype):
    """2^e as exact floats, built in the exponent field (an ``exp2`` need not
    return the exact power of two).  ``e`` is clamped to the normal-exponent
    range, so rows outside it saturate as any float of that dtype would."""
    if dtype == torch.float64:
        ec = torch.clamp(e.to(torch.int64), -1022, 1023)
        return ((ec + 1023) << 52).view(torch.float64)
    ec = torch.clamp(e.to(torch.int64), -126, 127)
    return ((ec + 127) << 23).to(torch.int32).view(torch.float32)


def split_fixed_slices(x, s: int):
    """Error-free fixed-grid split: returns (slices, e_row) with
    ``x[i, :] = 2^e_row[i] · Σ_j slices[j][i, :] · 2^(-7-8j)`` and every
    slice an integer-valued bfloat16 matrix with entries in [-128, 128]."""
    x = to_tensor(x)
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # floor(log2(amax)) + 1, exactly: the frexp exponent
    e = torch.where(amax > 0, torch.frexp(amax).exponent.to(x.dtype),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    # keep both e and -e inside the normal range of the compute dtype
    lim = 1000.0 if x.dtype == torch.float64 else 120.0
    e = torch.clamp(e, -lim, lim)
    u = x * _exact_pow2(-e, x.dtype)     # |u| < 1 (row-normalized; exact)
    slices = []
    for _ in range(s):
        c = torch.round(u * 128.0)       # first step |u| < 1 => |c| <= 128;
        # afterwards |u| <= 0.5 ulp of the grid => |c| <= 64
        slices.append(c.to(torch.bfloat16))
        u = (u - c / 128.0) * 256.0
    return slices, e[..., 0]


@functools.lru_cache(maxsize=8)
def _bf16_products(device: torch.device) -> bool:
    """Whether this device's torch multiplies bfloat16 slices into float32
    (``bmm(..., out_dtype=float32)``, CUDA only)."""
    if device.type != "cuda":
        return False
    one = torch.ones(1, 1, 1, dtype=torch.bfloat16, device=device)
    try:
        torch.bmm(one, one, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return True


@contextlib.contextmanager
def _ieee_float32():
    """float32 products rounded as IEEE float32 for the duration: TF32 (and
    any reduced-precision float32 mode) off, the caller's setting restored
    after.  The slice scheme is exact only if each chunk sum is."""
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)


def _two_sum(a, b):
    """Knuth 2Sum: s + t == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    t = (a - (s - bb)) + (b - bb)
    return s, t


def _accumulate(A_slices, B_slices, m: int, k: int, n: int):
    """Double-f32 (hi, lo) of Σ_{i+j<s} 2^(-14-8(i+j)) A_i B_j, each pair's
    256-chunks folded in order by 2Sum."""
    s = len(A_slices)
    kc = -(-k // _CHUNK)
    pad = kc * _CHUNK - k
    dev = A_slices[0].device
    bf16 = _bf16_products(dev)
    op = (lambda x: x) if bf16 else (lambda x: x.float())
    hi = torch.zeros((m, n), dtype=torch.float32, device=dev)
    lo = torch.zeros((m, n), dtype=torch.float32, device=dev)
    Bc = [op(torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(kc, _CHUNK, n))
          for b in B_slices[:s]]
    with _ieee_float32():
        for i in range(s):
            Ac = op(torch.nn.functional.pad(A_slices[i], (0, pad)).reshape(
                m, kc, _CHUNK).transpose(0, 1))                   # (kc, m, CHUNK)
            for j in range(s - i):      # i + j >= s: below target precision
                # exact chunk sums, (kc, m, n) float32
                parts = (torch.bmm(Ac, Bc[j], out_dtype=torch.float32) if bf16
                         else torch.bmm(Ac, Bc[j]))
                scale = 2.0 ** (-14 - 8 * (i + j))
                for c in range(kc):
                    hi, t = _two_sum(hi, parts[c] * scale)
                    lo = lo + t
    return hi, lo


def _gemm_f64emu_real(A, B, slices: int):
    """(hi, lo) pair for real A @ B in float64, the row and column exponents
    folded back in (power-of-two multiplies — exact)."""
    m, k = A.shape
    n = B.shape[-1]
    As, ea = split_fixed_slices(A, slices)
    Bs_t, eb = split_fixed_slices(B.T, slices)
    hi, lo = _accumulate(As, [b.T for b in Bs_t], m, k, n)
    f64 = torch.float64
    sc = _exact_pow2(ea.to(f64)[:, None] + eb.to(f64)[None, :], f64)
    return hi.to(f64) * sc, lo.to(f64) * sc


def _hilo_add(h, l, x):
    """Fold x into the (hi, lo) accumulator error-free (2Sum)."""
    h2, t = _two_sum(h, x)
    return h2, l + t


def _f32(x: float, ref) -> torch.Tensor:
    """A scalar rounded to float32 (``jnp.float32(alpha)``), on ref's device."""
    return torch.tensor(x, dtype=torch.float32, device=ref.device)


def gemm_f64emu(A, B, alpha=1.0, beta=0.0, C=None, slices: int = 7,
                return_hilo: bool = False):
    """Double-precision-class ``alpha·A@B + beta·C`` from the exact splitting
    above (2-D operands; complex handled as four real products).

    The whole combination — ``beta·C`` included — happens inside the
    double-f32 (hi, lo) accumulator, so residual-style calls (``alpha=1,
    beta=-1``) keep their accuracy when the result is tiny against ``A@B``.
    alpha/beta that are signed powers of two fold in exactly; general scalars
    round once in f32.  Returns float64 (complex128), or the raw (hi, lo)
    pair with ``return_hilo=True``.  Operands that are not tensors go onto
    ``cuda`` (the port's entry-point rule); tensors keep their device.
    """
    A = to_tensor(A)
    B = to_tensor(B, device=A.device)
    slate_assert(A.ndim == 2 and B.ndim == 2,
                 "gemm_f64emu takes 2-D operands (batch outside)")
    cdt = torch.complex128
    if A.is_complex() or B.is_complex():
        Ar, Ai = _real_imag(A)
        Br, Bi = _real_imag(B)
        rr = gemm_f64emu(Ar, Br, slices=slices, return_hilo=True)
        ii = gemm_f64emu(Ai, Bi, slices=slices, return_hilo=True)
        ri = gemm_f64emu(Ar, Bi, slices=slices, return_hilo=True)
        ir = gemm_f64emu(Ai, Br, slices=slices, return_hilo=True)
        reh, rel = _hilo_add(rr[0], rr[1] - ii[1], -ii[0])
        imh, iml = _hilo_add(ri[0], ri[1] + ir[1], ir[0])
        prod_h = torch.complex(reh, imh) * alpha
        prod_l = torch.complex(rel, iml) * alpha
        if C is not None and beta != 0:
            prod_h, prod_l = _hilo_add(prod_h, prod_l,
                                       beta * to_tensor(C, device=A.device).to(cdt))
        if return_hilo:
            return prod_h, prod_l
        return prod_h + prod_l
    hi, lo = _gemm_f64emu_real(A, B, slices)
    af = _f32(alpha, A)
    hi, lo = hi * af, lo * af            # exact for signed powers of two
    if C is not None and beta != 0 and to_tensor(C, device=A.device).is_complex():
        # real A·B with a complex C: the product feeds only the real part, and
        # beta·Im(C) is carried as its own split pair
        Cf = to_tensor(C, device=A.device)
        bf = _f32(beta, A)
        cr_hi = Cf.real.to(torch.float32)
        hi, lo = _hilo_add(hi, lo, bf * cr_hi)
        ci_hi = Cf.imag.to(torch.float32)
        im_h, im_l = bf * ci_hi, torch.zeros_like(ci_hi)
        if Cf.dtype == torch.complex128:
            lo = lo + bf * (Cf.real - cr_hi.to(torch.float64)).to(torch.float32)
            im_l = im_l + bf * (Cf.imag - ci_hi.to(torch.float64)).to(torch.float32)
        prod_h = torch.complex(hi, im_h.to(torch.float64))
        prod_l = torch.complex(lo, im_l.to(torch.float64))
        if return_hilo:
            return prod_h, prod_l
        return prod_h + prod_l
    if C is not None and beta != 0:
        # C folds in as its own double-f32 split, so a float64 C loses
        # nothing; a float32 C bounds the result by its own precision
        Cf = to_tensor(C, device=A.device)
        bf = _f32(beta, A)
        c_hi = Cf.to(torch.float32)
        hi, lo = _hilo_add(hi, lo, bf * c_hi)
        if Cf.dtype == torch.float64:
            lo = lo + bf * (Cf - c_hi.to(torch.float64)).to(torch.float32)
    if return_hilo:
        return hi, lo
    return hi + lo


def _real_imag(x):
    return (x.real, x.imag) if x.is_complex() else (x, torch.zeros_like(x))


def _f64ir_refine(A, B2, Xh, solve32, max_iterations: int, tol_factor: float):
    """Shared refinement core of gesv_f64ir / posv_f64ir: double-f32 iterate,
    residuals through the compensated gemm, stagnation-aware stop.  Returns
    (Xh, Xl, iters, info): info = 1 when the f32 factor produced non-finite
    values (singular / not SPD), and then the loop never runs.

    The JAX package's device-side ``lax.while_loop`` becomes a Python loop, as
    in :func:`slate_tpu_torch.linalg.chol._ir_solve`: one host read for the
    finiteness check, then one per iteration (the stop verdict)."""
    Xl = torch.zeros_like(Xh)
    finite = bool(torch.isfinite(Xh).all())
    eps32 = torch.finfo(torch.float32).eps
    rdt = Xh.real.dtype
    b_hi = B2.to(Xh.dtype)
    one = torch.ones((), dtype=rdt, device=Xh.device)
    bnorm = torch.amax(torch.abs(b_hi))
    bnorm = torch.where(bnorm == 0, one, bnorm.to(rdt))
    anorm = torch.amax(torch.abs(A)).to(rdt)
    xnorm = torch.amax(torch.abs(Xh))
    xnorm = torch.where(xnorm == 0, one, xnorm.to(rdt))
    tol = tol_factor * (eps32 ** 2) * torch.maximum(bnorm, anorm * xnorm)

    prev = torch.tensor(float("inf"), dtype=rdt, device=Xh.device)
    iters, stop = 0, not finite
    while not stop and iters < max_iterations:
        rh, rl = gemm_f64emu(A, Xh.to(A.dtype), alpha=-1.0, beta=1.0, C=B2,
                             return_hilo=True)
        rh2, rl2 = gemm_f64emu(A, Xl.to(A.dtype), alpha=-1.0, return_hilo=True)
        rh, t = _two_sum(rh, rh2)
        rl = rl + rl2 + t
        rfull = rh + rl
        rmax = torch.amax(torch.abs(rfull)).to(rdt)
        stop = bool((rmax <= tol) | (rmax > 0.9 * prev))
        if not stop:
            D = solve32(rfull.to(Xh.dtype))
            Xh, tt = _two_sum(Xh, D)
            Xl = Xl + tt
        prev = rmax
        iters += 1
    info = torch.tensor(0 if finite else 1, dtype=torch.int32)
    return Xh, Xl, torch.tensor(iters, dtype=torch.int32), info


def _operands(A, B):
    A = to_tensor(A)
    B = to_tensor(B, device=A.device)
    vec = B.ndim == 1
    return A, (B[:, None] if vec else B), vec, (
        torch.complex64 if A.is_complex() else torch.float32)


def gesv_f64ir(A, B, max_iterations: int = 20, tol_factor: float = 4.0):
    """Solve A X = B to double-precision-class accuracy from a float32 LU
    factor: iterative refinement whose residuals run through the
    exact-splitting gemm (the reference's gesv_mixed with the refinement
    precision emulated).

    The iterate is a double-f32 (Xh, Xl) pair; each round computes
    R = B - A·(Xh + Xl) inside the compensated accumulator, solves the f32
    correction against the cached LU, and folds it in error-free.  Returns
    ``(Xh, Xl, iterations, info)``: the solution is ``Xh + Xl`` in float64;
    info = 1 means the f32 factor was singular (non-finite) and no refinement
    ran.  Complex inputs factor in complex64 and refine through the
    four-real-products gemm."""
    from ..linalg.lu import _device_perm, _lu_factor, lu_factored_solve

    A, B2, vec, lo_dt = _operands(A, B)
    plu, piv = _lu_factor(A.to(lo_dt))
    perm = _device_perm(plu, piv)

    def solve32(R):
        return lu_factored_solve(plu, perm, R)

    Xh = solve32(B2.to(lo_dt))
    Xh, Xl, iters, info = _f64ir_refine(A, B2, Xh, solve32, max_iterations,
                                        tol_factor)
    return ((Xh[:, 0], Xl[:, 0], iters, info) if vec
            else (Xh, Xl, iters, info))


def posv_f64ir(A, B, max_iterations: int = 20, tol_factor: float = 4.0):
    """SPD/HPD sibling of ``gesv_f64ir`` (the posv_mixed counterpart): float32
    Cholesky factor (of the lower triangle) + emulated-f64 refinement.  Same
    iterate and convergence policy; returns ``(Xh, Xl, iterations, info)``
    with info = 1 when A is not (numerically) positive definite."""
    from ..linalg.chol import _cholesky

    A, B2, vec, lo_dt = _operands(A, B)
    L = _cholesky(A.to(lo_dt))

    def solve32(R):
        y = torch.linalg.solve_triangular(L, R, upper=False)
        return torch.linalg.solve_triangular(L.mH, y, upper=True)

    Xh = solve32(B2.to(lo_dt))
    Xh, Xl, iters, info = _f64ir_refine(A, B2, Xh, solve32, max_iterations,
                                        tol_factor)
    return ((Xh[:, 0], Xl[:, 0], iters, info) if vec
            else (Xh, Xl, iters, info))
