"""Implicit-shift tridiagonal QR iteration with eigenvector accumulation.

Reference analogue: ``src/steqr.cc`` — every rank runs the same host QR
iteration on the replicated (D, E) scalars and applies the plane rotations to
its rows of Z.

The port keeps that split literally.  The sweep recurrence (Givens generation
and bulge chase) is scalar and sequential, so it runs on the host over Python
floats: one device→host copy of (d, e) per call, and no other host sync.  The
JAX package runs the same recurrence as one masked ``lax.scan`` over all n-1
positions; the rotations outside the active window [l, m] are identities
there, so the host loop visits the window alone and yields the same
rotations.  Z, where the flops are, stays on the device: a sweep's rotation
chain becomes its dense orthogonal product (upper Hessenberg, in closed form
from log-space cumulative products) over the smallest power-of-two bucket
covering the window, and Z absorbs the whole sweep as one gemm — about 40
launches per sweep, all queued without waiting.

Arithmetic on the host is in the input's real precision, as the JAX
package's scan is: numpy float32 scalars for f32, Python floats for f64, with
the input dtype's eps and tiny in the deflation test.  Failure
semantics are the JAX package's: a 30·n sweep budget, NaN eigenvalues when it
runs out, and the LAPACK-style ``info`` with ``return_info=True``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.matrix import as_array

__all__ = ["steqr_qr"]


def _scalar_ops(rdt: torch.dtype):
    """(scalar type, hypot) of the host recurrence in the real dtype
    ``rdt``: numpy float32 scalars (whose arithmetic rounds to f32 at every
    operation) for f32, Python floats for f64."""
    if rdt == torch.float32:
        return np.float32, np.hypot
    return float, math.hypot


def _sweep(d, e, l, m, shift, tiny, cs, ss, ft=float, hypot=math.hypot):
    """One implicit-shift QR sweep on the window [l, m] (rotations at
    k = l..m-1) of the host lists d, e (scalars of type ``ft``), in place.
    Writes the rotations into cs/ss (identity outside the window).  The
    update formulas are the symmetric similarity T' = G T Gᵀ on the
    tridiagonal entries, with G = [[c, s], [-s, c]] in the (k, k+1) plane,
    c = x/r, s = z/r."""
    one, zero, two = ft(1), ft(0), ft(2)
    x = d[l] - shift
    z = e[l]
    for k in range(l, m):
        r = hypot(x, z)
        if r > tiny:
            c, s = x / r, z / r
        else:
            c, s = one, zero
        if k > l:
            e[k - 1] = r
        dk, dk1, ek = d[k], d[k + 1], e[k]
        new_ek = c * s * (dk1 - dk) + (c * c - s * s) * ek
        d[k] = c * c * dk + two * c * s * ek + s * s * dk1
        d[k + 1] = s * s * dk - two * c * s * ek + c * c * dk1
        e[k] = new_ek
        cs[k], ss[k] = c, s
        if k < m - 1:
            ek1 = e[k + 1]
            z = s * ek1
            e[k + 1] = c * ek1
            x = new_ek


def _sweep_q(cs: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """Dense orthogonal Q̃ = G_lᵀ·G_{l+1}ᵀ···G_{m-1}ᵀ of a sweep's rotation
    chain, as Z's per-sweep right factor.  Upper Hessenberg:
    P[i, j>=i] = ĉ_{i-1}·(∏_{t=i..j-1} ŝ_t)·ĉ_j and P[i+1, i] = -ŝ_i; the
    cumulative products run in log space with zero- and sign-count tracking,
    so a segment holding an exact zero is an exact zero (not a NaN)."""
    n1 = cs.shape[0]
    n = n1 + 1
    dt, dev = cs.dtype, cs.device
    s = -ss
    zero = s.abs() <= 0
    la = torch.log(torch.where(zero, torch.ones_like(s), s.abs()))
    z1 = torch.zeros((1,), dtype=dt, device=dev)
    i1 = torch.zeros((1,), dtype=torch.int64, device=dev)
    pref = torch.cat([z1, torch.cumsum(la, 0)])
    zc = torch.cat([i1, torch.cumsum(zero.to(torch.int64), 0)])
    neg = torch.cat([i1, torch.cumsum((s < 0).to(torch.int64), 0)])
    one = torch.ones((1,), dtype=dt, device=dev)
    chat = torch.cat([one, cs, one])
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n, device=dev)[None, :]
    seg = pref[j] - pref[i]
    seg_zero = (zc[j] - zc[i]) > 0
    seg_sign = 1.0 - 2.0 * ((neg[j] - neg[i]) % 2).to(dt)
    prod = torch.where(seg_zero, torch.zeros((), dtype=dt, device=dev),
                       seg_sign * torch.exp(seg))
    Q = torch.where(j >= i, chat[i] * prod * chat[j + 1],
                    torch.zeros((), dtype=dt, device=dev))
    ar = torch.arange(n - 1, device=dev)
    Q[ar + 1, ar] = ss
    return Q


def _deflate(d, e, eps, tiny, zero=0.0):
    """Zero (in place) the off-diagonals passing the LAPACK smallness test;
    returns whether any stays nonzero."""
    live = False
    for k in range(len(e)):
        if abs(e[k]) <= eps * (abs(d[k]) + abs(d[k + 1])) + tiny:
            e[k] = zero
        elif e[k] != 0.0:
            live = True
    return live


def _window(e):
    """Bottom-most maximal unreduced window [l, m]: m one past the highest
    nonzero off-diagonal, l the start of its run."""
    m_rot = len(e) - 1
    while e[m_rot] == 0.0:
        m_rot -= 1
    l = m_rot
    while l > 0 and e[l - 1] != 0.0:
        l -= 1
    return l, m_rot + 1


def _wilkinson(d, e, m, ft=float, hypot=math.hypot):
    delta = (d[m - 1] - d[m]) * ft(0.5)
    em = e[m - 1]
    sgn = ft(1) if delta >= 0 else ft(-1)
    denom = delta + sgn * hypot(delta, em)
    return d[m] - em * em / (denom if abs(denom) > 0 else ft(1))


def _buckets(n: int):
    """Power-of-two window widths from 64 up, capped by n."""
    out, w = [], 64
    while w < n:
        out.append(w)
        w *= 2
    out.append(n)
    return out


def steqr_qr(d, e, Z: Optional[torch.Tensor] = None, *,
             want_vectors: bool = True, max_sweeps: Optional[int] = None,
             return_info: bool = False):
    """Eigen-decomposition of the symmetric tridiagonal T(d, e) by
    implicit-shift QR iteration (``src/steqr.cc`` semantics).

    Returns ``(lam, Zout)`` with lam ascending; ``Zout = Z·Q`` (or ``Q`` when
    ``Z is None``) when vectors are requested, else ``lam`` alone.  If the
    30·n sweep budget runs out with off-diagonals left (LAPACK steqr's
    info > 0), the eigenvalues come back as NaN; ``return_info=True`` also
    returns that count (0 on success).

    Host syncs: one, the copy of (d, e) to the host.  Launches: about 40 per
    sweep for the Z update, none without vectors."""
    d = as_array(d)
    e = as_array(e, device=d.device)
    rdt = d.real.dtype
    dev = d.device
    n = d.shape[0]
    ft, hypot = _scalar_ops(rdt)
    np_dt = np.dtype(ft)
    d_host = d.real.detach().cpu().numpy().astype(np_dt)
    e_host = (e.real.detach().cpu().numpy().astype(np_dt) if e.numel()
              else np.zeros((0,), np_dt))
    info0 = torch.zeros((), dtype=torch.int32, device=dev)
    if n == 1:
        lam = d.real.to(rdt)
        if not want_vectors:
            return (lam, info0) if return_info else lam
        Zout = torch.ones((1, 1), dtype=rdt, device=dev) if Z is None else as_array(Z)
        return (lam, Zout, info0) if return_info else (lam, Zout)
    # global pre-scale to O(1), as the JAX package does (lascl's role)
    anorm = max(np.max(np.abs(d_host)), np.max(np.abs(e_host)))
    scale = ft(anorm if anorm > 0 else 1)
    dl = [ft(x) / scale for x in d_host]
    el = [ft(x) / scale for x in e_host]
    if max_sweeps is None:
        max_sweeps = 30 * n                    # LAPACK's nmaxit = 30·n
    fi = torch.finfo(rdt)
    eps, tiny = ft(fi.eps), ft(fi.tiny)
    Zc = None
    if want_vectors:
        Zc = (torch.eye(n, dtype=rdt, device=dev) if Z is None
              else as_array(Z, device=dev).clone())
    buckets = _buckets(n)
    cs = np.ones(n - 1, np_dt)
    ss = np.zeros(n - 1, np_dt)
    it = 0
    while it < max_sweeps and _deflate(dl, el, eps, tiny, ft(0)):
        l, m = _window(el)
        shift = _wilkinson(dl, el, m, ft, hypot)
        cs[:] = 1.0
        ss[:] = 0.0
        _sweep(dl, el, l, m, shift, tiny, cs, ss, ft, hypot)
        if Zc is not None:
            wsize = m + 1 - l                  # columns touched: [l, m]
            W = next(b for b in buckets if b >= wsize)
            s0 = min(l, n - W)
            Qw = _sweep_q(torch.from_numpy(cs[s0:s0 + W - 1]).to(device=dev, dtype=rdt),
                          torch.from_numpy(ss[s0:s0 + W - 1]).to(device=dev, dtype=rdt))
            Zc[:, s0:s0 + W] = torch.matmul(Zc[:, s0:s0 + W], Qw.to(Zc.dtype))
        it += 1
    # LAPACK info: off-diagonals still undeflated at exit; an unconverged
    # solve poisons lam with NaN instead of returning silent garbage
    _deflate(dl, el, eps, tiny, ft(0))
    info_v = sum(1 for x in el if x != 0.0)
    order = np.argsort(np.asarray(dl, np_dt), kind="stable")
    lam_host = np.asarray(dl, np_dt)[order] * scale
    if info_v:
        lam_host[:] = np.nan
    lam = torch.from_numpy(lam_host).to(device=dev, dtype=rdt)
    info = torch.tensor(info_v, dtype=torch.int32, device=dev)
    if not want_vectors:
        return (lam, info) if return_info else lam
    Zout = Zc[:, torch.from_numpy(order).to(dev)]
    return (lam, Zout, info) if return_info else (lam, Zout)
