"""Householder reflectors shared by the two-stage eig/SVD reductions.

Reference analogue: ``src/internal/internal_householder.hh`` (gerfg/gerf) and the
compact-WY panel machinery of ``src/internal/internal_geqrf.cc``.

The JAX package writes these as jittable, masked, static-shape programs; here
they run eagerly on the tensor's device.  The masked forms stay (a panel keeps
its full height, the pivot row is an offset), so the reflectors, ``tau`` and T
factors are those of the JAX package bit for bit in construction.  A pivot row
is a host integer here, where the JAX package traces it.

Conventions (LAPACK): ``H = I - tau v v^H`` with ``v[pivot] = 1``.  Left-apply
``H^H A = A - conj(tau) v (v^H A)``; right-apply ``A H = A - tau (A v) v^H``.
Block form ``Q = H_0 H_1 ... = I - V T V^H`` with T upper triangular.

Launches per call (eager PyTorch, one kernel per tensor op): ``larfg`` about
21; ``panel_qr_masked`` about 25 per column (nb columns); ``build_T`` 3 per
column plus one gemm; ``sweep_accumulate`` 3 per sweep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|² elementwise: x·x for real data; re² + im² for complex data, whose
    correctly rounded products and sum give the same bits whatever the
    tensor's size (the vectorized complex abs does not: a chase front batched
    alone and batched with others would round apart)."""
    if x.is_complex():
        return x.real * x.real + x.imag * x.imag
    return x * x


def _reflector(alpha: torch.Tensor, sigma2: torch.Tensor, x: torch.Tensor):
    """Shared larfg arithmetic: ``(denom, tau, beta_out, trivial)`` for a
    pivot ``alpha`` with tail norm² ``sigma2``; the reflector is
    ``where(trivial, 0, x / denom)`` with a 1 at the pivot.  beta is
    ``-sign(Re alpha)·‖x‖`` with sign(0) = 1 (LAPACK's larfg convention).
    About 16 launches, scalars folded into ``torch.where``."""
    beta_mag = torch.sqrt(_abs2(alpha) + sigma2)
    beta = torch.where(alpha.real >= 0, -beta_mag, beta_mag)
    trivial = sigma2 == 0
    if x.is_complex():
        trivial = trivial & (alpha.imag == 0)
    safe_beta = torch.where(beta == 0, 1.0, beta)
    tau = torch.where(trivial, 0.0, (safe_beta - alpha) / safe_beta)
    denom = alpha - safe_beta
    safe_denom = torch.where(denom == 0, 1.0, denom)
    return safe_denom, tau, torch.where(trivial, alpha.real, beta), trivial


def larfg(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reflector with pivot at element 0 of the last axis (leading axes batch).

    Returns ``(v, tau, beta)`` with ``v[0] = 1`` and ``H^H x = beta e_0``.  A
    zero tail (or an all-zero x) gives ``tau = 0`` and ``beta = x[0]``: the
    no-op that makes padded windows safe."""
    alpha = x[..., 0]
    sigma2 = _abs2(x[..., 1:]).sum(dim=-1)
    denom, tau, beta, trivial = _reflector(alpha, sigma2, x)
    v = torch.where(trivial[..., None], 0.0, x / denom[..., None])
    v[..., :1] = 1.0      # a slice: an element index would copy the 1 from the host
    return v, tau, beta


def larfg_masked(x: torch.Tensor, pivot: int):
    """Reflector for a full-height column with pivot row ``pivot`` (a host int).

    Zeroes ``x[pivot+1:]`` into ``x[pivot]``; rows above the pivot are ignored
    (zeros in v).  A pivot past the end reads ``x[n-1]`` as its alpha and
    yields a zero v, as the JAX package's clamped gather does (its ``tau`` can
    then be nonzero for complex data, harmlessly, since v = 0)."""
    n = x.shape[-1]
    tail = x.clone()
    tail[: pivot + 1] = 0
    alpha = x[min(pivot, n - 1)]
    sigma2 = _abs2(tail).sum()
    denom, tau, beta, trivial = _reflector(alpha, sigma2, x)
    v = torch.where(trivial, 0.0, tail / denom)
    v[pivot:pivot + 1] = 1.0      # empty past the end; a slice fills on the device
    return v, tau, beta


def apply_left(tau, v: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """A := H^H A = A - conj(tau) v (v^H A).  v: (m,), A: (m, n)."""
    w = torch.matmul(v.conj(), A)
    return A - torch.outer(v * tau.conj(), w)


def apply_right(tau, v: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """A := A H = A - tau (A v) v^H.  v: (n,), A: (m, n)."""
    w = torch.matmul(A, v)
    return A - torch.outer(w * tau, v.conj())


def panel_qr_masked(P: torch.Tensor, off: int, nb: int):
    """Householder QR of the rows ``off:`` of an (n, nb) panel via masks.

    Rows above ``off`` are untouched.  Returns ``(R, V, taus)``: R the
    transformed panel (exact zeros below each pivot), V (n, nb) the reflectors
    (unit pivot, zeros above), taus (nb,).  About 25 launches per column."""
    n, nb_ = P.shape
    V = torch.zeros_like(P)
    taus = torch.zeros((nb_,), dtype=P.dtype, device=P.device)
    R = P.clone()
    for i in range(nb_):
        p = off + i
        v, tau, _ = larfg_masked(R[:, i], p)
        R = apply_left(tau, v, R)
        # exact zeros below the pivot of column i (the reflector zeroes them
        # analytically; enforce numerically like the reference's panel)
        R[p + 1:, i] = 0
        V[:, i] = v
        taus[i] = tau
    return R, V, taus


def panel_lq_masked(P: torch.Tensor, off: int, nb: int):
    """Householder LQ of the cols ``off:`` of an (nb, n) row panel via masks:
    QR of the conjugate transpose.  Returns ``(L, V, taus)`` with V (n, nb) in
    column form, so ``P Q = L`` for ``Q = I - V T V^H``."""
    R, V, taus = panel_qr_masked(P.mH, off, nb)
    return R.mH.resolve_conj(), V, taus


def build_T(V: torch.Tensor, taus: torch.Tensor, off=None) -> torch.Tensor:
    """Compact-WY T factor, ``H_0 H_1 ... H_{nb-1} = I - V T V^H``, by the
    forward recurrence ``T[:i, i] = -tau_i T[:i, :i] (V[:, :i]^H v_i)``,
    ``T[i, i] = tau_i``.  One gemm plus 3 launches per column."""
    nb = V.shape[-1]
    T = torch.zeros((nb, nb), dtype=V.dtype, device=V.device)
    G = torch.matmul(V.conj().T, V)
    for i in range(nb):
        if i:
            T[:i, i] = -taus[i] * torch.matmul(T[:i, :i], G[:i, i])
        T[i, i] = taus[i]
    return T


_SWEEP_GROUP = 8


def sweep_accumulate(Vs: torch.Tensor, taus: torch.Tensor, n: int, b: int,
                     group: int = _SWEEP_GROUP, Q0: Optional[torch.Tensor] = None,
                     reverse: bool = False) -> torch.Tensor:
    """Accumulate ``Q = prod_s prod_r H_{s,r}`` (chronological) from bulge-chase
    reflectors whose supports within sweep s are the adjacent length-b blocks
    starting at ``s + 1 + r*b``.

    Supports within a sweep are disjoint, so each sweep is one batched rank-1
    update of the (m, m_max, b) block view of a column window: 3 launches per
    sweep (the projection, its scaling, one fused in-place update).  ``group``
    is the JAX package's register-level grouping of sweeps; eager PyTorch has
    no such fusion, so it is accepted for the signature and changes nothing
    (the sweeps run in the same order either way).  Returns the dense (n, n)
    Q or, with ``Q0`` (an (m, n) initial row block), ``Q0 · Q``.  ``reverse=True``
    returns ``Q0 · Q^H`` (the conjugate-transposed product in reverse order),
    so ``Q X`` for a thin X is ``sweep_accumulate(..., Q0=X^H, reverse=True)^H``.
    """
    n_sweeps, m_max, _ = Vs.shape
    dt = Vs.dtype
    if reverse:
        taus = taus.conj()
    # sweep s touches columns [s + 1, s + 1 + m_max*b): the zero padding keeps
    # every window in range, where the JAX package pads for its grouped window
    ncols = n + m_max * b + 1
    m = n if Q0 is None else Q0.shape[-2]
    Q = torch.zeros((m, ncols), dtype=dt, device=Vs.device)
    if Q0 is None:
        Q.diagonal().fill_(1.0)
    else:
        Q[:, :n] = Q0.to(dt)
    Vc = Vs.conj()
    order = range(n_sweeps - 1, -1, -1) if reverse else range(n_sweeps)
    for s in order:
        S = Q[:, s + 1: s + 1 + m_max * b].view(m, m_max, b)
        y = torch.einsum("nrb,rb->nr", S, Vs[s]).mul_(taus[s])
        S.addcmul_(y[:, :, None], Vc[s][None], value=-1)
    return Q[:, :n]


def block_apply_left(V: torch.Tensor, T: torch.Tensor, C: torch.Tensor,
                     conj_q: bool = False) -> torch.Tensor:
    """C := Q C (or Q^H C with conj_q) for Q = I - V T V^H, three gemms."""
    Tm = T.conj().T if conj_q else T
    W = torch.matmul(V.conj().T, C)
    return C - torch.matmul(V, torch.matmul(Tm, W))


def block_apply_right(V: torch.Tensor, T: torch.Tensor, C: torch.Tensor,
                      conj_q: bool = False) -> torch.Tensor:
    """C := C Q (or C Q^H with conj_q) for Q = I - V T V^H."""
    Tm = T.conj().T if conj_q else T
    W = torch.matmul(C, V)
    return C - torch.matmul(torch.matmul(W, Tm), V.conj().T)
