"""Distributed bulge chase: the pipelined hb2st / tb2bd schedules split over
the flattened grid.

The reference confines stage 2 to rank 0 (src/hb2st.cc scheduling consumed on
one process; src/heev.cc:137-160 gathers the band there).  Here, as in the
JAX package, the band's column range is cut into P contiguous segments of
``seg = ceil(n/P)`` columns; each rank runs only the chase fronts whose
window anchor lies in its own segment, on a local tile of its segment plus a
one-column (hb2st) or b+1-column (tb2bd) left margin and a 2b right halo, and
neighbours reconcile through point-to-point exchanges each round:

- a (2b+1)×(2b+1) boundary square in each direction, the region both tiles
  hold.  Concurrent fronts write element-disjoint footprints (the schedule
  spaces live fronts 2b-1 apart), so each element of the square is written
  by at most one of the two ranks in a round.  Each rank sends the square as
  it stands after its round, and the receiver keeps the elements whose bits
  it changed itself and takes the sender's for the rest.  That is exact: the
  two copies stay equal bit for bit, where a sum of deltas (the JAX
  package's reconciliation) can round;
- at most one crossing reflector (v, tau) to the right: a front advances b
  columns per round and fronts are 2b-1 apart, so per boundary per round at
  most one front hops segments, carrying its reflector to the next owner.

The exchanges are not cyclic: rank 0 has no left partner and the last rank
no right one (:func:`.collectives.neighbor_exchange`).  Every rank sends
O(b²) elements a round, whatever n is.  The schedule does not depend on the
data, so each rank builds its own part of it on the host once, and knows in
which rounds a reflector crosses in from the left.

The per-window arithmetic is that of the single-device pipelined chases
(:func:`..linalg.eig._hb2st_chase_pipelined`,
:func:`..linalg.svd._tb2bd_chase_pipelined`) op for op, so the results equal
theirs bit for bit on the same device (``tests/test_torch_eig_dist.py``).
At the end, one all-gather each assembles d and e, and one sum each the
reflector stacks (every entry has one owner).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.exceptions import slate_assert
from ..obs import instrument
from .collectives import axis_allgather, axis_allreduce, axis_index, neighbor_exchange
from .mesh import FLAT, ProcessGrid

AX = FLAT                                  # flattened grid axis


def _schedule(n: int, b: int, c0: int, c1: int, n_sweeps: int, m_max: int,
              bidiag: bool):
    """The part of the pipelined schedule a segment [c0, c1) runs.

    Sweep s starts at round 2s (hebr1/gebr1) and its front r = t - 2s + 1
    sits at anchor j = t·b + 1 - s(2b-1) (hb2st) or (t+1)·b + 1 - s(2b-1)
    (tb2bd) in round t.  Returns ``(T, start, fronts, off, cross)``: the
    round count; per round the sweep whose first step this segment runs (or
    -1: hebr1 belongs to the owner of its r = 1 anchor s+1, gebr1 to that of
    min(s+b+1, n-1)); the live fronts (s, r, j) in round order with per-round
    offsets; and per round the sweep whose front leaves the segment to the
    right (or -1)."""
    T = 2 * n_sweeps + m_max
    start = np.full(T, -1, np.int64)
    cross = np.full(T, -1, np.int64)
    fronts, off = [], [0]
    step = 2 * b - 1
    for t in range(T):
        s0 = t // 2
        if t % 2 == 0 and s0 < n_sweeps:
            own = min(s0 + b + 1, n - 1) if bidiag else s0 + 1
            if c0 <= own < c1:
                start[t] = s0
        base = (t + 1) * b + 1 if bidiag else t * b + 1
        for s in range(max(0, -(-(base - c1 + 1) // step)), (base - c0) // step + 1):
            j, r = base - s * step, t - 2 * s + 1
            if s >= n_sweeps or r < 1 or not c0 <= j < c1:
                continue
            live = j < n if bidiag else r < -(-(n - 1 - s) // b)
            if live:
                fronts.append((s, r, j))
                if j >= c1 - b:
                    cross[t] = s
        off.append(len(fronts))
    arr = np.array(fronts, np.int64).reshape(-1, 3)
    return T, start, arr, np.array(off), cross


class _Segment:
    """One rank's segment: its bounds, its tile (cut from the whole band),
    the store of the reflectors its sweeps carry (slot s mod S_cap), and the
    boundary exchange with its neighbours."""

    def __init__(self, Afull, b: int, grid: ProcessGrid, lm: int, M: int,
                 sq0_left: int, sq0_right: int, n_sweeps: int, m_max: int,
                 bidiag: bool):
        n = Afull.shape[-1]
        P = grid.size
        self.grid, self.b, self.n, self.P = grid, b, n, P
        self.seg = seg = -(-n // P)
        self.p = p = axis_index(grid, AX)
        self.c0, self.c1 = c0, c1 = p * seg, (p + 1) * seg
        self.g0 = g0 = max(c0 - lm, 0)
        dt, dev = Afull.dtype, Afull.device
        # the tile: global rows/cols [g0, g0 + M), zero past c1 + 2b (the
        # halo) and past n (the padding the single-device chase has too)
        tile = torch.zeros((M, M), dtype=dt, device=dev)
        hi = min(c1 + 2 * b, n)
        if hi > g0:
            tile[:hi - g0, :hi - g0] = Afull[g0:hi, g0:hi]
        self.tile = tile
        self.M = M
        self.sq = 2 * b + 1
        self.lL = max(sq0_left(c0), 0) - g0        # left boundary square
        self.lR = sq0_right(c1) - g0               # right boundary square
        self.left, self.right = p > 0, p < P - 1
        self.T, self.start, self.fronts, self.off, self.cross = _schedule(
            n, b, c0, c1, n_sweeps, m_max, bidiag)
        if self.left:
            self.incoming = _schedule(n, b, c0 - seg, c0, n_sweeps, m_max, bidiag)[4]
        self.S_cap = seg // (2 * b - 1) + 3
        self.stv = torch.zeros((self.S_cap, b), dtype=dt, device=dev)
        self.stt = torch.zeros((self.S_cap,), dtype=dt, device=dev)

    def up(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.tile.device)

    def _square(self, l0: int):
        return self.tile[l0:l0 + self.sq, l0:l0 + self.sq]

    def snapshot(self):
        if self.P == 1:
            return None
        return self._square(self.lL).clone(), self._square(self.lR).clone()

    def reconcile(self, t: int, snap, v, tau, crossing) -> None:
        """The round's boundary exchange (a no-op on a grid of one rank)."""
        if self.P == 1:
            return
        b, sq = self.b, self.sq
        newL, newR = self._square(self.lL).clone(), self._square(self.lR).clone()
        carry = torch.zeros((b + 1,), dtype=self.tile.dtype, device=self.tile.device)
        if crossing is not None:                 # the front that leaves to the right
            carry[:b], carry[b] = v[crossing], tau[crossing]
        to_right = torch.cat([newR.reshape(-1), carry])
        from_left, from_right = neighbor_exchange(to_right, newL.reshape(-1),
                                                  self.grid, AX)
        if self.left:
            theirs = from_left[:sq * sq].view(sq, sq)
            self._square(self.lL).copy_(torch.where(_changed(newL, snap[0]), newL, theirs))
            s_in = int(self.incoming[t])
            if s_in >= 0:
                self.stv[s_in % self.S_cap] = from_left[sq * sq:sq * sq + b]
                self.stt[s_in % self.S_cap] = from_left[-1]
        if self.right:
            theirs = from_right.view(sq, sq)
            self._square(self.lR).copy_(torch.where(_changed(newR, snap[1]), newR, theirs))

    def crossing(self, t: int):
        """Index in the round's front batch of the front that crosses right."""
        s = int(self.cross[t])
        if s < 0 or self.P == 1:
            return None
        batch = self.fronts[self.off[t]:self.off[t + 1], 0]
        return int(np.nonzero(batch == s)[0][0])

    def owned(self):
        """Local indices of the owned diagonal entries [c0, min(c1, n))."""
        hi = min(self.c1, self.n)
        return torch.arange(self.c0 - self.g0, max(hi, self.c0) - self.g0,
                            device=self.tile.device)

    def assemble(self, x: torch.Tensor, length: int) -> torch.Tensor:
        """The owned pieces of a diagonal, whole on every rank."""
        pad = self.seg - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        return axis_allgather(x, self.grid, AX)[:length]


_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _changed(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Whether the bits of each element of ``new`` differ from ``old``."""
    if new.is_complex():
        new, old = torch.view_as_real(new), torch.view_as_real(old)
        it = _INT[new.element_size()]
        return (new.view(it) != old.view(it)).any(-1)
    it = _INT[new.element_size()]
    return new.view(it) != old.view(it)


def _check(n: int, b: int, P: int, what: str, n_min: int):
    slate_assert(b >= 2 and n > n_min, f"{what} needs kd >= 2 and n > {n_min}")
    seg = -(-n // P)
    slate_assert(seg >= 2 * b + 2,
                 f"segment {seg} too narrow for bandwidth {b} on {P} ranks"
                 " (need n/P >= 2*kd+2); use the replicated chase")


@instrument
def hb2st_chase_distributed(Afull, kd: int, grid: ProcessGrid,
                            want_vectors: bool = False):
    """Segment-parallel Hermitian bulge chase over ``grid``'s flattened ranks.

    ``Afull``: the full Hermitian band (dense storage, bandwidth ``kd``), the
    same on every rank.  Returns ``(d, e_complex, Vs, taus)`` equal to
    ``linalg.eig._hb2st_chase_pipelined``'s and the same on every rank
    (``Vs``/``taus`` are zeros without ``want_vectors``).  Needs
    ``ceil(n/P) >= 2·kd + 2``."""
    from ..linalg import householder as hh
    from ..linalg.eig import _hebr1_window

    n = Afull.shape[-1]
    b = int(kd)
    _check(n, b, grid.size, "chase", 2)
    n_sweeps = max(n - 2, 0)
    m_max = max(-(-(n - 1) // b), 1)
    seg = -(-n // grid.size)
    S = _Segment(Afull, b, grid, 1, seg + 4 * b + 4, lambda c0: c0 - 1,
                 lambda c1: c1 - 1, n_sweeps, m_max, False)
    tile, M, g0 = S.tile, S.M, S.g0
    dt, dev = tile.dtype, tile.device
    F = S.fronts
    I, J = F[:, 2] + b - g0, F[:, 2] - g0          # window rows / columns
    baseW, baseM, baseD = S.up(I * M + J), S.up(J * M + I), S.up(I * M + I)
    slot = S.up(F[:, 0] % S.S_cap)
    sr = S.up(F[:, 0] * m_max + F[:, 1])
    ar = torch.arange(b, device=dev)
    offs = ar[:, None] * M + ar[None, :]
    Vs = torch.zeros((n_sweeps * m_max if want_vectors else 0, b), dtype=dt, device=dev)
    taus = torch.zeros((Vs.shape[0],), dtype=dt, device=dev)
    tf = tile.view(-1)
    for t in range(S.T):
        snap = S.snapshot()
        s0 = int(S.start[t])
        if s0 >= 0:                                    # hebr1 of sweep s0
            a1 = s0 - g0
            W, v0, tau0 = _hebr1_window(tile[a1:a1 + b + 1, a1:a1 + b + 1])
            tile[a1:a1 + b + 1, a1:a1 + b + 1] = W
            S.stv[s0 % S.S_cap], S.stt[s0 % S.S_cap] = v0, tau0
            if want_vectors:
                Vs[s0 * m_max], taus[s0 * m_max] = v0, tau0
        lo, hi = int(S.off[t]), int(S.off[t + 1])
        v = tau = None
        if hi > lo:
            k = slice(lo, hi)
            vprev, tprev = S.stv[slot[k]], S.stt[slot[k]]
            iw = baseW[k][:, None, None] + offs
            Wb = tf[iw]
            Wv = torch.matmul(Wb, vprev[:, :, None])
            Wb = Wb - (tprev[:, None, None] * Wv) * vprev.conj()[:, None, :]
            v, tau, _ = hh.larfg(Wb[:, :, 0])
            vW = torch.matmul(v.conj()[:, None, :], Wb)
            Wb = Wb - (tau.conj()[:, None, None] * v[:, :, None]) * vW
            tf[iw] = Wb
            tf[baseM[k][:, None, None] + offs] = Wb.mH
            idd = baseD[k][:, None, None] + offs
            Db = tf[idd]
            Dv = torch.matmul(v.conj()[:, None, :], Db)
            Db = Db - (tau.conj()[:, None, None] * v[:, :, None]) * Dv
            Dw = torch.matmul(Db, v[:, :, None])
            Db = Db - (tau[:, None, None] * Dw) * v.conj()[:, None, :]
            tf[idd] = Db
            S.stv[slot[k]], S.stt[slot[k]] = v, tau
            if want_vectors:
                Vs[sr[k]], taus[sr[k]] = v, tau
        S.reconcile(t, snap, v, tau, S.crossing(t))
    lx = S.owned()
    d = S.assemble(tile[lx, lx].real, n)
    e_c = S.assemble(tile[lx + 1, lx], n)[:n - 1]
    if want_vectors:
        Vs = axis_allreduce(Vs, grid, AX).view(n_sweeps, m_max, b)
        taus = axis_allreduce(taus, grid, AX).view(n_sweeps, m_max)
    else:
        Vs = torch.zeros((n_sweeps, m_max, b), dtype=dt, device=dev)
        taus = torch.zeros((n_sweeps, m_max), dtype=dt, device=dev)
    return d, e_c, Vs, taus


@instrument
def tb2bd_chase_distributed(Bfull, kd: int, grid: ProcessGrid,
                            want_vectors: bool = False):
    """Segment-parallel bidiagonal chase (the SVD's stage 2) over ``grid``.

    ``Bfull``: the square upper band (bandwidth ``kd``), dense storage, the
    same on every rank.  Returns ``(d_c, e_c, Us, tauus, Vs, tauvs)`` equal
    to ``linalg.svd._tb2bd_chase_pipelined``'s (reflector stacks are zeros
    without ``want_vectors``).  The gebr1 window reaches b+1 columns left of
    its sweep's r = 1 anchor, so tiles carry a b+1 left margin; the boundary
    squares sit at [boundary - b - 1, boundary + b); the carried reflector is
    the left one, u."""
    from ..linalg import householder as hh
    from ..linalg.svd import _gebr1

    n = Bfull.shape[-1]
    b = int(kd)
    _check(n, b, grid.size, "tb2bd chase", 1)
    n_sweeps = max(n - 1, 0)
    m_max = max(-(-(n - 1) // b), 1)
    seg = -(-n // grid.size)
    lm = b + 1
    S = _Segment(Bfull, b, grid, lm, seg + 4 * b + lm + 3,
                 lambda c0: c0 - b - 1, lambda c1: c1 - b - 1, n_sweeps, m_max, True)
    tile, M, g0 = S.tile, S.M, S.g0
    dt, dev = tile.dtype, tile.device
    F = S.fronts
    I, J = F[:, 2] - b - g0, F[:, 2] - g0
    baseW, baseD = S.up(I * M + J), S.up(J * M + J)
    slot = S.up(F[:, 0] % S.S_cap)
    sr = S.up(F[:, 0] * m_max + F[:, 1])
    ar = torch.arange(b, device=dev)
    offs = ar[:, None] * M + ar[None, :]
    nv = n_sweeps * m_max if want_vectors else 0
    Us = torch.zeros((nv, b), dtype=dt, device=dev)
    tauus = torch.zeros((nv,), dtype=dt, device=dev)
    Vs = torch.zeros((nv, b), dtype=dt, device=dev)
    tauvs = torch.zeros((nv,), dtype=dt, device=dev)
    tf = tile.view(-1)
    for t in range(S.T):
        snap = S.snapshot()
        s0 = int(S.start[t])
        if s0 >= 0:                                    # gebr1 of sweep s0
            u0, tauu0, v0, tauv0 = _gebr1(tile, s0 - g0, b)
            S.stv[s0 % S.S_cap], S.stt[s0 % S.S_cap] = u0, tauu0
            if want_vectors:
                Us[s0 * m_max], tauus[s0 * m_max] = u0, tauu0
                Vs[s0 * m_max], tauvs[s0 * m_max] = v0, tauv0
        lo, hi = int(S.off[t]), int(S.off[t + 1])
        u = tauu = None
        if hi > lo:
            k = slice(lo, hi)
            uprev, tuprev = S.stv[slot[k]], S.stt[slot[k]]
            iw = baseW[k][:, None, None] + offs
            Wb = tf[iw]
            # gebr2: left-apply the previous u, then a new right v zeroing row 0
            uW = torch.matmul(uprev.conj()[:, None, :], Wb)
            Wb = Wb - (tuprev.conj()[:, None, None] * uprev[:, :, None]) * uW
            v, tauv, _ = hh.larfg(Wb[:, 0, :].conj())
            Wv = torch.matmul(Wb, v[:, :, None])
            Wb = Wb - (tauv[:, None, None] * Wv) * v.conj()[:, None, :]
            tf[iw] = Wb
            # gebr3: right-apply v on the diagonal window, new left u
            idd = baseD[k][:, None, None] + offs
            Db = tf[idd]
            Dv = torch.matmul(Db, v[:, :, None])
            Db = Db - (tauv[:, None, None] * Dv) * v.conj()[:, None, :]
            u, tauu, _ = hh.larfg(Db[:, :, 0])
            uD = torch.matmul(u.conj()[:, None, :], Db)
            Db = Db - (tauu.conj()[:, None, None] * u[:, :, None]) * uD
            tf[idd] = Db
            S.stv[slot[k]], S.stt[slot[k]] = u, tauu
            if want_vectors:
                Vs[sr[k]], tauvs[sr[k]] = v, tauv
                Us[sr[k]], tauus[sr[k]] = u, tauu
        S.reconcile(t, snap, u, tauu, S.crossing(t))
    lx = S.owned()
    d_c = S.assemble(tile[lx, lx], n)
    e_c = S.assemble(tile[lx, lx + 1], n)[:n - 1]
    shape = (n_sweeps, m_max)
    if want_vectors:
        Us, tauus, Vs, tauvs = (axis_allreduce(x, grid, AX).view(*shape, *x.shape[1:])
                                for x in (Us, tauus, Vs, tauvs))
    else:
        Us = Vs = torch.zeros(shape + (b,), dtype=dt, device=dev)
        tauus = tauvs = torch.zeros(shape, dtype=dt, device=dev)
    return d_c, e_c, Us, tauus, Vs, tauvs
