"""ex18: the distributed stage 2 — the segment-parallel bulge chases (hb2st
for eig, tb2bd for SVD) on a 2x4 grid and the two-stage drivers that use
them on a 2x2 grid (the port's form of examples/ex18_distributed_chase.py).
On the CPU the world is eight gloo ranks; on one card every grid is 1x1."""

import numpy as np

import common


def job(device):
    import torch

    from slate_tpu_torch.parallel import (hb2st_chase_distributed, heev_distributed,
                                          svd_distributed, tb2bd_chase_distributed)
    from slate_tpu_torch.parallel.launch import to_host

    chase_grid = common.grid(2, 4, device)
    driver_grid = common.grid(2, 2, device)       # every rank builds both grids
    rng = np.random.default_rng(18)
    n, kd = 192, 6
    m = rng.standard_normal((n, n)).astype(np.float32)
    sym = (m + m.T) / 2
    ii = np.arange(n)
    hband = np.where(np.abs(ii[:, None] - ii[None, :]) <= kd, sym, 0).astype(np.float32)
    uband = np.where((ii[None, :] >= ii[:, None]) & (ii[None, :] - ii[:, None] <= kd),
                     m, 0).astype(np.float32)
    out = {"grids": [None if g is None else f"{g.p}x{g.q}"
                     for g in (chase_grid, driver_grid)]}

    def t(x):
        return torch.as_tensor(x).to(device)

    if chase_grid is not None:
        d, e_c, _, _ = hb2st_chase_distributed(t(hband), kd, chase_grid)
        d, e_c = to_host(d), np.abs(to_host(e_c))
        T = np.diag(d) + np.diag(e_c, -1) + np.diag(e_c, 1)
        out["hb2st"] = float(np.max(np.abs(np.linalg.eigvalsh(T)
                                           - np.linalg.eigvalsh(hband))))
        db, eb, *_ = tb2bd_chase_distributed(t(uband), kd, chase_grid)
        Bd = np.diag(np.abs(to_host(db))).astype(np.float64)
        Bd[np.arange(n - 1), np.arange(1, n)] = np.abs(to_host(eb))
        out["tb2bd"] = float(np.max(np.abs(np.linalg.svd(Bd, compute_uv=False)
                                           - np.linalg.svd(uband, compute_uv=False))))
    if driver_grid is not None:
        lam, Z = heev_distributed(t(sym), driver_grid, nb=8, want_vectors=True,
                                  chase_distributed=True)
        lam, Z = to_host(lam), to_host(Z)
        out["heev"] = float(np.linalg.norm(sym @ Z - Z * lam[None, :])
                            / (np.linalg.norm(sym) * n))
        S, U, VT = svd_distributed(t(m), driver_grid, nb=8, want_vectors=True,
                                   chase_distributed=True)
        rec = to_host(U) * to_host(S)[None, :] @ to_host(VT)
        out["svd"] = float(np.linalg.norm(rec - m) / np.linalg.norm(m))
    return out


def main(device):
    out = common.on_ranks(job, device, 8)
    print("grids (chase, drivers):", out["grids"])
    print("hb2st_chase_distributed spectrum err:", out["hb2st"])
    print("tb2bd_chase_distributed singular-value err:", out["tb2bd"])
    print("heev_distributed(chase_distributed) resid:", out["heev"])
    print("svd_distributed(chase_distributed) reconstruction:", out["svd"])
    assert out["hb2st"] < 1e-3 and out["tb2bd"] < 1e-3
    assert out["heev"] < 1e-6 and out["svd"] < 1e-4
    print("ex18 OK")


if __name__ == "__main__":
    common.run(main)
