"""ex16: the distributed band, indefinite and inverse drivers — band Cholesky
on compact storage, the Aasen indefinite solve, the SPD inverse and the LQ
minimum-norm least squares over a 2x4 process grid (the port's form of
examples/ex16_distributed_band_indefinite.py).  On the CPU the grid is eight
gloo ranks; on one card it is 1x1."""

import numpy as np

import common


def job(device):
    """Every rank builds the same inputs and calls each driver on the grid;
    the residuals come back as numbers."""
    import torch

    from slate_tpu_torch.parallel import (dense_to_band_lower, gels_lq_distributed,
                                          hesv_distributed, pbsv_distributed,
                                          potrf_distributed, potri_distributed)
    from slate_tpu_torch.parallel.launch import to_host

    grid = common.grid(2, 4, device)
    if grid is None:
        return None
    rng = np.random.default_rng(16)
    n, kd, nb = 192, 7, 16
    out = {"grid": f"{grid.p}x{grid.q}"}

    def t(x):
        return torch.as_tensor(x).to(device)

    # SPD band system on compact (kd+1, n) storage
    A = np.zeros((n, n), np.float32)
    for j in range(1, kd + 1):
        v = rng.standard_normal(n - j).astype(np.float32)
        A += np.diag(v, j) + np.diag(v, -j)
    A += np.diag(np.abs(rng.standard_normal(n)).astype(np.float32) + 4 * kd)
    Ab = dense_to_band_lower(t(np.tril(A)), kd)
    B = rng.standard_normal((n, 3)).astype(np.float32)
    X, info = pbsv_distributed(Ab, t(B), grid, kd, nb=nb)
    out["pbsv"] = float(np.linalg.norm(A @ to_host(X) - B) / np.linalg.norm(B))
    out["pbsv_info"] = int(info)

    # Hermitian-indefinite (Aasen) solve over the grid
    H = rng.standard_normal((n, n)).astype(np.float32)
    H = (H + H.T) / 2
    Xh, info = hesv_distributed(t(H), t(B), grid, nb=nb)
    out["hesv"] = float(np.linalg.norm(H @ to_host(Xh) - B) / np.linalg.norm(B))

    # SPD inverse: potrf + potri on the grid
    S = (H @ H.T + n * np.eye(n)).astype(np.float32)
    L = potrf_distributed(t(S), grid, nb=32)
    Sinv = to_host(potri_distributed(L, grid))
    full = np.tril(Sinv) + np.tril(Sinv, -1).T
    out["potri"] = float(np.linalg.norm(S @ full - np.eye(n)))

    # wide minimum-norm least squares through the distributed LQ
    W = rng.standard_normal((48, 160)).astype(np.float32)
    Bw = rng.standard_normal((48, 2)).astype(np.float32)
    Xmn = to_host(gels_lq_distributed(t(W), t(Bw), grid, nb=16))
    ref = np.linalg.lstsq(W, Bw, rcond=None)[0]
    out["gels_lq"] = float(np.linalg.norm(Xmn - ref) / max(np.linalg.norm(ref), 1e-30))
    return out


def main(device):
    out = common.on_ranks(job, device, 8)
    for k, v in out.items():
        print(f"{k}: {v}")
    assert out["pbsv_info"] == 0 and out["pbsv"] < 1e-4
    assert out["hesv"] < 1e-2 and out["potri"] < 1e-3 and out["gels_lq"] < 1e-3
    print("ex16 OK")


if __name__ == "__main__":
    common.run(main)
