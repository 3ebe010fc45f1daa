"""ex19: subset solvers — index-range eigenpairs, spectral counting and top-k
singular triplets, in float64 (the port's form of
examples/ex19_subset_eig_svd.py)."""

import numpy as np

import common
import slate_tpu_torch as slate
from slate_tpu_torch import lapack_api as lp


def main(device):
    rng = np.random.default_rng(19)
    n = 128
    m = rng.standard_normal((n, n))
    a = (m + m.T) / 2
    A = common.tensor(a, device)
    ref = np.linalg.eigvalsh(a)

    # the 10 smallest eigenpairs
    lam, Z = slate.heev_range(A, il=0, iu=10)
    lam, Z = common.host(lam), common.host(Z)
    print("smallest-10 err:", np.max(np.abs(lam - ref[:10])))
    resid = np.linalg.norm(a @ Z - Z * lam[None, :])
    print("residual:", resid)
    assert np.max(np.abs(lam - ref[:10])) < 1e-10
    assert resid < 1e-9 * n

    # how many eigenvalues in [-1, 1)?
    c = slate.eig_count(A, -1.0, 1.0)
    expect = int(np.sum((ref >= -1.0) & (ref < 1.0)))
    print(f"eig_count([-1,1)): {int(c)} (dense check {expect})")
    assert int(c) == expect

    # top-5 singular triplets of a rectangular matrix
    g = rng.standard_normal((192, 96))
    sref = np.linalg.svd(g, compute_uv=False)
    S, U, VT = slate.svd_range(common.tensor(g, device), il=0, iu=5)
    S, U, VT = common.host(S), common.host(U), common.host(VT)
    print("top-5 sigma err:", np.max(np.abs(S - sref[:5])))
    rec = g @ VT.T - U * S[None, :]
    print("triplet residual:", np.linalg.norm(rec))
    assert np.max(np.abs(S - sref[:5])) < 1e-10
    assert np.linalg.norm(rec) < 1e-9

    # LAPACK-skin forms (1-based inclusive ranges)
    lam2, _ = lp.dsyevx("N", "L", a.copy(), 1, 10, device=device)
    assert np.max(np.abs(lam2 - ref[:10])) < 1e-10
    S2, _, _ = lp.dgesvdx("N", "N", g.copy(), 1, 5, device=device)
    assert np.max(np.abs(S2 - sref[:5])) < 1e-10
    print("ex19 OK")


if __name__ == "__main__":
    common.run(main)
