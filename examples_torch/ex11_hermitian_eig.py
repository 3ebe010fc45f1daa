"""ex11: Hermitian eigenproblem — heev values + vectors, the two-stage
pipeline with its back-transforms (the port's form of
examples/ex11_hermitian_eig.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    n = 96
    A0, S = slate.generate_matrix("heev_geo", n, cond=100.0, seed=10, device=device)
    a = common.host(A0)

    lam, Z = slate.heev(A0.clone())
    lam, Z = common.host(lam), common.host(Z)
    np.testing.assert_allclose(np.sort(lam), np.sort(common.host(S)), rtol=1e-3, atol=1e-4)
    print("heev |AZ-ZL|:", np.linalg.norm(a @ Z - Z * lam[None, :]))

    # explicit two-stage pipeline with back-transforms
    band, refl, taus = slate.he2hb(A0.clone())
    d, e, Q2 = slate.hb2st(band, want_vectors=True)
    lam2, W = slate.steqr(d, e)
    W = slate.unmtr_hb2st("left", "n", Q2, W)
    W = common.host(slate.unmtr_he2hb("left", "n", refl, taus, W))
    err = np.linalg.norm(a @ W - W * common.host(lam2)[None, :]) / np.linalg.norm(a)
    print("two-stage |AZ-ZL|/|A|:", err)
    assert err < 1e-4
    print("ex11 OK")


if __name__ == "__main__":
    common.run(main)
