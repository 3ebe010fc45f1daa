"""ex12: generalized Hermitian eigenproblem A x = lambda B x — hegv / hegst
(the port's form of examples/ex12_generalized_hermitian_eig.py)."""

import numpy as np
from scipy.linalg import eigh as scipy_eigh

import common
import slate_tpu_torch as slate


def main(device):
    n = 64
    A0, _ = slate.generate_matrix("heev_geo", n, cond=50.0, seed=11, device=device)
    B0, _ = slate.generate_matrix("spd_geo", n, cond=10.0, seed=12, device=device)
    a, bmat = common.host(A0), common.host(B0)

    lam, Z = slate.hegv(1, A0.clone(), B0.clone())
    lam, Z = common.host(lam), common.host(Z)
    ref = scipy_eigh(a.astype(np.float64), bmat.astype(np.float64), eigvals_only=True)
    np.testing.assert_allclose(np.sort(lam), ref, rtol=1e-2, atol=1e-3)
    resid = np.linalg.norm(a @ Z - (bmat @ Z) * lam[None, :]) / np.linalg.norm(a)
    print("hegv |AZ - BZL|/|A|:", resid)
    assert resid < 1e-3

    # the hegst standard-form transform by itself
    L, info = slate.potrf(slate.HermitianMatrix.from_array(slate.Uplo.Lower, B0.clone(), nb=32))
    C = slate.hegst(1, A0.clone(), L)
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(common.host(C))), ref,
                               rtol=1e-2, atol=1e-3)
    print("ex12 OK")


if __name__ == "__main__":
    common.run(main)
