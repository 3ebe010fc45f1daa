"""ex08: Hermitian-indefinite systems — hesv / hetrf / hetrs, Aasen's
factorization (the port's form of examples/ex08_linear_system_indefinite.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    n = 96
    A0, S = slate.generate_matrix("heev_geo", n, cond=50.0, seed=6, device=device)
    a = common.host(A0)
    assert (common.host(S) < 0).any()     # genuinely indefinite
    b = np.random.default_rng(7).standard_normal((n, 2)).astype(np.float32)
    B = common.tensor(b, device)

    out = slate.hesv(A0.clone(), B.clone(), None)
    x = common.host(out[0])
    print("hesv resid:", np.linalg.norm(a @ x - b))
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-3

    # factor once / solve many (hetrf + hetrs)
    fac, info = slate.hetrf(A0.clone())
    x2 = slate.hetrs(fac, B.clone())
    np.testing.assert_allclose(common.host(x2), x, rtol=1e-3, atol=1e-4)
    print("ex08 OK")


if __name__ == "__main__":
    common.run(main)
