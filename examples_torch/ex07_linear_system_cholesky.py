"""ex07: SPD linear systems — posv / potrf and the condition estimate
(the port's form of examples/ex07_linear_system_cholesky.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    n = 256
    A0, _ = slate.generate_matrix("spd_geo", n, cond=100.0, seed=4, device=device)
    a = common.host(A0)
    b = np.random.default_rng(5).standard_normal((n, 4)).astype(np.float32)

    M = slate.HermitianMatrix.from_array(slate.Uplo.Lower, A0.clone(), nb=64)
    B = slate.Matrix.from_array(common.tensor(b, device), nb=64)
    X, info = slate.posv(M, B)
    assert int(info) == 0
    print("posv resid:", np.linalg.norm(a @ common.host(B) - b))

    # factor / solve split + condition estimate
    L, info = slate.potrf(slate.HermitianMatrix.from_array(slate.Uplo.Lower, A0.clone(), nb=64))
    rcond = float(slate.pocondest(L, slate.norm("one", M)))
    print("pocondest rcond:", rcond)
    assert 0 < rcond < 1
    print("ex07 OK")


if __name__ == "__main__":
    common.run(main)
