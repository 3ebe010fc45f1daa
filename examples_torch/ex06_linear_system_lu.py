"""ex06: LU linear systems — gesv, factor/solve split, tournament pivoting, RBT
(the port's form of examples/ex06_linear_system_lu.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    r = np.random.default_rng(3)
    n = 128
    a = r.standard_normal((n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
    b = r.standard_normal((n, 4)).astype(np.float32)
    A, B = common.tensor(a, device), common.tensor(b, device)

    X, perm, info = slate.gesv(A.clone(), B.clone())
    assert int(info) == 0
    print("gesv resid:", np.linalg.norm(a @ common.host(X) - b))

    # factor once, solve twice (getrf + getrs)
    lu_, perm, info = slate.getrf(A.clone())
    x1 = slate.getrs(lu_, perm, B.clone())
    x2 = slate.getrs(lu_, perm, 2 * B)
    np.testing.assert_allclose(common.host(x2), 2 * common.host(x1), rtol=1e-4)

    # communication-avoiding tournament pivoting (CALU)
    lu2, perm2, info2 = slate.getrf_tntpiv(A.clone())
    x3 = slate.getrs(lu2, perm2, B.clone())
    assert np.linalg.norm(a @ common.host(x3) - b) < 1e-2

    # random butterfly transform avoids pivoting entirely
    out = slate.gesv_rbt(A.clone(), B[:, :1].clone())
    assert np.linalg.norm(a @ common.host(out[0]) - b[:, :1]) < 1e-2
    print("ex06 OK")


if __name__ == "__main__":
    common.run(main)
