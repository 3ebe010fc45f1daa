"""ex04: matrix norms — max/one/inf/fro over general/hermitian/triangular
(the port's form of examples/ex04_norm.py).  On a card the column and row
reductions run the port's CUDA kernels (col_reduce, row_sums)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    a = np.random.default_rng(1).standard_normal((200, 150)).astype(np.float32)
    A = slate.Matrix.from_array(common.tensor(a, device), nb=64)
    for which, ref in [("max", np.abs(a).max()), ("one", np.abs(a).sum(0).max()),
                       ("inf", np.abs(a).sum(1).max()), ("fro", np.linalg.norm(a))]:
        v = float(slate.norm(which, A))
        print(f"norm {which}: {v:.4f} (numpy {ref:.4f})")
        assert abs(v - ref) < 1e-2 * max(1.0, ref)

    # column-scope (colNorms)
    cn = common.host(slate.col_norms("max", A))
    np.testing.assert_allclose(cn, np.abs(a).max(0), rtol=1e-5)

    # hermitian norm from the stored triangle only
    h = a[:150] + a[:150].T
    H = slate.HermitianMatrix.from_array(slate.Uplo.Lower, common.tensor(h, device), nb=64)
    assert abs(float(slate.norm("one", H)) - np.abs(h).sum(0).max()) < 1e-2
    print("ex04 OK")


if __name__ == "__main__":
    common.run(main)
