"""ex02: converting between matrix types — general <-> hermitian/triangular views
(the port's form of examples/ex02_conversion.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    a = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    A = slate.Matrix.from_array(common.tensor(a, device), nb=4)

    # view the lower triangle as Hermitian / the upper as triangular
    H = slate.HermitianMatrix.from_array(slate.Uplo.Lower, A.array, nb=4)
    np.testing.assert_allclose(common.host(H.full_array()), np.tril(a) + np.tril(a, -1).T)

    T = slate.TriangularMatrix.from_array(slate.Uplo.Upper, common.tensor(a, device), nb=4)
    np.testing.assert_allclose(common.host(T.masked_array()), np.triu(a))

    # transpose is a flag flip — same storage
    At = A.T
    assert At.m == A.n and float(At.tile(0, 0)[1, 0]) == a[0, 1]
    print("ex02 OK")


if __name__ == "__main__":
    common.run(main)
