"""ex05: parallel BLAS-3 — gemm / herk / trsm (the port's form of
examples/ex05_blas.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    r = np.random.default_rng(2)
    n = 256
    a = r.standard_normal((n, n)).astype(np.float32)
    b = r.standard_normal((n, n)).astype(np.float32)
    c = r.standard_normal((n, n)).astype(np.float32)

    def M(x):
        return slate.Matrix.from_array(common.tensor(x, device), nb=64)

    C = M(c)
    slate.gemm(1.0, M(a), M(b), 0.5, C)
    np.testing.assert_allclose(common.host(C), a @ b + 0.5 * c, rtol=1e-3, atol=1e-3)

    # herk updates only the stored triangle
    H = slate.HermitianMatrix.from_array(slate.Uplo.Lower, common.tensor(a @ a.T, device), nb=64)
    slate.herk(1.0, M(b), 1.0, H)
    np.testing.assert_allclose(common.host(H.full_array()), a @ a.T + b @ b.T,
                               rtol=1e-2, atol=1e-2)

    # triangular solve
    t = np.tril(a) + n * np.eye(n, dtype=np.float32)
    B = M(b)
    slate.trsm("left", 1.0, slate.TriangularMatrix.from_array(
        slate.Uplo.Lower, common.tensor(t, device), nb=64), B)
    np.testing.assert_allclose(t @ common.host(B), b, rtol=1e-3, atol=1e-3)
    print("ex05 OK")


if __name__ == "__main__":
    common.run(main)
