"""ex03: sub-matrices and slices — cheap views sharing storage
(the port's form of examples/ex03_submatrix.py)."""

import numpy as np
import torch

import common
import slate_tpu_torch as slate


def main(device):
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    A = slate.Matrix.from_array(common.tensor(a, device), nb=2)

    # tile-aligned sub-matrix: tiles [1..2] x [0..1]
    S = A.sub(1, 2, 0, 1)
    np.testing.assert_array_equal(common.host(S), a[2:6, 0:4])

    # element slice at arbitrary offsets
    L = A.slice(3, 6, 1, 4)
    np.testing.assert_array_equal(common.host(L), a[3:7, 1:5])

    # writes through a view land in the shared storage
    S.set_array(torch.zeros((4, 4), device=device))
    assert not common.host(A)[2:6, 0:4].any()
    print("ex03 OK")


if __name__ == "__main__":
    common.run(main)
