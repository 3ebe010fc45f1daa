"""ex15: setting matrix entries — set/scale/add elementwise drivers and matgen
kinds (the port's form of examples/ex15_set_matrix.py)."""

import numpy as np
import torch

import common
import slate_tpu_torch as slate


def main(device):
    A = slate.Matrix.from_array(torch.zeros((6, 6), device=device), nb=2)

    # set(offdiag, diag) — geset
    slate.set(1.0, 5.0, A)
    a = common.host(A)
    assert (np.diag(a) == 5).all() and a[0, 1] == 1

    # scale by numer/denom (overflow-safe two-scalar form)
    slate.scale(3.0, 2.0, A)
    assert np.diag(common.host(A))[0] == 7.5

    # add: B = alpha A + beta B
    B = slate.Matrix.from_array(torch.ones((6, 6), device=device), nb=2)
    slate.add(2.0, A, 1.0, B)
    assert common.host(B)[0, 1] == 2 * 1.5 + 1   # offdiag
    assert common.host(B)[0, 0] == 2 * 7.5 + 1   # diag

    # named generator kinds (matgen)
    hilb, _ = slate.generate_matrix("hilb", 4, device=device)
    np.testing.assert_allclose(common.host(hilb)[0], [1, 1 / 2, 1 / 3, 1 / 4], rtol=1e-5)
    print("ex15 OK")


if __name__ == "__main__":
    common.run(main)
