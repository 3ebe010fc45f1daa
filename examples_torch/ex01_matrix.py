"""ex01: creating matrices — ctors, from_array, typed variants, tile metadata
(the port's form of examples/ex01_matrix.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    # empty distributed matrix: m x n, tile nb, p x q grid
    A = slate.Matrix(512, 384, nb=128, p=2, q=2, device=device)
    print(f"A: {A.m}x{A.n}, tiles {A.mt}x{A.nt} of {A.mb}x{A.nb}, "
          f"grid {A.gridinfo()}, on {A.array.device}")
    assert (A.mt, A.nt) == (4, 3) and A.array.device.type == device.type

    # wrap existing data (fromLAPACK analogue)
    a = np.arange(36, dtype=np.float32).reshape(6, 6)
    B = slate.Matrix.from_array(common.tensor(a, device), nb=2)
    assert B.tileMb(2) == 2 and float(B.tile(1, 1)[0, 0]) == a[2, 2]

    # typed variants share the same storage design
    H = slate.HermitianMatrix.from_array(slate.Uplo.Lower, common.tensor(a @ a.T, device), nb=3)
    T = slate.TriangularMatrix.from_array(slate.Uplo.Upper, common.tensor(a, device), nb=3)
    S = slate.SymmetricMatrix.from_array(slate.Uplo.Lower, common.tensor(a + a.T, device), nb=3)
    print("typed:", type(H).__name__, type(T).__name__, type(S).__name__)

    # tile ownership on a 2x2 grid
    G = slate.Matrix(8 * 64, 8 * 64, nb=64, p=2, q=2, device=device)
    print("owner map:\n", G.owner_map())
    assert G.owner_map().shape == (8, 8)
    print("ex01 OK")


if __name__ == "__main__":
    common.run(main)
