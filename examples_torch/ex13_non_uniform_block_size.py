"""ex13: non-uniform tiles — rectangular mb x nb tiles, ragged edges, custom
rank maps (the port's form of examples/ex13_non_uniform_block_size.py)."""

import numpy as np

import common
import slate_tpu_torch as slate
from slate_tpu_torch.core import func
from slate_tpu_torch.core.matrix import Matrix, MatrixStorage
from slate_tpu_torch.parallel import redistribute_matrix


def main(device):
    # rectangular tiles + ragged last tiles
    a = np.arange(7 * 10, dtype=np.float32).reshape(7, 10)
    A = slate.Matrix.from_array(common.tensor(a, device), nb=4, mb=3)
    assert (A.mt, A.nt) == (3, 3)
    assert A.tileMb(2) == 1 and A.tileNb(2) == 2     # ragged edges
    np.testing.assert_array_equal(common.host(A.tile(2, 2)), a[6:, 8:])

    # custom distribution lambda (1D row-cyclic)
    st = MatrixStorage(common.tensor(a, device), 3, 4, p=2, q=1,
                       tile_rank=func.process_1d_grid("col", 2))
    M = Matrix(7, 10, 4, _storage=st)
    np.testing.assert_array_equal(M.owner_map()[:, 0], [0, 1, 0])   # i % 2 down rows

    # block-size helpers
    mb = func.uniform_blocksize(7, 3)
    assert [mb(i) for i in range(3)] == [3, 3, 1]

    # per-index tile grids: tileMb / tileNb as explicit size vectors
    b = np.arange(10 * 12, dtype=np.float32).reshape(10, 12)
    N = slate.Matrix.from_array(common.tensor(b, device), tile_mb=[2, 3, 1, 4],
                                tile_nb=[5, 4, 3])
    assert (N.mt, N.nt) == (4, 3)
    assert [N.tileMb(i) for i in range(4)] == [2, 3, 1, 4]
    np.testing.assert_array_equal(common.host(N.tile(1, 1)), b[2:5, 5:9])
    # views keep the non-uniform grid: sub over tiles, transpose flips it
    S = N.sub(1, 2, 0, 1)
    assert [S.tileMb(i) for i in range(S.mt)] == [3, 1]
    np.testing.assert_array_equal(common.host(N.T.tile(1, 1)), b[2:5, 5:9].T)
    # custom rank map over the non-uniform grid
    N2 = slate.Matrix.from_array(common.tensor(b, device), tile_mb=[2, 3, 1, 4],
                                 tile_nb=[5, 4, 3], p=2, q=2,
                                 tile_rank=lambda i, j: (i + j) % 4)
    assert N2.owner_map()[2, 1] == 3

    # redistribute round trip between two differently distributed wrappers
    dst = slate.Matrix.from_array(common.tensor(np.zeros_like(b), device),
                                  tile_mb=[2, 3, 1, 4], tile_nb=[5, 4, 3], p=2, q=2,
                                  tile_rank=lambda i, j: (i * 3 + j) % 4)
    redistribute_matrix(N2, dst)
    np.testing.assert_array_equal(common.host(dst), b)
    back = slate.Matrix.from_array(common.tensor(np.zeros_like(b), device),
                                   tile_mb=[2, 3, 1, 4], tile_nb=[5, 4, 3])
    redistribute_matrix(dst, back)
    np.testing.assert_array_equal(common.host(back), b)
    print("ex13 OK")


if __name__ == "__main__":
    common.run(main)
