"""ex09: least squares — gels QR/CholQR, over- and under-determined
(the port's form of examples/ex09_least_squares.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    r = np.random.default_rng(8)
    a = r.standard_normal((200, 40)).astype(np.float32)
    b = r.standard_normal((200, 2)).astype(np.float32)
    A, B = common.tensor(a, device), common.tensor(b, device)

    x = slate.gels(A.clone(), B.clone())
    expect, *_ = np.linalg.lstsq(a, b, rcond=None)
    np.testing.assert_allclose(common.host(x)[:40], expect, rtol=1e-2, atol=1e-3)

    x_qr = slate.gels_qr(A.clone(), B.clone())
    x_cq = slate.gels_cholqr(A.clone(), B.clone())
    np.testing.assert_allclose(common.host(x_qr)[:40], common.host(x_cq)[:40],
                               rtol=1e-2, atol=1e-3)

    # underdetermined: minimum-norm solution via LQ
    au = r.standard_normal((30, 80)).astype(np.float32)
    bu = r.standard_normal((30,)).astype(np.float32)
    xu = common.host(slate.gels(common.tensor(au, device), common.tensor(bu, device)))
    assert np.linalg.norm(au @ xu - bu) / np.linalg.norm(bu) < 1e-3
    print("ex09 OK")


if __name__ == "__main__":
    common.run(main)
