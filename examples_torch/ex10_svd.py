"""ex10: singular value decomposition — values only and full factors, and the
two-stage pieces (the port's form of examples/ex10_svd.py)."""

import numpy as np

import common
import slate_tpu_torch as slate


def main(device):
    n, cond = 96, 1e3
    A0, S = slate.generate_matrix("svd_logrand", n, cond=cond, seed=9, device=device)
    a = common.host(A0)

    vals = np.sort(common.host(slate.svd_vals(A0)))[::-1]
    np.testing.assert_allclose(vals, np.sort(common.host(S))[::-1], rtol=1e-3)

    s, u, vt = slate.svd(A0)
    recon = (common.host(u) * common.host(s)[None, :]) @ common.host(vt)
    print("svd recon err:", np.linalg.norm(recon - a) / np.linalg.norm(a))
    assert np.linalg.norm(recon - a) / np.linalg.norm(a) < 1e-4

    # the explicit two-stage pipeline (ge2tb -> tb2bd -> bdsqr)
    d, e, U1, VT1 = slate.ge2tb(A0[:32, :24].clone())
    sv2 = common.host(slate.bdsqr(d, e)[0])
    np.testing.assert_allclose(np.sort(sv2)[::-1],
                               np.linalg.svd(a[:32, :24], compute_uv=False), rtol=1e-3)
    print("ex10 OK")


if __name__ == "__main__":
    common.run(main)
