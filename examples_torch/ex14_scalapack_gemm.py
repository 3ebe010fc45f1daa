"""ex14: ScaLAPACK-compatibility gemm over a process grid (the port's form of
examples/ex14_scalapack_gemm.py).  On the CPU four gloo ranks form a 2x2
grid; on one card the call falls through to the single-device path."""

import numpy as np

import common


def job(device):
    """Every rank: the same psgemm on a 2x2 grid when the world has four
    ranks, else on one device."""
    import torch.distributed as dist

    from slate_tpu_torch import scalapack_api as slapi

    r = np.random.default_rng(13)
    a = r.standard_normal((64, 48)).astype(np.float32)
    b = r.standard_normal((48, 32)).astype(np.float32)
    c = np.zeros((64, 32), np.float32)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world >= 4:
        slapi.gridinit(2, 2, device=device)          # ≅ Cblacs_gridinit
        where, kw = f"grid 2x2 over {world} ranks", {}
    else:
        where, kw = f"single device ({world} rank); pgemm takes the local path", \
            {"device": device}
    before = dict(slapi.ROUTES)
    out = slapi.psgemm("n", "n", 1.0, a, b, 0.0, c, **kw)
    slapi.gridexit()
    route = [k for k in before if slapi.ROUTES[k] > before[k]]
    np.testing.assert_allclose(out, a @ b, rtol=1e-4, atol=1e-4)
    return where, route


def main(device):
    if device.type == "cpu":
        where, route = common.on_ranks(job, device, 4)
        assert route == ["distributed"], route
    else:
        where, route = job(str(device))
        assert route == ["lapack"], route
    print(where)
    print("ex14 OK")


if __name__ == "__main__":
    common.run(main)
