"""ex17: double-precision-class solves from float32 work (the
exact-splitting emulated-f64 gemm and iterative refinement,
``ops/f64emu.py``) and the distributed random-butterfly solver
(``parallel/rbt.py``) on a 2x4 grid (the port's form of
examples/ex17_f64_emulation_and_rbt.py).  On the CPU the grid is eight gloo
ranks; on one card it is 1x1."""

import numpy as np

import common


def inputs():
    rng = np.random.default_rng(17)
    n = 160
    A = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    # b in f64 from the cast values, so the f32 storage rounding of A and x
    # does not hide the emulation
    b = A.astype(np.float64) @ x.astype(np.float64)
    return A, x, b


def rbt_job(device):
    import torch

    from slate_tpu_torch.parallel import gesv_rbt_distributed
    from slate_tpu_torch.parallel.launch import to_host

    grid = common.grid(2, 4, device)
    if grid is None:
        return None
    A, x, b = inputs()
    Xr, info, it, via_rbt = gesv_rbt_distributed(torch.as_tensor(A).to(device),
                                                 torch.as_tensor(b.astype(np.float32)).to(device),
                                                 grid, depth=2, nb=32)
    err = np.linalg.norm(to_host(Xr) - x) / np.linalg.norm(x)
    return {"grid": f"{grid.p}x{grid.q}", "err": float(err), "info": int(info),
            "iters": int(it), "via_rbt": bool(via_rbt)}


def main(device):
    from slate_tpu_torch.ops.f64emu import gemm_f64emu, gesv_f64ir

    A, x, b = inputs()
    At, xt = common.tensor(A, device), common.tensor(x, device)
    # r = A x - b in double-f32: b crosses as its f32 part, its f64 tail folds in
    rh, rl = gemm_f64emu(At, xt, alpha=1.0, beta=-1.0,
                         C=common.tensor(b.astype(np.float32), device), return_hilo=True)
    tail = b - b.astype(np.float32).astype(np.float64)
    r = (common.host(rh).astype(np.float64) + common.host(rl).astype(np.float64)) - tail
    print(f"f64emu residual |A x - b|_max = {np.abs(r).max():.3e} "
          "(plain f32 leaves ~1e-4 here)")
    assert np.abs(r).max() < 1e-9

    # double-class solve: f32 LU factor + emulated-f64 refinement
    Xh, Xl, iters, info = gesv_f64ir(At, common.tensor(b.astype(np.float32), device))
    X = common.host(Xh).astype(np.float64) + common.host(Xl).astype(np.float64)
    res = np.linalg.norm(A.astype(np.float64) @ X - b.astype(np.float32)) / np.linalg.norm(b)
    print(f"gesv_f64ir: rel residual {res:.3e} after {int(iters)} rounds (info={int(info)})")
    assert int(info) == 0 and res < 1e-10

    out = common.on_ranks(rbt_job, device, 8)
    print(f"gesv_rbt_distributed ({out['grid']} grid): rel err {out['err']:.3e} "
          f"(info={out['info']}, iters={out['iters']}, "
          f"via {'rbt' if out['via_rbt'] else 'partialpiv fallback'})")
    assert out["info"] == 0 and out["err"] < 1e-4
    print("ex17 OK")


if __name__ == "__main__":
    common.run(main)
