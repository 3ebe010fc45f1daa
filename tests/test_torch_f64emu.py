"""The emulated-f64 gemm and refinement solves of the port
(slate_tpu_torch.ops.f64emu) against the JAX package's, on the CPU.

On the CPU the slices multiply as float32 (integers below 2^8, chunk sums
below 2^24: exact in any order), so ``gemm_f64emu`` and ``split_fixed_slices``
agree with the JAX package bit for bit.  The solves agree in ``info``, in
their iteration counts within one round (the float32 factors come from two
libraries), and in their solutions to 1e-12 relative.  The tests of
tests/test_blas.py:239-335 follow, on the port (the sharded case waits for
the distributed tier)."""

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu.ops import f64emu as jf
from slate_tpu_torch.ops import f64emu as tf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on the
    machine's cores, and torch's thread pool spinning beside them made these
    tests 10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("shape", [(48, 300, 32), (7, 513, 5)])
def test_gemm_f64emu_bit_for_bit(shape):
    m, k, n = shape
    r = np.random.default_rng(k)
    a, b, c = r.standard_normal((m, k)), r.standard_normal((k, n)), r.standard_normal((m, n))
    a[0] *= 1e-30                     # rows far apart in exponent
    want = np.asarray(jf.gemm_f64emu(a, b, alpha=2.0, beta=-0.5, C=c))
    got = tf.gemm_f64emu(t(a), t(b), alpha=2.0, beta=-0.5, C=t(c)).numpy()
    np.testing.assert_array_equal(got, want)
    hi_w, lo_w = jf.gemm_f64emu(a, b, return_hilo=True)
    hi_g, lo_g = tf.gemm_f64emu(t(a), t(b), return_hilo=True)
    np.testing.assert_array_equal(hi_g.numpy(), np.asarray(hi_w))
    np.testing.assert_array_equal(lo_g.numpy(), np.asarray(lo_w))


def test_gemm_f64emu_complex_and_mixed_bit_for_bit(rng):
    za = rng.standard_normal((24, 40)) + 1j * rng.standard_normal((24, 40))
    zb = rng.standard_normal((40, 16)) + 1j * rng.standard_normal((40, 16))
    np.testing.assert_array_equal(tf.gemm_f64emu(t(za), t(zb)).numpy(),
                                  np.asarray(jf.gemm_f64emu(za, zb)))
    a, b = rng.standard_normal((12, 30)), rng.standard_normal((30, 9))
    zc = rng.standard_normal((12, 9)) + 1j * rng.standard_normal((12, 9))
    np.testing.assert_array_equal(
        tf.gemm_f64emu(t(a), t(b), beta=0.5, C=t(zc)).numpy(),
        np.asarray(jf.gemm_f64emu(a, b, beta=0.5, C=zc)))
    a32 = a.astype(np.float32)
    np.testing.assert_array_equal(tf.gemm_f64emu(t(a32), t(b)).numpy(),
                                  np.asarray(jf.gemm_f64emu(a32, b)))


def test_slice_products_ignore_a_callers_tf32_setting(monkeypatch):
    """A caller's reduced float32 matmul precision is turned off around the
    slice products (they are exact only in IEEE float32) and restored after;
    the result stays bit for bit the JAX package's."""
    r = np.random.default_rng(5)
    a, b = r.standard_normal((16, 300)), r.standard_normal((300, 8))
    seen, bmm = [], torch.bmm
    monkeypatch.setattr(tf.torch, "bmm", lambda *x, **kw: (
        seen.append(torch.get_float32_matmul_precision()), bmm(*x, **kw))[1])
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = tf.gemm_f64emu(t(a), t(b)).numpy()
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prec)
    assert seen and set(seen) == {"highest"}
    np.testing.assert_array_equal(got, np.asarray(jf.gemm_f64emu(a, b)))


def test_split_fixed_slices_and_exact_pow2_match_jax(rng):
    x = rng.standard_normal((9, 20)) * np.logspace(-200, 200, 9)[:, None]
    x[3] = 0.0
    ws, we = jf.split_fixed_slices(x, 7)
    gs, ge = tf.split_fixed_slices(t(x), 7)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    for w, g in zip(ws, gs):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    e = np.array([-1100.0, -126.0, -3.0, 0.0, 5.0, 127.0, 2000.0])
    for dt, tdt in ((np.float64, torch.float64), (np.float32, torch.float32)):
        np.testing.assert_array_equal(tf._exact_pow2(t(e), tdt).numpy(),
                                      np.asarray(jf._exact_pow2(e, dt)))


def test_f64ir_solves_match_jax(rng):
    n = 60
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (U * np.logspace(0, -3, n)) @ V.T
    B = A @ rng.standard_normal((n, 2))
    g = rng.standard_normal((n, n))
    S = g @ g.T + n * np.eye(n)
    for jfn, tfn, a in ((jf.gesv_f64ir, tf.gesv_f64ir, A), (jf.posv_f64ir, tf.posv_f64ir, S)):
        b = a @ rng.standard_normal((n, 2))
        wh, wl, wit, winfo = jfn(a, b)
        gh, gl, git, ginfo = tfn(t(a), t(b))
        # the f32 factors come from two libraries, so the refinement may
        # stop one round apart
        assert abs(int(git) - int(wit)) <= 1 and int(ginfo) == int(winfo)
        want = np.asarray(wh, np.float64) + np.asarray(wl, np.float64)
        got = gh.double().numpy() + gl.double().numpy()
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    # a vector right-hand side keeps its shape
    xh, xl, _, _ = tf.gesv_f64ir(t(A), t(B[:, 0]))
    assert xh.shape == (n,) and xl.shape == (n,)


def test_top_level_names():
    assert st.gemm_f64emu is tf.gemm_f64emu
    assert st.gesv_f64ir is tf.gesv_f64ir and st.posv_f64ir is tf.posv_f64ir


# ---------------------------------------------------------------------------
# tests/test_blas.py:239-335, on the port

def test_gemm_f64_emulation(rng):
    """Options(f64_emulation=True): double-precision-class gemm through the
    exact splitting, agreeing with the JAX package's blas.gemm."""
    m, k, n = 48, 100, 32
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    c = rng.standard_normal((m, n))
    ref = 2.0 * (a @ b) - 0.5 * c
    out = st.gemm(2.0, t(a), t(b), -0.5, t(c.copy()), opts={"f64_emulation": True})
    err = np.max(np.abs(out.numpy() - ref)) / np.max(np.abs(ref))
    assert err < 1e-12, err
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(sj.gemm(2.0, a, b, -0.5, c.copy(),
                                        opts={"f64_emulation": True})))
    # ill-scaled rows/cols stay accurate (per-row exponent normalization)
    a2 = a * np.logspace(-6, 6, m)[:, None]
    ref2 = a2 @ b
    C = st.Matrix.from_array(t(np.zeros((m, n))))
    out2 = st.gemm(1.0, t(a2), t(b), 0.0, C, opts={"f64_emulation": True})
    assert np.max(np.abs(out2.numpy() - ref2)) / np.max(np.abs(ref2)) < 1e-12
    np.testing.assert_array_equal(C.array.numpy(), out2.numpy())   # written back


def test_gemm_f64_emulation_residual_and_complex(rng):
    A = rng.standard_normal((64, 64))
    x = rng.standard_normal((64, 4))
    b = A @ x
    r = tf.gemm_f64emu(t(A), t(x), alpha=1.0, beta=-1.0, C=t(b)).numpy()
    assert np.max(np.abs(r)) / np.max(np.abs(b)) < 1e-12
    za = rng.standard_normal((24, 40)) + 1j * rng.standard_normal((24, 40))
    zb = rng.standard_normal((40, 16)) + 1j * rng.standard_normal((40, 16))
    ref = za @ zb
    got = tf.gemm_f64emu(t(za), t(zb)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-12


def test_gesv_f64ir_double_class_solve(rng):
    n = 120
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (U * np.logspace(0, -3, n)) @ V.T       # cond ~ 1e3
    Xtrue = rng.standard_normal((n, 2))
    B = A @ Xtrue
    Xh, Xl, iters, info = tf.gesv_f64ir(t(A), t(B))
    X = Xh.double().numpy() + Xl.double().numpy()
    err = np.linalg.norm(X - Xtrue) / np.linalg.norm(Xtrue)
    assert err < 1e-10, err
    assert 1 <= iters <= 10 and info == 0
    f32err = np.linalg.norm(
        np.linalg.solve(A.astype(np.float32), B.astype(np.float32))
        .astype(np.float64) - Xtrue) / np.linalg.norm(Xtrue)
    assert err < 1e-3 * f32err          # orders beyond the native solve


def test_posv_f64ir_double_class_solve(rng):
    n = 100
    g = rng.standard_normal((n, n))
    A = g @ g.T + n * np.eye(n)
    Xt = rng.standard_normal((n, 2))
    B = A @ Xt
    Xh, Xl, iters, info = tf.posv_f64ir(t(A), t(B))
    X = Xh.double().numpy() + Xl.double().numpy()
    assert np.linalg.norm(X - Xt) / np.linalg.norm(Xt) < 1e-11
    assert 1 <= iters <= 10 and info == 0
    # non-SPD input signals info = 1 without burning refinement rounds
    Abad = A.copy()
    Abad[0, 0] = -Abad[0, 0]
    _, _, it_bad, info_bad = tf.posv_f64ir(t(Abad), t(B))
    assert info_bad == 1 and it_bad == 0
    # complex HPD refines through the four-real-products gemm path
    gz = rng.standard_normal((40, 40)) + 1j * rng.standard_normal((40, 40))
    Az = gz @ gz.conj().T + 40 * np.eye(40)
    Xz = rng.standard_normal((40, 2)) + 1j * rng.standard_normal((40, 2))
    Bz = Az @ Xz
    Zh, Zl, _, iz = tf.posv_f64ir(t(Az), t(Bz))
    Z = Zh.to(torch.complex128).numpy() + Zl.to(torch.complex128).numpy()
    assert iz == 0
    assert np.linalg.norm(Z - Xz) / np.linalg.norm(Xz) < 1e-10
