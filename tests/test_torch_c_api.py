"""The port's C API (``slate_tpu_torch.c_api`` + ``csrc/slate_c_api.cpp``):
mirrors ``tests/test_c_api.py`` against the port's own library, then holds
the Python bodies behind the entry points against the JAX package.

Compiled programs (``tests/c_api_check.c``, ``examples/c/*.c``, read in
place) and every load of the library run in subprocesses with timeouts, on
the CPU through ``SLATE_TPU_TORCH_DEVICE=cpu``; nothing here builds or loads
anything under ``native/``.  The parity tests call the bodies directly on
memoryviews over numpy buffers (no C), beside the JAX package's
``scalapack_api`` / ``lapack_api`` calls the JAX library's bodies make, on the
same seeded inputs."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slate_tpu_torch import c_api
from slate_tpu_torch.parallel.mesh import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK = os.path.join(ROOT, "tests", "c_api_check.c")
NO_CUDA = "CUDA is not available"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib_path():
    return c_api.build()


@pytest.fixture(scope="module")
def compile_c(lib_path, tmp_path_factory):
    """``compile_c(source)``: the source compiled and linked against the
    port's library, as a C user links it (``-I include -L<dir> -l<name>``
    with an rpath)."""
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    out = tmp_path_factory.mktemp("c_api")
    lib_dir = os.path.dirname(lib_path)
    name = os.path.basename(lib_path)[3:-3]

    def compile_c(src):
        exe = str(out / os.path.splitext(os.path.basename(src))[0])
        cc = subprocess.run(["gcc", src, "-I", os.path.join(ROOT, "include"), "-L", lib_dir,
                             f"-l{name}", f"-Wl,-rpath,{lib_dir}", "-lm", "-o", exe],
                            capture_output=True, text=True, timeout=120)
        assert cc.returncode == 0, cc.stderr[-2000:]
        return exe
    return compile_c


def run_c(exe, device="cpu", timeout=300, **extra):
    env = c_api.child_env(device)
    if device is None:
        env.pop(c_api.DEVICE_ENV, None)
    env.update(OMP_NUM_THREADS="1", **extra)
    return subprocess.run([exe], capture_output=True, text=True, timeout=timeout, env=env)


def check_lines(stdout):
    """{name: verdict} of c_api_check's result lines."""
    out = {}
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[0] != "C_API":
            out[parts[0]] = parts[-1] if parts[1] != "skipped" else "skipped"
    return out


# ---------------------------------------------------------------------------
# the library and the compiled programs


def test_library_exports_every_header_symbol(lib_path):
    """All 59 declarations of include/slate_tpu.h, by the port's own reading
    of the header and by the Fortran generator's, are exported."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gen_fortran", os.path.join(ROOT, "tools", "fortran", "gen_fortran.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    names = set(c_api.signatures())
    assert len(names) == 59
    assert {d[1] for d in gen.parse(gen.HEADER)} == names
    nm = subprocess.run(["nm", "-D", "--defined-only", lib_path], capture_output=True,
                        text=True, timeout=60, check=True).stdout
    exported = {line.split()[-1] for line in nm.splitlines() if " T " in line}
    assert names <= exported, sorted(names - exported)
    assert os.path.dirname(lib_path) == os.path.join(ROOT, "slate_tpu_torch", "_build")


def test_build_failure_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(c_api.SlateError, match="build failed"):
        c_api.build(str(bad), str(tmp_path / "out"))
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "out"))


def test_c_api_check_one_process(compile_c):
    run = run_c(compile_c(CHECK))
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-2000:]
    assert "C_API PASS" in run.stdout
    lines = check_lines(run.stdout)
    assert len(lines) == 28
    assert lines.pop("grid-posv") == "skipped"      # no process group of 8 ranks
    assert set(lines.values()) == {"ok"}, lines
    assert "needs 8 ranks" in run.stderr


def test_c_api_check_on_eight_gloo_ranks(compile_c):
    """The same program started as 8 ranks of one gloo world: slate_gridinit
    joins the launcher's group, and grid-posv runs on the 2x4 grid."""
    exe = compile_c(CHECK)
    port = str(free_port())
    env = c_api.child_env("cpu")
    procs = [subprocess.Popen([exe], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="8",
                                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                                       OMP_NUM_THREADS="1"))
             for r in range(8)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-2000:]}{err[-2000:]}"
        assert "C_API PASS" in out
        lines = check_lines(out)
        assert lines["grid-posv"] == "ok" and set(lines.values()) == {"ok"}, (rank, lines)


@pytest.mark.parametrize("src,marker", [("ex05_blas.c", "ex05 OK"),
                                        ("example_gesv.c", "PASS")])
def test_c_examples(compile_c, src, marker):
    run = run_c(compile_c(os.path.join(ROOT, "examples", "c", src)))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert marker in run.stdout.splitlines()


def test_no_device_asked_fails_without_cuda(compile_c):
    """Without SLATE_TPU_TORCH_DEVICE the C calls run on cuda; with no CUDA
    every call fails loudly, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default")
    run = run_c(compile_c(os.path.join(ROOT, "examples", "c", "ex05_blas.c")), device=None)
    assert run.returncode != 0
    assert NO_CUDA in run.stderr and "slate_init failed" in run.stderr
    assert "ex05 OK" not in run.stdout


CTYPES_CHILD = r"""
import json, sys
import numpy as np
from slate_tpu_torch import c_api
lib = c_api.library()
n = 24
rng = np.random.default_rng(3)
a = rng.standard_normal((n, n)) + n * np.eye(n)
a_col = np.asfortranarray(a)
b = np.asfortranarray(rng.standard_normal((n, 2)))
b0 = b.copy(order="F")
ipiv = np.zeros(n, np.int64)
out = {"version": lib.slate_version().decode(), "init": lib.slate_init()}
out["gesv_info"] = lib.slate_dgesv(n, 2, a_col.ctypes.data, n, ipiv.ctypes.data,
                                   b.ctypes.data, n)
out["gesv_resid"] = float(np.abs(a @ b - b0).max())
src = np.asfortranarray(a)
out["lange"] = {c: lib.slate_dlange(c.encode(), n, n, src.ctypes.data, n)
                for c in "1ifm"}
out["lange_ref"] = {"1": float(np.abs(a).sum(0).max()), "i": float(np.abs(a).sum(1).max()),
                    "f": float(np.linalg.norm(a)), "m": float(np.abs(a).max())}
h = lib.slate_matrix_create_d(n, n, src.ctypes.data, n)
back = np.zeros((n, n), order="F")
out["read"] = [h, lib.slate_matrix_read_d(h, back.ctypes.data, n),
               bool((back == a).all()), lib.slate_matrix_read_d(h, back.ctypes.data, n - 1)]
lib.slate_matrix_destroy(h)
out["gridinit"] = lib.slate_gridinit(2, 2)
lib.slate_finalize()
out["modules"] = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.") or m == "slate_tpu"
                        or m.startswith("slate_tpu."))
print(json.dumps(out))
"""


def test_ctypes_in_a_child_python(lib_path):
    """The in-process route: a Python that loads the library calls a few
    entry points; neither jax nor the JAX package is imported."""
    env = c_api.child_env("cpu")
    env["OMP_NUM_THREADS"] = "1"
    run = subprocess.run([sys.executable, "-c", CTYPES_CHILD], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["version"] == "slate_tpu_torch-c-api 2.0" and out["init"] == 0
    assert out["gesv_info"] == 0 and out["gesv_resid"] < 1e-12
    for c, ref in out["lange_ref"].items():
        assert abs(out["lange"][c] - ref) <= 1e-13 * ref, c
    assert out["read"][0] > 0 and out["read"][1:] == [0, True, -7]
    assert out["gridinit"] == 1 and "needs 4 ranks" in run.stderr
    assert out["modules"] == []


def test_load_refuses_a_static_python(monkeypatch):
    import sysconfig

    real = sysconfig.get_config_var
    monkeypatch.setattr(sysconfig, "get_config_var",
                        lambda k: 0 if k == "Py_ENABLE_SHARED" else real(k))
    with pytest.raises(c_api.SlateError, match="enable-shared"):
        c_api.load("/nonexistent.so")


# ---------------------------------------------------------------------------
# the bodies against the JAX package, in process (tolerances: f64 1e-10 on
# the residual scale of these well-conditioned n <= 40 inputs, the eig/SVD
# values 1e-10 relative; pivots and info exact)

TOL = 1e-10


@pytest.fixture(scope="module")
def cpu_runtime():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(c_api.DEVICE_ENV, "cpu")
        c_api.finalize()
        c_api.init()
        yield c_api.runtime()
        c_api.finalize()


@pytest.fixture(scope="module")
def jx():
    from slate_tpu import lapack_api as lapi
    from slate_tpu import scalapack_api as sapi
    from slate_tpu.linalg import lu as jlu

    return SimpleNamespace(lapi=lapi, sapi=sapi, lu=jlu)


class ColMajor:
    """A column-major buffer of leading dimension ``ld`` holding ``a``, and
    the memoryview the C side would pass."""

    def __init__(self, a, ld=None):
        a = np.asarray(a)
        self.rows, self.cols = a.shape
        self.ld = ld or max(self.rows, 1)
        self.flat = np.zeros(self.ld * self.cols, a.dtype)
        self.view()[...] = a
        self.mv = memoryview(self.flat)

    def view(self):
        return self.flat.reshape(self.cols, self.ld).T[:self.rows]


def vec(n, dtype):
    buf = np.zeros(n, dtype)
    return buf, memoryview(buf)


def rnd(shape, seed, dtype=np.float64):
    r = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(dtype)
    return r.standard_normal(shape).astype(dtype)


N, NRHS = 24, 3


@pytest.mark.parametrize("t", ["d", "z"])
def test_gesv_matches_jax(cpu_runtime, jx, t):
    dt = {"d": np.float64, "z": np.complex128}[t]
    a, b = rnd((N, N), 1, dt), rnd((N, NRHS), 2, dt)
    A, B = ColMajor(a, ld=N + 5), ColMajor(b, ld=N + 2)
    ipiv, ipiv_mv = vec(N, np.int64)
    info = getattr(c_api, f"{t}gesv")(N, NRHS, A.mv, A.ld, ipiv_mv, B.mv, B.ld)
    lu, piv, jinfo = getattr(jx.sapi, f"p{t}getrf")(a.copy())
    x = getattr(jx.sapi, f"p{t}getrs")("n", lu, piv, b.copy())
    assert info == int(jinfo) == 0
    np.testing.assert_array_equal(ipiv, np.asarray(piv, np.int64))
    np.testing.assert_allclose(A.view(), np.asarray(lu), atol=TOL)
    np.testing.assert_allclose(B.view(), np.asarray(x), atol=TOL)
    assert A.flat.reshape(N, A.ld)[:, N:].sum() == 0     # past lda untouched


def test_tall_getrf_and_transposed_getrs_match_jax(cpu_runtime, jx):
    """m > n: the JAX body's row fix-up (its pivots_to_perm) against the
    port's; then getrs 't' from the port's factors of a square matrix."""
    m, n = 40, 24
    a = rnd((m, n), 3)
    A = ColMajor(a)
    ipiv, ipiv_mv = vec(n, np.int64)
    assert c_api.dgetrf(m, n, A.mv, m, ipiv_mv) == 0
    lu, piv, info = jx.sapi.pdgetrf(a.copy())
    piv, lu = np.asarray(piv, np.int64), np.asarray(lu)
    invp = np.argsort(np.asarray(jx.lu.pivots_to_perm(piv)))
    perm2 = np.asarray(jx.lu.pivots_to_perm(np.concatenate([piv[:n], np.arange(n + 1, m + 1)])))
    np.testing.assert_array_equal(ipiv, piv[:n])
    np.testing.assert_allclose(A.view(), lu[invp[perm2]], atol=TOL)

    sq, b = rnd((n, n), 4) + n * np.eye(n), rnd((n, NRHS), 5)
    S = ColMajor(sq)
    sp, sp_mv = vec(n, np.int64)
    assert c_api.dgetrf(n, n, S.mv, n, sp_mv) == 0
    B = ColMajor(b)
    assert c_api.dgetrs("t", n, NRHS, S.mv, n, memoryview(sp), B.mv, n) == 0
    want = jx.sapi.pdgetrs("t", S.view().copy(), sp.copy(), b.copy())
    np.testing.assert_allclose(B.view(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(sq.T @ B.view(), b, atol=TOL)


@pytest.mark.parametrize("t,uplo", [("d", "l"), ("z", "u")])
def test_posv_matches_jax(cpu_runtime, jx, t, uplo):
    """The factor into A's stored triangle, the other triangle kept, and X
    into B, against the JAX package's p?potrf / p?potrs."""
    dt = {"d": np.float64, "z": np.complex128}[t]
    g = rnd((N, N), 22, dt)
    a, b = g @ g.conj().T + N * np.eye(N), rnd((N, NRHS), 23, dt)
    A, B = ColMajor(a, ld=N + 3), ColMajor(b, ld=N + 1)
    assert getattr(c_api, f"{t}posv")(uplo, N, NRHS, A.mv, A.ld, B.mv, B.ld) == 0
    lf, info = getattr(jx.sapi, f"p{t}potrf")(uplo, a.copy())
    x = getattr(jx.sapi, f"p{t}potrs")(uplo, np.asarray(lf), b.copy())
    assert int(info) == 0
    if uplo == "l":
        tri, other = np.tril, (lambda m: np.triu(m, 1))
    else:
        tri, other = np.triu, (lambda m: np.tril(m, -1))
    np.testing.assert_allclose(tri(A.view()), tri(np.asarray(lf)), atol=TOL)
    np.testing.assert_array_equal(other(A.view()), other(a))
    np.testing.assert_allclose(B.view(), np.asarray(x), atol=TOL)


@pytest.fixture
def one_by_one_grid(cpu_runtime):
    """A 1x1 grid on a world of one in this process; both end with the test."""
    import torch.distributed as dist
    from slate_tpu_torch import scalapack_api
    from slate_tpu_torch.parallel import mesh as pmesh

    started = not dist.is_initialized()
    scalapack_api.gridinit(1, 1, device="cpu")
    yield
    scalapack_api.gridexit()
    if started:
        pmesh.destroy()


def test_bodies_on_a_grid_match_the_device_bodies(one_by_one_grid):
    """On a grid, ?gemm, ?gesv and ?posv run the p* skins (results cross
    row-major, factors to the host between the factor and the solve); their
    results are the no-grid bodies' (those are held against the JAX package
    above)."""
    from slate_tpu_torch import scalapack_api

    g = rnd((N, N), 24)
    a, b = g @ g.T + N * np.eye(N), rnd((N, NRHS), 25)
    za, zb = rnd((9, 12), 26, np.complex128), rnd((7, 9), 28, np.complex128)
    zc = rnd((12, 7), 27, np.complex128)
    alpha = memoryview(np.array([0.5 + 2j]))
    beta = memoryview(np.array([-1 + 0.5j]))
    got = {}
    for grid in (True, False):
        if not grid:
            scalapack_api.gridexit()
        A, B, P, Q = ColMajor(a, ld=N + 2), ColMajor(b), ColMajor(g), ColMajor(b)
        ZA, ZB, ZC = ColMajor(za, ld=11), ColMajor(zb), ColMajor(zc)
        ipiv, ipiv_mv = vec(N, np.int64)
        assert c_api.dposv("u", N, NRHS, A.mv, A.ld, B.mv, N) == 0
        assert c_api.dgesv(N, NRHS, P.mv, N, ipiv_mv, Q.mv, N) == 0
        assert c_api.zgemm("c", "t", 12, 7, 9, alpha, ZA.mv, 11, ZB.mv, 7, beta,
                           ZC.mv, 12) == 0
        got[grid] = (A.view().copy(), B.view().copy(), P.view().copy(), ipiv,
                     Q.view().copy(), ZC.view().copy())
    for on_grid, off_grid in zip(got[True], got[False]):
        np.testing.assert_allclose(on_grid, off_grid, atol=TOL)
    np.testing.assert_array_equal(got[True][3], got[False][3])
    want = (0.5 + 2j) * za.conj().T @ zb.T + (-1 + 0.5j) * zc
    np.testing.assert_allclose(got[False][5], want, atol=TOL)


def test_posv_not_spd_gives_jax_info(cpu_runtime, jx):
    a = rnd((N, N), 6)
    a = a + a.T
    a[7, 7] = -50.0
    A, B = ColMajor(a), ColMajor(rnd((N, 2), 7))
    b0 = B.view().copy()
    info = c_api.dposv("l", N, 2, A.mv, N, B.mv, N)
    _, jinfo = jx.sapi.pdpotrf("l", a.copy())
    assert info == int(jinfo) > 0
    np.testing.assert_array_equal(B.view(), b0)          # no solve after a failed factor


def test_subset_eig_and_svd_values_match_jax(cpu_runtime, jx):
    m = rnd((N, N), 8)
    sym = (m + m.T) / 2
    il, iu = 3, 9
    k = iu - il + 1
    A = ColMajor(sym)
    w, w_mv = vec(k, np.float64)
    Z = ColMajor(np.zeros((N, k)))
    assert c_api.dsyevx("v", "l", N, A.mv, N, il, iu, w_mv, Z.mv, N) == 0
    lam, _ = jx.lapi.dsyevx("v", "l", sym.copy(), il, iu)
    np.testing.assert_allclose(w, np.asarray(lam), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(sym @ Z.view(), Z.view() * w, atol=1e-9)

    g = rnd((32, N), 9)
    G = ColMajor(g)
    s, s_mv = vec(4, np.float64)
    assert c_api.dgesvdx("n", "n", 32, N, G.mv, 32, 1, 4, s_mv, None, 32, None, 4) == 0
    sj, _, _ = jx.lapi.dgesvdx("n", "n", g.copy(), 1, 4)
    np.testing.assert_allclose(s, np.asarray(sj), rtol=TOL)


def test_sygv_values_and_factor_match_jax(cpu_runtime, jx):
    g = rnd((N, N), 10)
    a = (g + g.T) / 2
    bm = g @ g.T + N * np.eye(N)
    A, B = ColMajor(a), ColMajor(bm)
    w, w_mv = vec(N, np.float64)
    assert c_api.dsygv(1, "v", "l", N, A.mv, N, B.mv, N, w_mv) == 0
    lf, _ = jx.sapi.pdpotrf("l", bm.copy())
    lam, _ = jx.sapi.pdsygv(1, "v", "l", a.copy(), bm.copy())
    np.testing.assert_allclose(w, np.asarray(lam), rtol=TOL, atol=TOL)
    low = np.tril(np.ones((N, N), bool))
    np.testing.assert_allclose(B.view()[low], np.asarray(lf)[low], atol=TOL)
    np.testing.assert_array_equal(B.view()[~low], bm[~low])  # the other triangle kept
    # a non-SPD B: info n + i, as LAPACK and the JAX body give
    bad = bm.copy()
    bad[4, 4] = -1.0
    B2 = ColMajor(bad)
    _, finfo = jx.sapi.pdpotrf("l", bad.copy())
    assert c_api.dsygv(1, "v", "l", N, ColMajor(a).mv, N, B2.mv, N, w_mv) == N + int(finfo)


def _band_cases(n, kd, kl, ku):
    """(dense SPD band, its LAPACK lower storage, dense general band, its
    dgbsv storage)."""
    r = np.random.default_rng(11)
    spd = np.diag(np.full(n, 4.0 * (kd + 1)))
    for d in range(1, kd + 1):
        v = r.standard_normal(n - d)
        spd += np.diag(v, d) + np.diag(v, -d)
    ab = np.zeros((kd + 1, n))
    for d in range(kd + 1):
        ab[d, :n - d] = np.diagonal(spd, -d)
    gb = np.diag(4.0 + r.standard_normal(n))
    for d in list(range(-kl, 0)) + list(range(1, ku + 1)):
        gb += np.diag(r.standard_normal(n - abs(d)), d)
    gab = np.zeros((2 * kl + ku + 1, n))
    for j in range(n):
        for i in range(max(0, j - ku), min(n, j + kl + 1)):
            gab[kl + ku + i - j, j] = gb[i, j]
    return spd, ab, gb, gab


def test_band_and_indefinite_solves_match_jax(cpu_runtime, jx):
    kd, kl, ku = 3, 2, 1
    spd, ab, gb, gab = _band_cases(N, kd, kl, ku)
    b = rnd((N, 2), 12)
    AB, B = ColMajor(ab), ColMajor(b)
    assert c_api.dpbsv("l", N, kd, 2, AB.mv, kd + 1, B.mv, N) == 0
    lf, _ = jx.sapi.pdpbtrf("l", kd, spd.copy())
    x = jx.sapi.pdpbtrs("l", kd, np.asarray(lf), b.copy())
    np.testing.assert_allclose(B.view(), np.asarray(x), atol=TOL)
    for d in range(kd + 1):                  # the factor band written back
        np.testing.assert_allclose(AB.view()[d, :N - d], np.diagonal(np.asarray(lf), -d),
                                   atol=TOL)

    GB, B = ColMajor(gab), ColMajor(b)
    assert c_api.dgbsv(N, kl, ku, 2, GB.mv, 2 * kl + ku + 1, B.mv, N) == 0
    xg, ginfo = jx.sapi.pdgbsv(kl, ku, gb.copy(), b.copy())
    assert int(ginfo) == 0
    np.testing.assert_allclose(B.view(), np.asarray(xg), atol=TOL)
    np.testing.assert_array_equal(GB.view(), gab)            # AB is not written

    m = rnd((N, N), 13)
    sym = (m + m.T) / 2
    A, B = ColMajor(sym), ColMajor(b)
    assert c_api.dsysv("l", N, 2, A.mv, N, B.mv, N) == 0
    xs, sinfo = jx.sapi.pdsysv("l", sym.copy(), b.copy())
    assert int(sinfo) == 0
    np.testing.assert_allclose(B.view(), np.asarray(xs), atol=1e-9)


def test_handles_match_jax(cpu_runtime, jx):
    """create -> gesv -> read, syev with vectors, gesvd into new handles,
    destroy; each against the JAX package's p* calls on the same data."""
    a = rnd((N, N), 14) + N * np.eye(N)
    b = rnd((N, NRHS), 15)
    ha = c_api.matrix_create_d(N, N, ColMajor(a, ld=N + 1).mv, N + 1)
    hb = c_api.matrix_create_d(N, NRHS, ColMajor(b).mv, N)
    assert ha > 0 and hb > ha
    assert c_api.matrix_shape(hb) == (N, NRHS)
    assert c_api.matrix_gesv(ha, hb) == 0
    lu, piv, _ = jx.sapi.pdgetrf(a.copy())
    x = np.asarray(jx.sapi.pdgetrs("n", lu, piv, b.copy()))
    out = ColMajor(np.zeros((N, NRHS)))
    assert c_api.matrix_read_d(hb, out.mv, N) == 0
    np.testing.assert_allclose(out.view(), x, atol=TOL)

    m = rnd((N, N), 16)
    sym = (m + m.T) / 2
    hs = c_api.matrix_create_d(N, N, ColMajor(sym).mv, N)
    w, w_mv = vec(N, np.float64)
    assert c_api.matrix_syev(hs, "v", "l", w_mv) == 0
    lam, _ = jx.sapi.pdsyev("v", "l", sym.copy())
    np.testing.assert_allclose(w, np.asarray(lam), rtol=TOL, atol=TOL)
    z = ColMajor(np.zeros((N, N)))
    assert c_api.matrix_read_d(hs, z.mv, N) == 0
    np.testing.assert_allclose(sym @ z.view(), z.view() * w, atol=1e-9)

    hg = c_api.matrix_create_d(N, N, ColMajor(m).mv, N)
    s, s_mv = vec(N, np.float64)
    info, hu, hv = c_api.matrix_gesvd(hg, s_mv, True, True)
    sj, _, _ = jx.sapi.pdgesvd("n", "n", m.copy())
    assert info == 0 and hu > 0 and hv > 0
    np.testing.assert_allclose(s, np.asarray(sj), rtol=TOL)
    u, vt = ColMajor(np.zeros((N, N))), ColMajor(np.zeros((N, N)))
    assert c_api.matrix_read_d(hu, u.mv, N) == c_api.matrix_read_d(hv, vt.mv, N) == 0
    np.testing.assert_allclose((u.view() * s) @ vt.view(), m, atol=1e-9)

    for h in (ha, hb, hs, hg, hu, hv):
        c_api.matrix_destroy(h)
    assert c_api.matrix_shape(ha) is None and c_api.matrix_read_d(ha, out.mv, N) == -1
    assert c_api.matrix_gesv(ha, hb) == -1
    assert c_api.runtime().handles == {}


def test_handle_owns_a_copy(cpu_runtime):
    a = rnd((6, 4), 17, np.float32)
    A = ColMajor(a)
    h = c_api.matrix_create_s(6, 4, A.mv, 6)
    A.flat[:] = 0                                       # the caller reuses its buffer
    out = ColMajor(np.zeros((6, 4), np.float32))
    assert c_api.matrix_read_s(h, out.mv, 6) == 0
    np.testing.assert_array_equal(out.view(), a)
    stored = c_api.runtime().handles[h]
    assert stored.base is None and not np.shares_memory(stored, A.flat)
    c_api.matrix_destroy(h)


@pytest.mark.parametrize("t", ["s", "c"])
def test_gemm_and_lange_match_jax(cpu_runtime, jx, t):
    dt = {"s": np.float32, "c": np.complex64}[t]
    a, b, c = rnd((12, 9), 18, dt), rnd((7, 9), 19, dt), rnd((12, 7), 20, dt)
    A, B, C = ColMajor(a, ld=14), ColMajor(b), ColMajor(c)
    if t == "s":
        alpha, beta = 1.5, -0.5
    else:
        alpha = memoryview(np.array([1.5 - 0.25j], dt))
        beta = memoryview(np.array([-0.5 + 1j], dt))
    assert getattr(c_api, f"{t}gemm")("n", "t", 12, 7, 9, alpha, A.mv, 14, B.mv, 7, beta,
                                      C.mv, 12) == 0
    al, be = (dt(1.5), dt(-0.5)) if t == "s" else (dt(1.5 - 0.25j), dt(-0.5 + 1j))
    want = getattr(jx.sapi, f"p{t}gemm")("n", "t", al, a, b, be, c.copy())
    np.testing.assert_allclose(C.view(), np.asarray(want), rtol=1e-5, atol=1e-5)
    d = rnd((10, 8), 21)
    for norm in "1ifm":
        got = c_api.dlange(norm, 10, 8, ColMajor(d, ld=11).mv, 11)
        assert got == pytest.approx(float(jx.sapi.pdlange(norm, d)), rel=1e-14)


REHEARSAL = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
sizes = dict(cs.CAPI, n=256)
res = cs.capi_path("cpu", sizes, programs=False)
cs.check_capi_path(res, sizes, programs=False)
print(json.dumps({k: {"c_over_py": v["c_over_py"], "launches": v["launches"]}
                  for k, v in res["steps"].items()}))
"""


def test_chip_phase_16_rehearsal(lib_path):
    """chip_smoke.py's phase 16 calls (sposv, sgesv, sgemm, dlange through
    the library loaded in process) at n = 256 on the CPU, in a child
    process, under the phase's own checks."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop(c_api.DEVICE_ENV, None)
    run = subprocess.run([sys.executable, "-c", REHEARSAL, ROOT], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    steps = json.loads(run.stdout.strip().splitlines()[-1])
    assert set(steps) == {"sposv", "sgesv", "sgemm", "dlange_1", "dlange_i", "dlange_f",
                          "dlange_m"}
    assert all(s["c_over_py"] > 0 for s in steps.values())
