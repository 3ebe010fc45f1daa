"""LU family of the PyTorch port (slate_tpu_torch.linalg.lu) against the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU.
Tolerances:

* packed LU factors and solutions: ||x_torch - x_jax||_F / ||x_jax||_F <= 1e-12
  in f64 and <= 1e-5 in f32 (the same algorithm over different LAPACK builds);
* permutations exact (the inputs are random normal, so no pivot ties), ``info``
  codes, exception types and ``SolveReport`` chains identical;
* refined solutions (gesv_mixed, GMRES-IR, RBT) to the refinement's own stopping
  tolerance: the port's and the JAX package's X within 1e-12 relative (both stop
  at backward error ~eps sqrt(n)), and the RBT solution, whose butterflies come
  from different random streams, the same;
* the butterfly transforms, given the JAX package's diagonals W, to 1e-12;
* condition estimates to rtol 1e-10 (the same power iteration).
"""

import numpy as np
import pytest
import torch

import jax

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu.linalg import lu as jlu
from slate_tpu_torch.core.matrix import from_reference_factors
from slate_tpu_torch.core.types import Target
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.ops import cuda_pivots as cp
from slate_tpu_torch.robust import first_bad_index_batched
from slate_tpu_torch.utils import trace as ttrace

RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _gen(seed, m, n, dtype=np.float64, cplx=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if cplx:
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dtype) if not cplx else a


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got).astype(np.complex128), _np(want).astype(np.complex128)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_lu(a, lu_arr, perm):
    m, n = a.shape
    k = min(m, n)
    lu_arr = _np(lu_arr)
    L = np.tril(lu_arr, -1)[:, :k] + np.eye(m, k)
    U = np.triu(lu_arr)[:k, :]
    return np.linalg.norm(a[_np(perm)] - L @ U) / np.linalg.norm(a)


def _both_getrf(a, opts):
    lj, pj, ij = sj.getrf(a.copy(), opts)
    lt, pt, it = st.getrf(_t(a), opts)
    return (_np(lj), _np(pj), int(ij)), (lt.numpy(), pt.numpy(), int(it))


# ---------------------------------------------------------------------------
# getrf: both targets, nopiv, CALU with both panels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("m,n,nb", [(29, 29, 8), (19, 11, 4), (11, 19, 4), (300, 300, 64),
                                    (517, 517, 32)],
                         ids=["square", "tall", "wide", "n300", "ragged517"])
@pytest.mark.parametrize("target", ["xla", "tiled", "tiled-lookahead0"])
def test_getrf_partial_pivot(target, m, n, nb, dtype):
    """Both routes; the blocked driver with its default one-panel lookahead
    ("tiled") and without ("tiled-lookahead0"), over one to seventeen panels
    (517 = 16 x 32 + 5: a last panel narrower than nb)."""
    a = _gen(m * 100 + n, m, n, dtype)
    opts = {"target": target.split("-")[0], "block_size": nb}
    if target.endswith("lookahead0"):
        opts["lookahead"] = 0
    (lj, pj, ij), (lt, pt, it) = _both_getrf(a, opts)
    assert ij == it == 0
    np.testing.assert_array_equal(pt, pj)
    assert lt.dtype == lj.dtype
    assert _rel(lt, lj) <= RTOL[dtype]
    assert _check_lu(a.astype(np.float64), lt, pt) < (1e-13 if dtype == np.float64 else 1e-5)


def test_getrf_writes_the_factor_into_a_wrapper():
    a = _gen(1, 24, 24)
    Aj = sj.Matrix.from_array(a.copy(), nb=8)
    At = st.Matrix.from_array(_t(a), nb=8)
    keep = At.array.clone()
    sj.getrf(Aj, {"target": "tiled", "block_size": 8})
    lt, _, _ = st.getrf(At, {"target": "tiled", "block_size": 8})
    assert torch.equal(At.array, lt)
    assert _rel(At.array, Aj.array) <= 1e-12
    assert not torch.equal(keep, lt)


def test_getrf_nopiv_diag_dominant():
    n = 21
    a = _gen(2, n, n) + n * np.eye(n)
    lj, ij = sj.getrf_nopiv(a, {"block_size": 6})
    lt, it = st.getrf_nopiv(_t(a), {"block_size": 6})
    assert int(ij) == int(it) == 0
    assert _rel(lt, lj) <= 1e-12
    # through getrf: identity perm
    _, perm, _ = st.getrf(_t(a), {"method_lu": "nopiv", "block_size": 6})
    np.testing.assert_array_equal(perm.numpy(), np.arange(n))


@pytest.mark.parametrize("n", [100, 300])
def test_lu_nopiv_blocked_recursion(n):
    """Above the 128 base the nopiv block factor recurses (two solves, one
    Schur gemm) — the CALU and RBT block kernel."""
    a = _gen(3, n, n) + n * np.eye(n)
    assert _rel(tlu._lu_nopiv_blocked(_t(a)), jlu._lu_nopiv_blocked(a)) <= 1e-12


@pytest.mark.parametrize("panel", ["tournament", "pp"])
@pytest.mark.parametrize("m,n,nb,ib", [(26, 26, 5, 5), (40, 40, 10, 5), (70, 50, 16, 4),
                                       (50, 70, 32, 8), (256, 256, 64, 16)],
                         ids=["flat", "two-level", "tall", "wide", "n256"])
def test_getrf_tntpiv(m, n, nb, ib, panel):
    """Two-level CALU (outer nb trailing updates, inner ib pivot panels): the
    tournament's batched pair merges (an odd leaf count at n = 26, a ragged
    tail block whenever the panel height is not a multiple of ib) and the pp
    panel, on square, tall and wide inputs."""
    a = _gen(m + 7 * n + ib, m, n)
    opts = {"method_lu": "calu", "block_size": nb, "inner_blocking": ib,
            "lu_panel": panel}
    (lj, pj, ij), (lt, pt, it) = _both_getrf(a, opts)
    assert ij == it == 0
    np.testing.assert_array_equal(pt, pj)
    assert _rel(lt, lj) <= 1e-12
    assert _check_lu(a, lt, pt) < 1e-11
    assert sorted(pt.tolist()) == list(range(m))
    assert ttrace.last_phases("getrf_tntpiv")["pivots"] >= 0.0


def test_getrf_tntpiv_f32():
    a = _gen(4, 128, 128, np.float32)
    opts = {"method_lu": "calu", "block_size": 64, "inner_blocking": 16}
    (lj, pj, _), (lt, pt, _) = _both_getrf(a, opts)
    np.testing.assert_array_equal(pt, pj)
    assert _rel(lt, lj) <= 1e-5


def test_getrf_tntpiv_pp_matches_lapack_pivots():
    """With ib == nb == n (one panel), pp-CALU reproduces classic partial
    pivoting exactly — same permutation, same factor."""
    import scipy.linalg as sla

    n = 24
    a = _gen(5, n, n)
    lu_arr, perm, info = st.getrf(_t(a), {"method_lu": "calu", "block_size": n,
                                          "inner_blocking": n, "lu_panel": "pp"})
    lu_ref, piv = sla.lu_factor(a)
    np.testing.assert_array_equal(perm.numpy(), tlu.pivots_to_perm(piv + 1))
    assert np.allclose(lu_arr.numpy(), lu_ref, atol=1e-12)


def test_getrf_bad_lu_panel_raises():
    """lu_panel is validated on every getrf path, the default one included."""
    a = _t(_gen(6, 16, 16))
    for opts in ({"method_lu": "calu", "lu_panel": "bogus"}, {"lu_panel": "bogus"}):
        with pytest.raises(sj.SlateError):
            sj.getrf(a.numpy(), opts)
        with pytest.raises(st.SlateError):
            st.getrf(a, opts)


@pytest.mark.parametrize("method", ["partialpiv", "calu", "nopiv"])
@pytest.mark.parametrize("target", ["xla", "tiled"])
def test_info_singular_and_nan(method, target):
    """info comes from the U diagonal (first zero or NaN pivot), never from the
    library's info: an exactly singular matrix and a NaN input give the JAX
    package's codes on every path."""
    n = 24
    a = _gen(7, n, n) + n * np.eye(n)
    sing = a.copy()
    sing[:, 5] = 0.0
    sing[5, :] = 0.0
    nan = a.copy()
    nan[9, 9] = np.nan
    opts = {"method_lu": method, "target": target, "block_size": 8, "inner_blocking": 4}
    for bad in (sing, nan):
        _, _, ij = sj.getrf(bad.copy(), opts)
        _, _, it = st.getrf(_t(bad), opts)
        assert int(it) == int(ij) > 0
        assert it.dtype == torch.int32


def _ipiv_case(kind, seed):
    """(ipiv, row0, mw): a panel's 1-based LAPACK ipiv of w swaps in a window
    of mw rows whose top row is row0."""
    rng = np.random.default_rng(seed)
    w, mw, row0 = {"random": (16, 200, 0), "self_swaps": (12, 90, 40),
                   "repeated_targets": (16, 64, 7), "last_square_panel": (5, 5, 512),
                   "narrower_than_nb": (3, 40, 97), "one_row": (1, 1, 0)}[kind]
    piv = np.array([rng.integers(k, mw) for k in range(w)])
    if kind == "self_swaps":
        piv[::2] = np.arange(w)[::2]
    if kind == "repeated_targets":
        piv[1::3] = mw - 1
        piv[2::3] = w + 1
    return torch.from_numpy((piv + 1).astype(np.int32)), row0, mw


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.complex128,
                                   torch.int64], ids=["f64", "f32", "c128", "i64"])
@pytest.mark.parametrize("kind", ["random", "self_swaps", "repeated_targets",
                                  "last_square_panel", "narrower_than_nb", "one_row"])
def test_row_moves_equal_the_host_replay(kind, dtype):
    """The row-move list of a panel (``cuda_pivots.pivot_moves``) and the row
    mover (``move_rows``), in their plain versions, give bit for bit what the
    host replay of the swaps (``_ipiv_perm``) and a whole-window gather give,
    on the int64 ``perm`` and on a column range of a row-major matrix."""
    ipiv, row0, mw = _ipiv_case(kind, 5)
    w = ipiv.shape[0]
    moves = cp.pivot_moves(ipiv, row0, mw)
    assert moves.dtype == torch.int32 and moves.shape == (2 * w, 2)
    live = moves[:, 0] >= 0
    assert (moves[~live] == -1).all()
    assert int(live.sum()) <= 2 * w
    window = torch.from_numpy(tlu._ipiv_perm(ipiv, mw, ttrace.Timers()))
    assert int(live.sum()) == int((window != torch.arange(mw)).sum())
    m = row0 + mw
    perm = cp.move_rows(torch.arange(m), moves)
    assert torch.equal(perm[:row0], torch.arange(row0))
    assert torch.equal(perm[row0:], row0 + window)
    full = (torch.arange(m * 9).reshape(m, 9) * 7 % 1009).to(dtype)
    got = full.clone()
    cp.move_rows(got[:, 2:7], moves)
    want = full.clone()
    want[row0:, 2:7] = full[row0:, 2:7][window]
    assert torch.equal(got, want)


@pytest.mark.parametrize("device,shape,target,route", [
    ("cpu", (49152, 49152), "auto", "library"),
    ("cuda", (4, 49152, 49152), "auto", "library"),
    ("cuda", (tlu.LU_LOOKAHEAD_MIN - 1,) * 2, "auto", "library"),
    ("cuda", (60000, tlu.LU_LOOKAHEAD_MIN - 1), "auto", "library"),
    ("cuda", (tlu.LU_LOOKAHEAD_MIN,) * 2, "auto", "lookahead"),
    ("cuda", (49152, 49152), "auto", "lookahead"),
    ("cuda", (49152, 49152), "xla", "library"),
    ("cpu", (24, 24), "tiled", "lookahead"),
    ("cuda", (64, 64), "tiled", "lookahead"),
], ids=["cpu", "batched", "small", "thin", "crossover", "hpl", "xla", "tiled-cpu",
        "tiled-small"])
def test_the_lu_route_is_a_function_of_device_batch_and_shape(device, shape, target,
                                                              route):
    assert tlu._lu_route(device, shape, Target.from_string(target)) == route


@pytest.mark.parametrize("target,block_size,shape,nb", [
    ("auto", 256, (49152, 49152), 1024), ("auto", 256, (32768, 40000), 1024),
    ("auto", 128, (24576, 24576), 768), ("auto", 2048, (16384, 16384), 512),
    ("auto", 256, (8192, 8192), 256), ("tiled", 64, (300, 300), 64),
    ("tiled", 256, (19, 11), 11), ("tiled", 8192, (10000, 10000), 4096),
], ids=["hpl", "wide", "n24576", "n16384", "crossover", "tiled", "tiled-small",
        "tiled-widest"])
def test_the_panel_width(target, block_size, shape, nb):
    """Target Tiled takes Options.block_size; Target Auto derives the width
    from the shape (min(m, n) / 32 in steps of 256, within [256, 1024]);
    both within the matrix and the widest panel the pivot kernels take."""
    assert tlu._panel_width(Target.from_string(target), block_size, *shape) == nb


def test_a_nan_the_library_lost_is_put_back():
    """The card's library LU can return a finite factor for a NaN input (info
    0).  _mark_lost_nan NaN-fills from the first column holding a NaN, so info
    names the pivot the CPU libraries (and the JAX package) report; a factor
    that kept its NaN, or a clean input, is left as it is.  Batched too."""
    n = 24
    a = _gen(30, n, n) + n * np.eye(n)
    nan = a.copy()
    nan[9, 9] = np.nan
    finite, _, _ = torch.linalg.lu_factor_ex(_t(a))        # what the card returns
    got = tlu._mark_lost_nan(_t(nan), finite.clone())
    assert int(tlu._lu_info(got.diagonal())) == 10 == int(sj.getrf(nan)[2])
    assert torch.isnan(got[:, 9:]).all() and torch.equal(got[:, :9], finite[:, :9])
    kept, _, _ = torch.linalg.lu_factor_ex(_t(nan))
    assert torch.equal(torch.isnan(tlu._mark_lost_nan(_t(nan), kept.clone())),
                       torch.isnan(kept))
    assert torch.equal(tlu._mark_lost_nan(_t(a), finite.clone()), finite)
    both = tlu._mark_lost_nan(_t(np.stack([nan, a])), torch.stack([finite, finite]))
    assert torch.isnan(both[0, :, 9:]).all() and not torch.isnan(both[1]).any()


def _bits(t):
    """The raw bits of a float or complex tensor, so NaNs compare too."""
    r = torch.view_as_real(t) if t.is_complex() else t
    return r.contiguous().view(torch.int32 if r.element_size() == 4 else torch.int64)


_GUARD_DTYPES = {"f32": torch.float32, "f64": torch.float64, "c64": torch.complex64,
                 "c128": torch.complex128}
# case -> the 1-based first NaN column of A (n = 24), 0 for none
_GUARD_CASES = {"clean": 0, "lost": 10, "kept": 10, "first_column": 1, "last_column": 24,
                "several_columns": 6, "inf_no_nan": 0, "imaginary_nan": 8,
                "transposed": 10}


def _guard_case(case, dtype):
    """(A, plu) for one NaN-guard case: A 24 x 24 of ``dtype`` (a transposed
    view for "transposed"), plu a finite factor of the clean matrix, with one
    NaN where the factor kept it."""
    n = 24
    a = _gen(31, n, n, cplx=dtype.is_complex) + n * np.eye(n)
    clean = torch.from_numpy(a).to(dtype)
    plu, _, _ = torch.linalg.lu_factor_ex(clean)
    A = clean.clone()
    nan = float("nan")
    if case in ("lost", "kept"):
        A[9, 9] = nan
    elif case == "first_column":
        A[17, 0] = nan
    elif case == "last_column":
        A[0, n - 1] = nan
    elif case == "several_columns":
        A[3, 14], A[20, 5], A[0, 20] = nan, nan, nan
    elif case == "inf_no_nan":
        A[4, 4], A[11, 2] = float("inf"), -float("inf")
    elif case == "imaginary_nan":
        A[2, 7] = complex(float(A[2, 7].real), nan)
    elif case == "transposed":
        B = clean.clone()
        B[9, 4] = nan
        A = B.mT
    if case == "kept":
        plu[3, 17] = nan
    return A, plu


@pytest.mark.parametrize("dtype,case", [
    (d, c) for d in _GUARD_DTYPES for c in _GUARD_CASES
    if c != "imaginary_nan" or _GUARD_DTYPES[d].is_complex])
def test_copy_scan_and_guard_equal_the_private_copy_and_mark_lost_nan(dtype, case):
    """The lookahead route's NaN guard (``cuda_pivots.copy_scan_nan`` then
    ``guard_lost_nan``, here their plain versions) gives bit for bit what the
    library route's ``_private_copy`` + ``_mark_lost_nan`` give: the copy, the
    first NaN column of A, and the guarded factor."""
    A, plu = _guard_case(case, _GUARD_DTYPES[dtype])
    copy, first = cp.copy_scan_nan(A)
    want = tlu._private_copy(A)
    assert copy.is_contiguous() and copy.dtype == want.dtype
    assert torch.equal(_bits(copy), _bits(want))
    assert copy.data_ptr() != A.data_ptr()
    assert first.dtype == torch.int32 and first.shape == ()
    assert int(first) == _GUARD_CASES[case]
    assert torch.equal(first, first_bad_index_batched(torch.isnan(A).any(dim=-2)))
    got = cp.guard_lost_nan(plu.clone(), first)
    ref = tlu._mark_lost_nan(A, plu.clone())
    assert torch.equal(_bits(got), _bits(ref))
    filled = case not in ("clean", "kept", "inf_no_nan")
    assert bool(torch.isnan(got[:, int(first) - 1:]).all()) == filled
    if filled:
        assert int(tlu._lu_info(got.diagonal())) == int(first)
    else:
        assert torch.equal(_bits(got), _bits(plu))


@pytest.mark.parametrize("m,n,dtype,lds,aligned,copy,vw", [
    (5, 6, torch.float64, 6, True, True, 2),         # back to back: one flat row
    (3, 5, torch.float32, 5, True, True, 1),         # 15 scalars: no whole packs
    (4, 6, torch.float64, 8, True, True, 2),         # padded rows, 64-byte pitch
    (4, 6, torch.float64, 7, True, True, 1),         # a 56-byte pitch
    (4, 3, torch.complex64, 4, True, True, 1),       # rows of 6 scalars
    (4, 3, torch.complex128, 5, True, True, 2),      # rows of 6, an 80-byte pitch
    (1, 9, torch.float32, 40, True, True, 1),        # one row: flat, 9 scalars
    (7, 1, torch.float64, 3, True, True, 1),         # one strided column
    (6, 8, torch.float32, 8, False, True, 1),        # an unaligned base
    (5, 4, torch.float32, 12, True, False, 4),       # the scan alone, padded rows
], ids=["flat", "flat-ragged", "padded", "padded-odd", "c64", "c128", "one-row",
        "one-column", "unaligned", "scan-only"])
def test_the_scan_plan_walks_every_element_once(m, n, dtype, lds, aligned, copy, vw):
    """``cuda_pivots.scan_plan``, the walk the card's copy-and-scan kernel
    takes, emulated: every scalar of the m x n matrix (rows ``lds`` elements
    apart) is read once, written once to its place in the row-major copy, and
    credited to its own column."""
    g = cp.scan_plan(m, n, dtype, lds, aligned, copy)
    assert g["vw"] == vw
    assert g["units"] == -(-g["len"] // 256)
    assert g["blocks"] == min(g["rows"] * g["units"], 2**31 - 1)
    c, w = g["comps"], g["vw"]
    r, v, e = np.meshgrid(np.arange(g["rows"]), np.arange(g["len"]), np.arange(w),
                          indexing="ij")
    s = v * w + e
    got = np.stack([r * g["lds"] * w + s, r * g["ldd"] * w + s, s // c % n], -1)
    i, j, k = np.meshgrid(np.arange(m), np.arange(n), np.arange(c), indexing="ij")
    want = np.stack([(i * lds + j) * c + k, (i * n + j) * c + k, j], -1)
    got, want = got.reshape(-1, 3), want.reshape(-1, 3)
    if not copy:
        got, want = got[:, [0, 2]], want[:, [0, 2]]
    assert np.array_equal(np.unique(got, axis=0), np.unique(want, axis=0))
    assert len(got) == len(want)


@pytest.mark.parametrize("target,route,guard", [
    ("tiled", "lookahead", "fused"), ("xla", "library", "library"),
    ("auto", "library", "library")])
def test_each_route_counts_its_guard(target, route, guard):
    """The lookahead route guards with the fused copy-and-scan
    (``slate_lu_guard_total{guard="fused"}``), the library route with
    ``_mark_lost_nan`` (``{guard="library"}``); Target Auto on a CPU tensor
    takes the library route."""
    st.obs.reset()
    a = _gen(8, 40, 40)
    st.getrf(_t(a), {"target": target, "block_size": 16})
    assert st.obs.REGISTRY.get("slate_lu_route_total").value(route=route) == 1.0
    c = st.obs.REGISTRY.get("slate_lu_guard_total")
    assert c.value(guard=guard) == 1.0
    assert c.value(guard="library" if guard == "fused" else "fused") == 0.0


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["partialpiv", "calu"])
def test_gesv(method):
    n, nrhs = 24, 3
    a, b = _gen(8, n, n), _gen(9, n, nrhs)
    opts = {"method_lu": method, "target": "tiled", "block_size": 8}
    Xj, pj, ij = sj.gesv(sj.Matrix.from_array(a.copy(), nb=8),
                         sj.Matrix.from_array(b.copy(), nb=8), opts)
    Bt = st.Matrix.from_array(_t(b), nb=8)
    Xt, pt, it = st.gesv(st.Matrix.from_array(_t(a), nb=8), Bt, opts)
    assert int(ij) == int(it) == 0
    np.testing.assert_array_equal(pt.numpy(), _np(pj))
    assert _rel(Xt, Xj) <= 1e-12
    assert torch.equal(Bt.array, Xt)
    resid = np.linalg.norm(b - a @ Xt.numpy()) / (np.linalg.norm(a)
                                                   * np.linalg.norm(Xt.numpy()) * n)
    assert resid < 1e-14


def test_gesv_solve_report_and_core():
    a, b = _gen(10, 20, 20), _gen(11, 20, 2)
    *_, rj = sj.gesv(a, b, {"solve_report": True})
    *_, rt = st.gesv(_t(a), _t(b), {"solve_report": True})
    assert (rt.routine, rt.info, rt.fallback_chain, rt.recovered, rt.precision_used) == \
        (rj.routine, rj.info, rj.fallback_chain, rj.recovered, rj.precision_used)
    xj, pj, ij = sj.linalg.gesv_core(a, b)
    xt, pt, it = st.linalg.gesv_core(_t(a), _t(b))
    assert _rel(xt, xj) <= 1e-12 and int(it) == int(ij) == 0
    np.testing.assert_array_equal(pt.numpy(), _np(pj))
    # a leading batch dimension: one perm and one info per matrix
    sing = a.copy()
    sing[:, 3] = 0.0
    xb, pb, ib = st.linalg.gesv_core(_t(np.stack([a, sing])), _t(np.stack([b, b])))
    assert _rel(xb[0], xj) <= 1e-12
    np.testing.assert_array_equal(pb[0].numpy(), _np(pj))
    assert int(ib[0]) == 0 and int(ib[1]) == int(sj.linalg.gesv_core(sing, b)[2]) > 0


@pytest.mark.parametrize("shape", [(30, 30), (7, 30, 30), (3, 64, 64)])
@pytest.mark.parametrize("poison", [False, True])
def test_gesv_core_device_perm_equals_host_replay_and_jax(shape, poison):
    """gesv_core converts the pivots on the device (lu_unpack + argmax, no
    host sync): int64 and bit-identical to the host replay the blocked
    drivers time (_ipiv_perm) and to the JAX package's permutation, for
    singular and NaN elements too."""
    a = _gen(70 + len(shape), *shape[-2:]) if len(shape) == 2 else \
        np.stack([_gen(70 + i, *shape[-2:]) for i in range(shape[0])])
    if poison:
        a = a.copy()
        a[..., :, 5] = 0.0
        a[..., -1, -1] = np.nan
    b = np.ones(shape[:-1] + (2,))
    _, pt, it = tlu.gesv_core(_t(a), _t(b))
    plu, piv = tlu._lu_factor(_t(a))
    host = tlu._ipiv_perm(piv, shape[-2], ttrace.Timers())
    assert pt.dtype == torch.int64
    np.testing.assert_array_equal(pt.numpy(), host)
    jax_core = jax.vmap(jlu.gesv_core) if len(shape) == 3 else jlu.gesv_core
    _, pj, ij = jax_core(a, b)
    np.testing.assert_array_equal(pt.numpy(), _np(pj))
    np.testing.assert_array_equal(it.numpy(), _np(ij))


@pytest.mark.parametrize("trans", ["n", "t", "c", True, False])
@pytest.mark.parametrize("cplx", [False, True])
def test_getrs_trans(trans, cplx):
    n = 16
    a, b = _gen(12, n, n, cplx=cplx), _gen(13, n, 2, cplx=cplx)
    lj, pj, _ = sj.getrf(a.copy())
    lt, pt, _ = st.getrf(_t(a))
    xj = sj.getrs(lj, pj, b.copy(), trans=trans)
    xt = st.getrs(lt, pt, _t(b), trans=trans)
    assert _rel(xt, xj) <= 1e-12
    code = {True: "t", False: "n"}.get(trans, trans)
    op = {"n": a, "t": a.T, "c": a.conj().T}[code]
    assert np.linalg.norm(b - op @ xt.numpy()) / np.linalg.norm(b) < 1e-11
    # getrs_nopiv: no permutation
    ln, _ = st.getrf_nopiv(_t(a + 4 * n * np.eye(n)))
    ln_j, _ = sj.getrf_nopiv(a + 4 * n * np.eye(n))
    assert _rel(st.getrs_nopiv(ln, _t(b), trans=trans),
                sj.getrs_nopiv(ln_j, b.copy(), trans=trans)) <= 1e-12


def test_getri_and_getri_oop():
    """Both consume the (LU, perm) factor like the reference (src/getri.cc);
    getri writes the inverse over the factor, getri_oop into B."""
    n = 18
    a = _gen(14, n, n)
    lj, pj, _ = sj.getrf(a.copy())
    inv_j = _np(sj.getri(lj, pj))
    At = st.Matrix.from_array(_t(a), nb=6)
    lt, pt, _ = st.getrf(At)
    Bt = st.Matrix.from_array(torch.zeros(n, n, dtype=torch.float64), nb=6)
    inv_oop = st.getri_oop(At, pt, Bt)
    assert torch.equal(Bt.array, inv_oop)
    assert torch.equal(At.array, lt)             # the factor is intact
    inv = st.getri(At, pt)
    assert torch.equal(At.array, inv)            # written over the factor
    assert _rel(inv, inv_j) <= 1e-12 and _rel(inv_oop, inv_j) <= 1e-12
    np.testing.assert_allclose(inv.numpy() @ a, np.eye(n), atol=1e-10)


def test_factorization_carried_from_the_jax_package():
    """A JAX-package getrf factor handed to the port's getrs/getri/gecondest
    through from_reference_factors gives the JAX package's results."""
    n = 30
    a = _gen(15, n, n) + 3 * np.eye(n)
    b = _gen(16, n, 2)
    lj, pj, _ = sj.getrf(a.copy())
    lt, pt = from_reference_factors({"LU": np.asarray(lj), "perm": np.asarray(pj)},
                                    device="cpu")
    assert pt.dtype == torch.int64
    assert _rel(st.getrs(lt, pt, _t(b)), sj.getrs(lj, pj, b.copy())) <= 1e-12
    assert _rel(st.getri(lt.clone(), pt), sj.getri(lj, pj)) <= 1e-12
    anorm = np.abs(a).sum(0).max()
    np.testing.assert_allclose(float(st.gecondest(lt, pt, anorm)),
                               float(sj.gecondest(lj, pj, anorm)), rtol=1e-10)


@pytest.mark.parametrize("norm_kind", ["one", "inf"])
@pytest.mark.parametrize("source", ["jax", "torch"])
def test_gecondest_on_each_packages_getrf(source, norm_kind):
    """The port's gecondest solves through its own lu_factored_solve; on a getrf
    factor from either package it matches the JAX package's estimate."""
    n = 40
    a = _gen(17, n, n) + 2 * np.eye(n)
    if source == "jax":
        lu_, perm, _ = (np.asarray(x) for x in sj.getrf(a.copy()))
    else:
        lu_, perm, _ = (x.numpy() for x in st.getrf(_t(a)))
    anorm = np.abs(a).sum(0 if norm_kind == "one" else 1).max()
    want = sj.gecondest(lu_, perm, anorm, norm_kind=norm_kind)
    got = st.gecondest(_t(lu_), _t(perm), anorm, norm_kind=norm_kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    exact = 1.0 / (anorm * np.abs(np.linalg.inv(a)).sum(0 if norm_kind == "one"
                                                         else 1).max())
    assert exact <= float(got) * (1 + 1e-10)


# ---------------------------------------------------------------------------
# mixed precision, GMRES-IR, RBT
# ---------------------------------------------------------------------------


def test_gesv_mixed():
    n = 32
    a, b = _gen(18, n, n) + n * np.eye(n), _gen(19, n, 2)
    Xj, pj, ij, itj, rj = sj.linalg.gesv_mixed(a, b.copy(), {"solve_report": True})
    Xt, pt, it, itt, rt = st.gesv_mixed(_t(a), _t(b), {"solve_report": True})
    assert int(itt) == int(itj) >= 1 and itt.dtype == torch.int32
    assert int(it) == int(ij) == 0
    np.testing.assert_array_equal(pt.numpy(), _np(pj))
    assert _rel(Xt, Xj) <= 1e-12
    assert (rt.fallback_chain, rt.precision_used, rt.iters, rt.recovered) == \
        (rj.fallback_chain, rj.precision_used, rj.iters, rj.recovered) == \
        (("mixed",), "float32", int(itj), True)
    assert ttrace.last_phases("gesv_mixed")["pivots"] >= 0.0


def test_gesv_mixed_f32_falls_back_cleanly():
    """f32 has no lower factor rung: the plain solve, iters 0, chain ("full",)."""
    n = 12
    a = (np.eye(n) * n + _gen(20, n, n)).astype(np.float32)
    b = _gen(21, n, 1).astype(np.float32)
    Xj, _, _, itj, rj = sj.linalg.gesv_mixed(a, b.copy(), {"solve_report": True})
    Xt, _, _, itt, rt = st.gesv_mixed(_t(a), _t(b), {"solve_report": True})
    assert int(itt) == int(itj) == 0
    assert rt.fallback_chain == rj.fallback_chain == ("full",)
    assert rt.precision_used == rj.precision_used == "float32"
    assert _rel(Xt, Xj) <= 1e-5


@pytest.mark.parametrize("routine", ["gesv", "posv"])
def test_mixed_gmres(routine):
    """GMRES-IR (n = 24, so restart = 24): it converges within one restart
    cycle, in fewer Krylov steps than the restart length."""
    n = 24
    g = _gen(22, n, n)
    a = g + n * np.eye(n) if routine == "gesv" else g @ g.T + n * np.eye(n)
    b = _gen(23, n, 1)
    if routine == "gesv":
        Xj, pj, ij, rj = sj.linalg.gesv_mixed_gmres(a, b.copy())
        Xt, pt, it, rt = st.gesv_mixed_gmres(_t(a), _t(b))
        np.testing.assert_array_equal(pt.numpy(), _np(pj))
    else:
        Xj, ij, rj = sj.linalg.posv_mixed_gmres(a, b.copy())
        Xt, it, rt = st.posv_mixed_gmres(_t(a), _t(b))
    assert int(it) == int(ij) == 0
    assert int(rt) == int(rj) == 1
    assert _rel(Xt, Xj) <= 1e-12
    assert np.linalg.norm(b - a @ Xt.numpy()) / np.linalg.norm(b) < 1e-12
    with pytest.raises(st.SlateError):       # a single right-hand side only
        getattr(st, f"{routine}_mixed_gmres")(_t(a), _t(_gen(24, n, 2)))


@pytest.mark.parametrize("rank", [3, 30])
def test_gmres_least_squares_on_a_rank_deficient_hessenberg(rank):
    """A GMRES breakdown (hn = 0 at step ``rank``) leaves the Hessenberg matrix
    rank-deficient: the port's minimum-norm solve matches jnp.linalg.lstsq."""
    import jax.numpy as jnp

    rng = np.random.default_rng(25)
    H = np.triu(rng.standard_normal((31, 30)), -1) + 4 * np.eye(31, 30)
    H[:, rank:] = 0.0
    if rank < 30:
        H[rank, rank - 1] = 0.0
    e1 = np.zeros(31)
    e1[0] = 2.5
    want = np.asarray(jnp.linalg.lstsq(H, e1)[0])
    got = tlu._lstsq_min_norm(_t(H), _t(e1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_butterfly_transform_matches_jax():
    """Given the JAX package's diagonals, the butterflies agree to 1e-12, and
    U^T A V is what the dense U and V give."""
    import jax

    n, depth = 16, 2
    ku, kv = jax.random.split(jax.random.PRNGKey(0))
    Wu = np.asarray(jlu.rbt_generate(ku, n, depth, np.float64))
    Wv = np.asarray(jlu.rbt_generate(kv, n, depth, np.float64))
    a = _gen(26, n, n)
    for transpose in (False, True):
        assert _rel(tlu._butterfly_apply(Wu, _t(a), transpose=transpose),
                    jlu._butterfly_apply(Wu, a, transpose=transpose)) <= 1e-12
    got = st.gerbt(Wu, Wv, _t(a))
    assert _rel(got, sj.gerbt(Wu, Wv, a)) <= 1e-12
    U = tlu._butterfly_apply(Wu, torch.eye(n, dtype=torch.float64)).numpy()
    V = tlu._butterfly_apply(Wv, torch.eye(n, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got.numpy(), U.T @ a @ V, rtol=1e-10, atol=1e-12)
    # the port's generator: [depth, n] entries exp(r/10), r in [-0.5, 0.5)
    W = tlu.rbt_generate(torch.Generator().manual_seed(1), n, depth, torch.float64)
    assert W.shape == (depth, n)
    assert bool((W >= np.exp(-0.05)).all() and (W <= np.exp(0.05)).all())


@pytest.mark.parametrize("n", [16, 19])        # 19 exercises the padding path
def test_gesv_rbt(n):
    a, b = _gen(27, n, n) + 2 * np.eye(n), _gen(28, n, 2)
    Xj, ij, itj, rj = sj.gesv_rbt(a, b.copy(), {"depth": 2, "solve_report": True})
    Xt, it, itt, rt = st.gesv_rbt(_t(a), _t(b), {"depth": 2, "solve_report": True})
    assert int(it) == int(ij) == 0
    assert rt.fallback_chain == rj.fallback_chain == ("rbt",)
    assert rt.recovered and rj.recovered
    assert _rel(Xt, Xj) <= 1e-12
    x = Xt.numpy()
    assert np.linalg.norm(b - a @ x) / (np.linalg.norm(a) * np.linalg.norm(x)) < 1e-12
    # the same generator seed replays the same solve
    X2, *_ = st.gesv_rbt(_t(a), _t(b), {"depth": 2}, key=torch.Generator().manual_seed(42))
    assert torch.equal(X2, Xt)


# ---------------------------------------------------------------------------
# pivot encodings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 12, 200])
def test_perm_to_pivots_roundtrip(n):
    """The two encodings match the JAX package's bit for bit, and invert each
    other; LAPACK swaps replayed from ipiv rebuild A[perm]."""
    rng = np.random.default_rng(n)
    perm = rng.permutation(n)
    ipiv = tlu.perm_to_pivots(perm)
    np.testing.assert_array_equal(ipiv, jlu.perm_to_pivots(perm))
    np.testing.assert_array_equal(tlu.pivots_to_perm(ipiv), jlu.pivots_to_perm(ipiv))
    np.testing.assert_array_equal(tlu.pivots_to_perm(ipiv), perm)
    a = _gen(29, max(n, 2), max(n, 2))
    _, p, _ = st.getrf(_t(a))
    rows = np.arange(p.shape[0])
    for k, j in enumerate(tlu.perm_to_pivots(p) - 1):
        rows[[k, j]] = rows[[j, k]]
    np.testing.assert_array_equal(rows, p.numpy())
    assert ipiv.dtype == np.int64 and tlu.perm_to_pivots(_t(perm)).tolist() == ipiv.tolist()


def test_the_slice_exports_the_jax_packages_names():
    """Every solver name the JAX package's linalg exports for the Cholesky, LU
    and QR families, and every robust name but the serving faults, exists in
    the port under the same module."""
    import slate_tpu.linalg as jl
    import slate_tpu.robust as jr

    for mod in ("chol", "lu", "qr"):
        for name in dir(getattr(jl, mod)):
            if getattr(getattr(jl, mod), name) is getattr(jl, name, None):
                assert hasattr(st.linalg, name), name
    for name in jr.__all__:
        if "SERVE" not in name and not name.endswith("_serve"):
            assert hasattr(st.robust, name), name
