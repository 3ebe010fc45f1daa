"""Norm layer of the PyTorch port (slate_tpu_torch) against the JAX package.

The CUDA kernels of ``slate_tpu_torch/ops/cuda_norms.py`` run only on the card
(``chip_smoke.py`` holds them against their plain versions there).  Here the
plain versions, which are what a CPU tensor runs, are held against the JAX
package's Pallas kernels in interpret mode, over every op, mask mode and
unit-diagonal setting, in f32 and f64.

Tolerances: a max is exact (the same f32/f64 values are compared); sums use
rtol 1e-5 in f32 and 1e-12 in f64, because the two sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.ops import norms as jax_norms
from slate_tpu.ops import pallas_norms as pn
from slate_tpu_torch.ops import cuda_norms as cn
from slate_tpu_torch.ops import norms as torch_norms

SHAPES = [(5, 3), (1, 129), (257, 131), (8, 8), (300, 200), (3, 200)]
RTOL = {np.float32: 1e-5, np.float64: 1e-12}
MODES = (cn._MODE_GE, cn._MODE_LOWER, cn._MODE_UPPER, cn._MODE_LOWER_STRICT,
         cn._MODE_UPPER_STRICT)


def _sample(shape, dtype, seed=None):
    r = np.random.default_rng(sum(shape) if seed is None else seed)
    return r.standard_normal(shape).astype(dtype)


def _check(got: torch.Tensor, want, op: str, dtype):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


def test_mask_modes_match_pallas():
    assert MODES == (pn._MODE_GE, pn._MODE_LOWER, pn._MODE_UPPER,
                     pn._MODE_LOWER_STRICT, pn._MODE_UPPER_STRICT)


KERNEL_OPS = (("col", "sum"), ("col", "max"), ("col", "sumsq"), ("row", "sum"))


def _cases(shift: int):
    """A quarter of the op x mode x unit_diag sweep: for each (mode, unit_diag)
    one kernel op, rotated by ``shift``.  Each quarter holds every op, every
    mode and both unit_diag settings; four consecutive shifts hold the whole
    sweep."""
    cases = []
    for mode in MODES:
        for unit in (0, 1):
            kernel, op = KERNEL_OPS[(2 * unit + mode + shift) % 4]
            cases.append((kernel, mode, bool(unit), op))
    return cases


def test_case_quarters_cover_the_sweep():
    for dtype_shift in (0, 2):
        seen = [c for i in range(len(SHAPES)) for c in _cases(i + dtype_shift)]
        assert len(set(seen)) == len(MODES) * 2 * len(KERNEL_OPS)
    for case_set in map(_cases, range(4)):
        assert {(k, op) for k, _, _, op in case_set} == set(KERNEL_OPS)
        assert {(m, u) for _, m, u, _ in case_set} == {(m, u) for m in MODES
                                                       for u in (False, True)}


def _pallas_all(x, cases):
    """The cases through the Pallas kernels, traced into one program so the
    interpret-mode compile happens once per shape and dtype."""
    return [pn.col_reduce(x, mode, unit, op) if kernel == "col"
            else pn.row_sums(x, mode, unit) for kernel, mode, unit, op in cases]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_versions_match_pallas(shape, dtype):
    """col_reduce_plain / row_sums_plain vs pallas_norms.col_reduce / row_sums
    (interpret mode).  Each shape and dtype runs every op, all 5 mask modes
    and unit_diag on and off in a quarter of their combinations; over the six
    shapes each dtype runs every combination (``_cases``), which keeps the
    interpret-mode calls to 10 per case."""
    a = _sample(shape, dtype)
    t = torch.from_numpy(a)
    cases = _cases(SHAPES.index(shape) + (2 if dtype == np.float64 else 0))
    wants = jax.jit(lambda x: _pallas_all(x, cases))(jnp.asarray(a))
    for (kernel, mode, unit, op), want in zip(cases, wants):
        got = (cn.col_reduce_plain(t, mode, unit, op) if kernel == "col"
               else cn.row_sums_plain(t, mode, unit))
        _check(got, want, op, dtype)


def test_wrappers_take_plain_version_on_cpu():
    a = torch.from_numpy(_sample((37, 21), np.float64))
    before = dict(cn.LAUNCHES)
    for mode in MODES:
        for op in ("sum", "max", "sumsq"):
            assert torch.equal(cn.col_reduce(a, mode, True, op),
                               cn.col_reduce_plain(a, mode, True, op))
        assert torch.equal(cn.row_sums(a, mode), cn.row_sums_plain(a, mode))
    assert cn.LAUNCHES == before      # no kernel was launched


def test_unit_diag_stops_at_min_dim():
    """Unit diagonal of a wide 3 x 200 matrix sets only 3 entries
    (pallas_norms.py:115 bounds it by the valid extents)."""
    z = torch.zeros((3, 200), dtype=torch.float32)
    assert float(cn.genorm(z, "max", mode=cn._MODE_LOWER, unit_diag=True)) == 1.0
    assert float(cn.genorm(z, "one", mode=cn._MODE_UPPER, unit_diag=True)) == 1.0
    assert float(cn.genorm(z, "fro", unit_diag=True)) == pytest.approx(3 ** 0.5)


def test_masked_region_is_not_read():
    """NaN outside the kept triangle must not reach the result."""
    a = _sample((6, 6), np.float64)
    poisoned = np.tril(a) + np.triu(np.full((6, 6), np.nan), 1)
    t = torch.from_numpy(poisoned)
    want = np.abs(np.tril(a)).sum(0)
    np.testing.assert_allclose(cn.col_reduce_plain(t, cn._MODE_LOWER).numpy(), want,
                               rtol=1e-15)
    assert torch.isnan(cn.col_reduce_plain(t, cn._MODE_GE)).any()


def test_unknown_op_and_norm_raise():
    t = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        cn.col_reduce(t, op="two")
    with pytest.raises(ValueError):
        cn.genorm(t, "two")
    with pytest.raises(ValueError):
        cn.col_reduce_plain(t, mode=7)


# ---------------------------------------------------------------------------
# ops.norms: the JAX package's XLA path vs the port (plain torch on the CPU)
# ---------------------------------------------------------------------------

NORMS = ("max", "one", "inf", "fro")


def _close(got, want, dtype=np.float64):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_genorm_and_col_norms(dtype):
    a = _sample((37, 23), dtype, seed=5)
    x, t = jnp.asarray(a), torch.from_numpy(a)
    for which in NORMS:
        _close(torch_norms.genorm(which, t), jax_norms.genorm(which, x), dtype)
    np.testing.assert_array_equal(
        torch_norms.genorm("max", t, scope="columns").numpy(),
        np.asarray(jax_norms.genorm("max", x, scope="columns")))
    with pytest.raises(Exception):
        torch_norms.genorm("one", t, scope="columns")


@pytest.mark.parametrize("shape", [(9, 9), (12, 7), (7, 12)], ids=str)
def test_trnorm(shape):
    a = _sample(shape, np.float64, seed=6)
    x, t = jnp.asarray(a), torch.from_numpy(a)
    for uplo in ("lower", "upper"):
        for diag in ("nonunit", "unit"):
            for which in NORMS:
                _close(torch_norms.trnorm(which, uplo, diag, t),
                       jax_norms.trnorm(which, uplo, diag, x))


def test_sy_he_norms_real_and_complex():
    r = np.random.default_rng(7)
    a = r.standard_normal((11, 11))
    c = a + 1j * r.standard_normal((11, 11))
    for uplo in ("lower", "upper"):
        for which in NORMS:
            _close(torch_norms.synorm(which, uplo, torch.from_numpy(a)),
                   jax_norms.synorm(which, uplo, jnp.asarray(a)))
            _close(torch_norms.henorm(which, uplo, torch.from_numpy(c)),
                   jax_norms.henorm(which, uplo, jnp.asarray(c)))


def test_band_norms():
    a = _sample((10, 12), np.float64, seed=8)
    s = _sample((10, 10), np.float64, seed=9)
    for which in NORMS:
        for kl, ku in ((0, 0), (1, 2), (3, 0)):
            _close(torch_norms.gbnorm(which, kl, ku, torch.from_numpy(a)),
                   jax_norms.gbnorm(which, kl, ku, jnp.asarray(a)))
        for uplo in ("lower", "upper"):
            _close(torch_norms.hbnorm(which, uplo, 2, torch.from_numpy(s)),
                   jax_norms.hbnorm(which, uplo, 2, jnp.asarray(s)))


def test_complex_genorm_takes_plain_path():
    r = np.random.default_rng(10)
    c = r.standard_normal((16, 12)) + 1j * r.standard_normal((16, 12))
    t = torch.from_numpy(c)
    assert not torch_norms._kernel_ok(t)
    for which in NORMS:
        _close(torch_norms.genorm(which, t), jax_norms.genorm(which, jnp.asarray(c)))


def test_kernel_route_needs_real_2d_cuda_tensor():
    """The counterpart of the JAX package's ``_pallas_ok`` (norms.py:32-38):
    CPU tensors, complex data and batches take the plain path."""
    assert not torch_norms._kernel_ok(torch.zeros((4, 4)))
    assert not torch_norms._kernel_ok(np.zeros((4, 4)))
    assert not torch_norms._kernel_ok(torch.zeros((2, 4, 4)))


def test_non_unit_column_stride_is_copied_for_the_kernel(monkeypatch):
    """The kernels need unit column stride, so a tensor bound for them is
    copied once; the plain versions (a CPU tensor) take the view as it is."""
    t = torch.from_numpy(_sample((6, 9), np.float32))
    tt = t.T
    assert tt.stride(1) != 1
    assert torch_norms._unit_col_stride(tt) is tt
    np.testing.assert_allclose(float(torch_norms.genorm("one", tt)),
                               float(torch_norms.genorm("inf", t)), rtol=1e-6)
    monkeypatch.setattr(torch_norms, "_kernel_ok", lambda A: True)
    fixed = torch_norms._unit_col_stride(tt)
    assert fixed.stride(1) == 1 and torch.equal(fixed, tt)
    assert torch_norms._unit_col_stride(t) is t


def test_real_2d_norms_take_the_kernel_dispatch_on_cpu(monkeypatch):
    """genorm / trnorm / colNorms of a real 2-D tensor reach the cuda_norms
    wrappers with the mode, unit_diag and op the card launches with, whatever
    the device; complex and batched input does not."""
    calls = []
    col, row = cn.col_reduce, cn.row_sums
    monkeypatch.setattr(cn, "col_reduce", lambda a, mode=cn._MODE_GE, unit_diag=False,
                        op="sum": calls.append(("col", mode, unit_diag, op))
                        or col(a, mode, unit_diag, op))
    monkeypatch.setattr(cn, "row_sums", lambda a, mode=cn._MODE_GE, unit_diag=False:
                        calls.append(("row", mode, unit_diag, "sum"))
                        or row(a, mode, unit_diag))
    t = torch.from_numpy(_sample((7, 5), np.float64))
    expect = {
        lambda: torch_norms.genorm("one", t): ("col", cn._MODE_GE, False, "sum"),
        lambda: torch_norms.genorm("inf", t): ("row", cn._MODE_GE, False, "sum"),
        lambda: torch_norms.genorm("max", t, scope="columns"):
            ("col", cn._MODE_GE, False, "max"),
        lambda: torch_norms.trnorm("fro", "lower", "nonunit", t):
            ("col", cn._MODE_LOWER, False, "sumsq"),
        lambda: torch_norms.trnorm("max", "upper", "unit", t):
            ("col", cn._MODE_UPPER, True, "max"),
        lambda: torch_norms.trnorm("inf", "upper", "unit", t):
            ("row", cn._MODE_UPPER, True, "sum"),
    }
    for fn, want in expect.items():
        calls.clear()
        fn()
        assert calls == [want]
    calls.clear()
    torch_norms.genorm("one", t.to(torch.complex128))
    torch_norms.genorm("one", t[None])
    assert calls == []


# ---------------------------------------------------------------------------
# the CUDA launch plan
# ---------------------------------------------------------------------------


_KEEP = {cn._MODE_GE: lambda r, c: True, cn._MODE_LOWER: lambda r, c: r >= c,
         cn._MODE_UPPER: lambda r, c: r <= c, cn._MODE_LOWER_STRICT: lambda r, c: r > c,
         cn._MODE_UPPER_STRICT: lambda r, c: r < c}


def _replay(buf: np.ndarray, offset: int, shape, lda: int, kind: str, mode: int,
            unit: bool, itemsize: int):
    """The CUDA kernels' index arithmetic (csrc/norms.cu) replayed on the host for
    op="sum": the launch plan's tiles and splits, each thread's groups of V
    columns (col) or team share of a row's V-element pieces (row), the mask as
    loop bounds, the per-element band (col) or ragged head, ragged tail and
    diagonal group (row), the unit diagonal counted as 1 in its split, and the
    in-launch fold of the splits in the kernel's order.  ``buf`` is a flat array
    holding the (m, n) matrix at ``offset`` with row stride ``lda``; the vector
    width follows from ``offset``, ``lda`` and ``itemsize`` as if ``buf`` began
    on a 16-byte boundary, and every V-wide load is asserted 16-byte aligned.
    Returns (result, reads, plan): reads[i] counts the loads of buf[i]."""
    m, n = shape
    col = kind == "col"
    dtype = {4: torch.float32, 8: torch.float64}[itemsize]
    plan = cn.kernel_plan(m, n, dtype, kind=kind,
                          aligned=cn._aligned(offset * itemsize, lda, itemsize))
    V, W = plan["vector_width"], plan["tile"]
    tiles, splits = plan["grid"]
    per = plan["split_extent"]
    kept = n if col else m
    reads = np.zeros(buf.size, np.int64)
    part = np.zeros((splits, kept))

    pending = {}                 # width -> flat indices of the loads' first elements

    def load(first, width, s):
        """Loads of ``width`` elements from flat indices ``first`` by split s."""
        pending.setdefault(width, []).append(np.asarray(first, np.int64).ravel())

    def flush(s):
        for width, firsts in pending.items():
            first = np.concatenate(firsts)
            if width > 1:
                assert (first * itemsize % 16 == 0).all()
            flat = (first[:, None] + np.arange(width)).ravel()
            np.add.at(reads, flat, 1)
            rel = flat - offset
            np.add.at(part[s], rel % lda if col else rel // lda, np.abs(buf[flat]))
        pending.clear()

    def strided(lo, hi, first_ranks, stride):
        """The indices lo + rank, lo + rank + stride, ... < hi of every rank."""
        ks = (lo + np.asarray(first_ranks))[:, None] + stride * np.arange(
            max(0, -(-(hi - lo) // stride)))
        return ks[ks < hi]

    for s in range(splits):
        if col:
            r0, r1 = s * per, min(m, s * per + per)
            below = mode in (cn._MODE_GE, cn._MODE_UPPER, cn._MODE_UPPER_STRICT)
            above = mode in (cn._MODE_GE, cn._MODE_LOWER, cn._MODE_LOWER_STRICT)
            for c0 in range(0, tiles * W, V):          # one thread's column group
                if c0 >= n:
                    continue
                nv = min(V, n - c0)
                for lo, hi in ((r0, min(r1, c0) if below else r0),
                               (max(r0, c0 + V), r1 if above else r0)):
                    rows = strided(lo, hi, range(cn._WARPS), cn._WARPS)
                    first = offset + rows * lda + c0
                    if nv == V:
                        load(first, V, s)
                    else:
                        for j in range(nv):
                            load(first + j, 1, s)
                b0, b1 = max(r0, c0), min(r1, c0 + V)
                for r in range(b0, min(b1, b0 + cn._WARPS)):   # one band row a warp
                    for c in range(c0, c0 + nv):
                        if _KEEP[mode](r, c) and not (unit and r == c):
                            load(offset + r * lda + c, 1, s)
                for c in range(c0, c0 + nv):
                    if unit and r0 <= c < r1:
                        part[s, c] += 1
            flush(s)
        else:
            c_lo, c_hi = s * per, min(n, s * per + per)
            team = 32 * plan["warps_per_row"]
            for r in range(m):
                lo, hi = c_lo, c_hi
                if mode == cn._MODE_LOWER:
                    hi = min(hi, r + 1)
                if mode == cn._MODE_LOWER_STRICT:
                    hi = min(hi, r)
                if mode == cn._MODE_UPPER:
                    lo = max(lo, r)
                if mode == cn._MODE_UPPER_STRICT:
                    lo = max(lo, r + 1)
                A = min(-(-lo // V) * V, hi)
                B = max(hi // V * V, A)
                g = r // V * V
                hole = A <= g and g + V <= B
                for s0, s1 in ((A, g if hole else B), (g + V if hole else B, B)):
                    groups = strided(0, (s1 - s0) // V, range(team), team)
                    load(offset + r * lda + s0 + groups * V, V, s)
                for p0, p1 in ((lo, A), (B, hi), (g, g + V if hole else g)):
                    cs = strided(p0, p1, range(team), team)
                    load(offset + r * lda + cs[~(unit & (cs == r))], 1, s)
                if unit and c_lo <= r < c_hi:
                    part[s, r] += 1
        flush(s)
    # the fold: kThreads / W chunks of consecutive splits, each in split order, then
    # the chunks in a pairwise tree
    K = cn._THREADS // W
    bounds = [(k * splits // K, (k + 1) * splits // K) for k in range(K)]
    assert [i for lo, hi in bounds for i in range(lo, hi)] == list(range(splits))
    chunks = []
    for lo, hi in bounds:
        acc = np.zeros(kept)
        for i in range(lo, hi):
            acc = acc + part[i]
        chunks.append(acc)
    while len(chunks) > 1:
        half = len(chunks) // 2
        chunks = [chunks[k] + chunks[k + half] for k in range(half)]
    return (part[0] if splits == 1 else chunks[0]), reads, plan


def _check_replay(parent_shape, rows, cols, kind: str):
    """Replay both kernels' loops on ``parent[rows, cols]`` for f32 and f64 widths,
    every mask mode and unit_diag: every kept element of the view is loaded
    exactly once; masked-out elements, a unit diagonal and everything outside
    the view never; the result is the plain version's."""
    parent = _sample(parent_shape, np.float64, seed=31)
    view = parent[rows, cols]
    m, n = view.shape
    lda = parent_shape[1]
    offset = (rows.start or 0) * lda + (cols.start or 0)
    r, c = np.indices((m, n))
    keep = {cn._MODE_GE: np.ones((m, n), bool), cn._MODE_LOWER: r >= c,
            cn._MODE_UPPER: r <= c, cn._MODE_LOWER_STRICT: r > c,
            cn._MODE_UPPER_STRICT: r < c}
    widths = set()
    for itemsize in (4, 8):
        for mode in MODES:
            for unit in (False, True):
                got, reads, plan = _replay(parent.ravel(), offset, (m, n), lda, kind,
                                           mode, unit, itemsize)
                want = np.zeros(parent.size, np.int64)
                want.reshape(parent_shape)[rows, cols] = keep[mode] & ~((r == c) & unit)
                np.testing.assert_array_equal(reads, want)
                plain = (cn.col_reduce_plain if kind == "col" else cn.row_sums_plain)(
                    torch.from_numpy(view), mode, unit)
                np.testing.assert_allclose(got, plain.numpy(), rtol=1e-12)
        widths.add(plan["vector_width"])
        assert plan["single_pass"] and plan["launches_per_call"] == 1
        assert plan["bytes_in"] == m * n * itemsize    # no padding is read
        assert plan["out_shape"] == (n if kind == "col" else m,)
        assert plan["fold"] == ("last_block" if plan["grid"][1] > 1 else "none")
    return widths


@pytest.mark.parametrize("kind", ["col", "row"])
@pytest.mark.parametrize("shape", SHAPES + [(700, 40), (40, 700), (1, 1)], ids=str)
def test_kernel_index_arithmetic_reads_each_kept_element_once(shape, kind):
    """Replaying the kernels' loops on each shape, contiguous (16-byte loads
    where the row pitch allows, else 1-element loads) and inside a parent
    whose row pitch is padded to 16 bytes (16-byte loads, a ragged right edge
    where n % V != 0): every kept element is loaded exactly once, masked-out
    elements, a unit diagonal and the padding never, and the result is the
    plain version's, for f32 and f64 widths."""
    m, n = shape
    _check_replay(shape, slice(0, m), slice(0, n), kind)
    padded = _check_replay((m, -(-n // 4) * 4), slice(0, m), slice(0, n), kind)
    assert padded == {2, 4}                            # double2 and float4 loads


@pytest.mark.parametrize("kind", ["col", "row"])
@pytest.mark.parametrize("view", [
    ("unaligned", (60, 53), slice(2, 60), slice(1, 30)),
    ("odd-width", (45, 40), slice(0, 45), slice(0, 37)),
    ("wide-unaligned", (20, 1100), slice(0, 20), slice(3, 1003)),
    ("tall-odd-width", (600, 28), slice(0, 600), slice(0, 27)),
], ids=lambda v: v[0])
def test_kernel_index_arithmetic_on_strided_views(view, kind):
    """Views whose row stride exceeds their width: an unaligned base or pitch
    takes the 1-element instantiation, an aligned one the 16-byte loads with
    a ragged edge; nothing past the view's width is read (the replay counts
    every load in the parent), and several splits fold in the kernel's order."""
    _, parent_shape, rows, cols = view
    widths = _check_replay(parent_shape, rows, cols, kind)
    assert widths == ({1} if view[0].endswith("unaligned") else {2, 4})


def test_vector_width_follows_alignment():
    """The wrappers choose 16-byte loads only where the base and the row pitch
    of the tensor are 16-byte aligned (``is_aligned``), and kernel_plan reports
    the choice."""
    t = torch.zeros((16, 40), dtype=torch.float32)
    assert cn.is_aligned(t) and not cn.is_aligned(t[:, 1:])
    assert not cn.is_aligned(torch.zeros((5, 3), dtype=torch.float32))
    assert cn.is_aligned(torch.zeros((5, 2), dtype=torch.float64))
    assert not cn.is_aligned(torch.zeros((5, 3), dtype=torch.float64))
    assert [cn._vec_width(4, True), cn._vec_width(8, True), cn._vec_width(4, False)] == [4, 2, 1]
    for kind in ("col", "row"):
        assert cn.kernel_plan(64, 64, torch.float32, kind)["vector_width"] == 4
        assert cn.kernel_plan(64, 64, torch.float64, kind)["vector_width"] == 2
        assert cn.kernel_plan(64, 64, torch.float32, kind, aligned=False)["vector_width"] == 1


def test_plan_at_bench_shape():
    """16384^2 f32, the size the main path runs: one pass and one launch with
    16-byte loads; a col_reduce warp reads 512 contiguous bytes of a row
    (128 columns) and folds its 33 splits inside the launch; a row_sums row
    is one block's 8 warps; and the bytes bound of an H100 SXM (about
    0.32 ms)."""
    for kind in ("col", "row"):
        plan = cn.kernel_plan(16384, 16384, torch.float32, kind=kind)
        assert plan["single_pass"]
        assert plan["bytes_in"] == 16384 * 16384 * 4
        assert 0.31 < plan["bound_ms"] < 0.33
        assert plan["block"] == (256,)
        assert plan["vector_width"] == 4 and plan["launches_per_call"] == 1
    col = cn.kernel_plan(16384, 16384, kind="col")
    assert col["tile"] == 128 and col["grid"] == (128, 33) and col["fold"] == "last_block"
    row = cn.kernel_plan(16384, 16384, kind="row")
    assert row["warps_per_row"] == 8 and row["grid"] == (16384, 1) and row["fold"] == "none"
    assert row["bytes_out"] == 16384 * 4            # the result, no scratch


@pytest.mark.parametrize("shape,kind", [((131072, 64), "col"), ((64, 70000), "row")],
                         ids=["tall-col", "wide-row"])
def test_plan_splits_the_reduced_dimension_to_fill_the_card(shape, kind):
    """Tall-skinny (col) and short-wide (row) inputs split the reduced
    dimension across gridDim.y so the blocks can fill 132 SMs, and the last
    block of each tile folds the splits inside the one launch (scratch: the
    (splits, kept) partial and a counter per tile)."""
    m, n = shape
    plan = cn.kernel_plan(m, n, torch.float32, kind=kind)
    tiles, splits = plan["grid"]
    assert splits > 1 and tiles * splits >= cn.H100_SMS
    assert plan["single_pass"]
    assert plan["fold"] == "last_block" and plan["launches_per_call"] == 1
    kept = n if kind == "col" else m
    assert plan["bytes_out"] == kept * 4 + splits * kept * 4 + tiles * 4
    f64 = cn.kernel_plan(m, n, torch.float64, kind=kind)
    assert f64["bytes_in"] == 2 * plan["bytes_in"]
