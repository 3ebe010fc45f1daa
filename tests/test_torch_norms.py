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


def _replay(a: np.ndarray, kind: str, mode: int, unit: bool):
    """The CUDA kernels' index arithmetic (csrc/norms.cu: the mask turned into
    loop bounds, the unit diagonal skipped and counted as 1, the lanes and
    splits of the launch plan) replayed on the host for op="sum".  Returns
    (result, reads), reads[i, j] counting the loads of a[i, j]."""
    m, n = a.shape
    col = kind == "col"
    plan = cn.kernel_plan(m, n, kind=kind)
    splits, per = plan["grid"][1], plan["split_extent"]
    stride = cn._ROW_LANES if col else 32
    kept = n if col else m
    reads = np.zeros((m, n), np.int64)
    part = np.zeros((splits, kept))
    for s in range(splits):
        k0, k1 = s * per, min(s * per + per, m if col else n)
        for line in range(kept):
            lo, hi = k0, k1
            # col: line is column c, k a row; row: line is row r, k a column
            low_k = {cn._MODE_LOWER: line, cn._MODE_LOWER_STRICT: line + 1}
            high_k = {cn._MODE_UPPER: line + 1, cn._MODE_UPPER_STRICT: line}
            if not col:
                low_k = {cn._MODE_UPPER: line, cn._MODE_UPPER_STRICT: line + 1}
                high_k = {cn._MODE_LOWER: line + 1, cn._MODE_LOWER_STRICT: line}
            lo = max(lo, low_k.get(mode, lo))
            hi = min(hi, high_k.get(mode, hi))
            diag = line if unit and k0 <= line < k1 else -1
            base = k0 + np.arange(stride)                 # one entry per lane
            own = (diag >= base) & ((diag - base) % stride == 0)
            segs = ((np.full(stride, lo), np.where(own, min(hi, diag), hi)),
                    (np.where(own, max(lo, diag + 1), hi), np.full(stride, hi)))
            total = float(own.sum())
            for b, e in segs:
                first = np.where(b <= base, base,
                                 base + -(-(b - base) // stride) * stride)
                ks = first[:, None] + stride * np.arange(-(-per // stride) + 1)
                ks = ks[ks < e[:, None]]
                idx = (ks, line) if col else (line, ks)
                np.add.at(reads, idx, 1)
                total += np.abs(a[idx]).sum()
            part[s, line] = total
    return part.sum(axis=0), reads


@pytest.mark.parametrize("kind", ["col", "row"])
@pytest.mark.parametrize("shape", SHAPES + [(700, 40), (40, 700), (1, 1)], ids=str)
def test_kernel_index_arithmetic_reads_each_kept_element_once(shape, kind):
    """Replaying the kernels' loops: every kept element is loaded exactly
    once, masked-out elements and a unit diagonal never, and the result is
    the plain version's."""
    m, n = shape
    plan = cn.kernel_plan(m, n, torch.float32, kind=kind)
    assert plan["single_pass"]
    assert plan["bytes_in"] == m * n * 4          # no padding is read
    assert plan["out_shape"] == (plan["grid"][1], n if kind == "col" else m)
    a = _sample(shape, np.float64, seed=31)
    r, c = np.indices(shape)
    keep = {cn._MODE_GE: np.ones(shape, bool), cn._MODE_LOWER: r >= c,
            cn._MODE_UPPER: r <= c, cn._MODE_LOWER_STRICT: r > c,
            cn._MODE_UPPER_STRICT: r < c}
    for mode in MODES:
        for unit in (False, True):
            got, reads = _replay(a, kind, mode, unit)
            want_reads = keep[mode] & ~((r == c) & unit)
            np.testing.assert_array_equal(reads, want_reads.astype(np.int64))
            plain = (cn.col_reduce_plain if kind == "col" else cn.row_sums_plain)(
                torch.from_numpy(a), mode, unit)
            np.testing.assert_allclose(got, plain.numpy(), rtol=1e-12)


def test_plan_at_bench_shape():
    """16384^2 f32, the size the main path runs: one pass, coalesced blocks,
    and the bytes bound of an H100 SXM (about 0.32 ms)."""
    for kind in ("col", "row"):
        plan = cn.kernel_plan(16384, 16384, torch.float32, kind=kind)
        assert plan["single_pass"]
        assert plan["bytes_in"] == 16384 * 16384 * 4
        assert 0.31 < plan["bound_ms"] < 0.33
        assert int(np.prod(plan["block"])) == 256
    assert cn.kernel_plan(16384, 16384, kind="col")["block"] == (32, 8)


@pytest.mark.parametrize("shape,kind", [((131072, 64), "col"), ((64, 70000), "row")],
                         ids=["tall-col", "wide-row"])
def test_plan_splits_the_reduced_dimension_to_fill_the_card(shape, kind):
    """Tall-skinny (col) and short-wide (row) inputs split the reduced
    dimension across gridDim.y so the blocks can fill 132 SMs."""
    m, n = shape
    plan = cn.kernel_plan(m, n, torch.float32, kind=kind)
    tiles, splits = plan["grid"]
    assert splits > 1 and tiles * splits >= cn.H100_SMS
    assert plan["single_pass"]
    assert plan["bytes_out"] == splits * (n if kind == "col" else m) * 4
    f64 = cn.kernel_plan(m, n, torch.float64, kind=kind)
    assert f64["bytes_in"] == 2 * plan["bytes_in"]
