"""Core layer of the PyTorch port (slate_tpu_torch) against the JAX package:
types and Options, exceptions, grid maps, the matrix wrappers, carrying a
wrapper's state across (``from_reference_state``), and the robust/trace/obs
basics.  Mirrors the relevant part of tests/test_core.py; exact comparisons
(no arithmetic beyond copies and masks)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import slate_tpu as sj
import slate_tpu_torch as st
from slate_tpu.core import func as jfunc
from slate_tpu_torch.core import func as tfunc
from slate_tpu_torch.core.matrix import from_reference_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, slate_tpu_torch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib')) or m == 'slate_tpu' or m.startswith('slate_tpu.'))\n"
            "print(','.join(bad))\n"
            "assert 'slate_tpu_torch.ops.cuda_norms' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_public_names_match_the_jax_package():
    for name in st.__all__ if hasattr(st, "__all__") else [
            n for n in dir(st) if not n.startswith("_")]:
        if name in ("obs", "robust", "trace", "core", "blas", "linalg", "ops",
                    "utils"):
            continue
        assert hasattr(sj, name), name


# ---------------------------------------------------------------------------
# types, Options, exceptions, grid maps
# ---------------------------------------------------------------------------


def test_enums_round_trip():
    assert st.Op.from_string("t") == st.Op.Trans
    assert st.Uplo.from_string("Lower") == st.Uplo.Lower
    assert st.Norm.from_string("1") == st.Norm.One
    assert str(st.MethodLU.CALU) == "calu"
    for enum_name in ("Op", "Uplo", "Diag", "Norm", "NormScope", "Target", "Side",
                      "Layout", "GridOrder", "TileKind", "MethodLU", "MethodGemm"):
        assert ([m.value for m in getattr(st, enum_name)]
                == [m.value for m in getattr(sj, enum_name)]), enum_name


def test_options_make_and_cache_key_match():
    d = {"block_size": 64, "method_lu": "calu", "target": "tiled",
         "exact_info": True, "precision": "float32"}
    ot, oj = st.Options.make(d), sj.Options.make(d)
    assert ot.block_size == 64 and ot.method_lu == st.MethodLU.CALU
    assert ot.cache_key() == oj.cache_key()
    assert st.Options().cache_key() == sj.Options().cache_key()
    assert (st.Options(precision=torch.float32).cache_key()
            == sj.Options(precision=np.float32).cache_key())
    with pytest.raises(TypeError):
        st.Options.make({"no_such_option": 1})
    with pytest.raises(TypeError):
        st.Options.make(3)


def test_exception_taxonomy_matches():
    for name in ("SlateError", "NumericalError", "SingularMatrixError",
                 "ConvergenceError", "QueueOverloadError", "DeadlineExceededError"):
        t, j = getattr(st, name), getattr(sj, name)
        assert [c.__name__ for c in t.__mro__] == [c.__name__ for c in j.__mro__]
    e = st.SingularMatrixError("x", info=3)
    assert e.info == 3 and isinstance(e, RuntimeError)


def test_grid_maps_match():
    for order in ("col", "row"):
        ft, fj = tfunc.process_2d_grid(order, 2, 3), jfunc.process_2d_grid(order, 2, 3)
        assert [ft(i, j) for i in range(4) for j in range(5)] == \
            [fj(i, j) for i in range(4) for j in range(5)]
        ok_t, order_t, *pq_t = tfunc.is_2d_cyclic_grid(8, 8, ft)
        ok_j, order_j, *pq_j = jfunc.is_2d_cyclic_grid(8, 8, fj)
        assert (ok_t, str(order_t), pq_t) == (ok_j, str(order_j), pq_j)
    assert [tfunc.grid_size(n) for n in (1, 6, 8, 9)] == \
        [jfunc.grid_size(n) for n in (1, 6, 8, 9)]
    mb = tfunc.uniform_blocksize(10, 4)
    assert [mb(i) for i in range(3)] == [4, 4, 2]
    assert tfunc.num_tiles(0, 4) == 0


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def test_entry_points_default_to_cuda():
    """New data goes on cuda unless a device is named; without CUDA that
    raises instead of falling back to the CPU.  Tensors keep their device."""
    a = np.arange(12.0).reshape(3, 4)
    if not torch.cuda.is_available():
        with pytest.raises(st.SlateError, match="CUDA"):
            st.Matrix.from_array(a)
        with pytest.raises(st.SlateError, match="CUDA"):
            st.Matrix(4, 4, nb=2)
        with pytest.raises(st.SlateError, match="CUDA"):
            st.norm1est(lambda x: x, lambda x: x, 4, torch.float64)
    else:
        assert st.norm1est(lambda x: x, lambda x: x, 4, torch.float64).is_cuda
    A = st.Matrix.from_array(torch.from_numpy(a))
    assert A.device.type == "cpu"
    assert st.Matrix.from_array(a, device="cpu").device.type == "cpu"
    assert st.Matrix(4, 4, nb=2, device="cpu").dtype == torch.float32


def test_matrix_ctor_and_tiles():
    A = st.Matrix(10, 7, nb=4, dtype=torch.float64, device="cpu")
    assert A.shape == (10, 7) and A.mt == 3 and A.nt == 2
    assert A.tileMb(2) == 2 and A.tileNb(1) == 3
    a = np.arange(70, dtype=np.float64).reshape(10, 7)
    A = st.Matrix.from_array(a, nb=4, device="cpu")
    np.testing.assert_array_equal(_np(A.tile(1, 1)), a[4:8, 4:7])
    np.testing.assert_array_equal(_np(A(2, 0)), a[8:, :4])
    np.testing.assert_array_equal(_np(A.array), a)


def test_views_share_storage_and_write_back():
    a = np.arange(64, dtype=np.float64).reshape(8, 8)
    t = torch.from_numpy(a.copy())
    A = st.Matrix.from_array(t, nb=4)
    S = A.sub(1, 1, 0, 1)
    assert S.shape == (4, 8)
    np.testing.assert_array_equal(_np(S.array), a[4:8, :])
    S.set_array(torch.zeros((4, 8), dtype=torch.float64))
    np.testing.assert_array_equal(_np(A.array)[4:8, :], 0)
    np.testing.assert_array_equal(_np(A.array)[:4, :], a[:4, :])
    # copy on write: the caller's tensor is untouched
    np.testing.assert_array_equal(t.numpy(), a)
    assert A.slice(1, 3, 2, 6).shape == (3, 5)
    with pytest.raises(st.SlateError):
        A.slice(0, 100, 0, 3)
    # write_back into a wrapper returns the value; a raw tensor passes through
    v = torch.ones((8, 8), dtype=torch.float64)
    assert st.core.write_back(A, v) is v and torch.equal(A.array, v)
    assert st.core.write_back(t, v) is v
    np.testing.assert_array_equal(t.numpy(), a)


def test_transpose_and_conj_transpose_views():
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    A = st.Matrix.from_array(a, nb=2, device="cpu")
    At = A.T
    assert At.shape == (4, 3) and At.op == st.Op.Trans and At.storage is A.storage
    np.testing.assert_array_equal(_np(At.array), a.T)
    np.testing.assert_array_equal(_np(At.T.array), a)
    np.testing.assert_array_equal(_np(At.sub(0, 1, 0, 0).array), a.T[:4, :2])
    At.set_tile(1, 0, torch.zeros((2, 2), dtype=torch.float64))
    np.testing.assert_array_equal(_np(A.array)[:2, 2:4], 0)
    c = (np.arange(9) + 1j * np.arange(9)).reshape(3, 3)
    np.testing.assert_array_equal(_np(st.Matrix.from_array(c, nb=2, device="cpu").H.array),
                                  c.conj().T)


def test_full_array_and_masks_match_jax():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    s = rng.standard_normal((5, 5))
    for uplo in ("lower", "upper"):
        np.testing.assert_array_equal(
            _np(st.HermitianMatrix.from_array(uplo, h, nb=2, device="cpu").full_array()),
            _np(sj.HermitianMatrix.from_array(uplo, h, nb=2).full_array()))
        np.testing.assert_array_equal(
            _np(st.SymmetricMatrix.from_array(uplo, s, nb=2, device="cpu").full_array()),
            _np(sj.SymmetricMatrix.from_array(uplo, s, nb=2).full_array()))
        for diag in ("unit", "nonunit"):
            np.testing.assert_array_equal(
                _np(st.TriangularMatrix.from_array(uplo, s, nb=2, diag=diag,
                                                   device="cpu").masked_array()),
                _np(sj.TriangularMatrix.from_array(uplo, s, nb=2,
                                                   diag=diag).masked_array()))
    Bt = st.BandMatrix(6, 6, kl=1, ku=2, nb=2, dtype=torch.float64, device="cpu")
    Bj = sj.BandMatrix(6, 6, kl=1, ku=2, nb=2)
    np.testing.assert_array_equal(_np(Bt.band_mask()), _np(Bj.band_mask()))
    np.testing.assert_array_equal(_np(Bt.T.band_mask()), _np(Bj.T.band_mask()))
    T = st.TriangularBandMatrix("lower", 6, 2, 2, dtype=torch.float64, device="cpu")
    assert T.T.kd == 2 and T.T.uplo == st.Uplo.Upper


def test_tile_rank_and_owner_map():
    A = st.Matrix(16, 16, nb=4, p=2, q=2, device="cpu")
    J = sj.Matrix(16, 16, nb=4, p=2, q=2)
    np.testing.assert_array_equal(A.owner_map(), J.owner_map())
    assert A.T.tileRank(0, 1) == J.T.tileRank(0, 1) == 1
    np.testing.assert_array_equal(A.local_tiles(3), J.local_tiles(3))
    a = np.zeros((10, 12), np.float32)
    C = st.Matrix.from_array(a, tile_mb=[2, 3, 1, 4], tile_nb=[5, 4, 3], p=2, q=2,
                             tile_rank=lambda i, j: (i + j) % 4, device="cpu")
    D = sj.Matrix.from_array(a, tile_mb=[2, 3, 1, 4], tile_nb=[5, 4, 3], p=2, q=2,
                             tile_rank=lambda i, j: (i + j) % 4)
    np.testing.assert_array_equal(C.owner_map(), D.owner_map())
    assert [C.sub(1, 2, 0, 1).tileMb(i) for i in range(2)] == [3, 1]
    with pytest.raises(st.SlateError):
        A.slice(2, 6, 0, 7).tileRank(0, 0)


def test_multi_device_grid_is_refused():
    class Grid:
        size = 4

    with pytest.raises(st.SlateError, match="queue A item 15"):
        st.Matrix.from_array(torch.zeros((4, 4)), grid=Grid())


def _state(w) -> dict:
    """A JAX-package wrapper's state as a plain dict (test-side conversion)."""
    s = w.storage
    d = {"class": type(w).__name__, "array": np.asarray(s.array), "mb": s.mb,
         "nb": s.nb, "op": str(w.op), "ioffset": w.ioffset, "joffset": w.joffset,
         "m": w._m, "n": w._n}
    for key in ("uplo", "diag"):
        if hasattr(w, key):
            d[key] = str(getattr(w, key))
    for key in ("_kl", "_ku", "kd"):
        if hasattr(w, key):
            d[key.lstrip("_")] = getattr(w, key)
    return d


def test_from_reference_state_rebuilds_the_counterpart():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((9, 9))
    wrappers = [
        sj.Matrix.from_array(a, nb=4),
        sj.Matrix.from_array(a, nb=4).T,
        sj.Matrix.from_array(a, nb=4).sub(1, 2, 0, 1),
        sj.HermitianMatrix.from_array("lower", a, nb=3),
        sj.TriangularMatrix.from_array("upper", a, nb=3, diag="unit"),
        sj.SymmetricMatrix.from_array("upper", a, nb=3),
        sj.TrapezoidMatrix.from_array("lower", a[:, :6], nb=3),
    ]
    band = sj.BandMatrix(9, 9, kl=1, ku=2, nb=3)
    band.set_array(a)
    hb = sj.HermitianBandMatrix("lower", 9, 2, 3)
    hb.set_array(a)
    wrappers += [band, hb]
    for w in wrappers:
        t = from_reference_state(_state(w), device="cpu")
        assert type(t).__name__ == type(w).__name__
        assert (t.shape, t.mb, t.nb, t.mt, t.nt) == (w.shape, w.mb, w.nb, w.mt, w.nt)
        assert (str(t.op), str(t.uplo), str(t.diag)) == (str(w.op), str(w.uplo),
                                                         str(w.diag))
        np.testing.assert_array_equal(_np(t.array), _np(w.array))
        # the norm a user would take of it agrees too
        for which in ("one", "fro"):
            np.testing.assert_allclose(float(st.norm(which, t)),
                                       float(sj.norm(which, w)), rtol=1e-13)
        if hasattr(w, "kl"):
            assert (t.kl, t.ku) == (w.kl, w.ku)
    with pytest.raises(st.SlateError):
        from_reference_state({"class": "NoSuchMatrix", "array": a})


# ---------------------------------------------------------------------------
# robust, trace, obs
# ---------------------------------------------------------------------------


def test_info_kernels_match():
    from slate_tpu.robust import report as jrep
    from slate_tpu_torch.robust import report as trep
    for bad in ([False] * 4, [False, True, False, True], [True]):
        assert int(trep.first_bad_index(torch.tensor(bad))) == \
            int(jrep.first_bad_index(np.array(bad)))
    batch = np.array([[False, False], [False, True], [True, True]])
    np.testing.assert_array_equal(
        trep.first_bad_index_batched(torch.from_numpy(batch)).numpy(),
        np.asarray(jrep.first_bad_index_batched(batch)))
    assert int(st.reduce_info(0, torch.tensor(3), 2)) == int(sj.reduce_info(0, 3, 2))


@pytest.mark.parametrize("kind", ["nan_tile", "inf_tile", "zero_pivot", "shard_fail"])
def test_fault_injection_matches(kind):
    a = np.arange(36.0).reshape(6, 6) + 1
    spec = dict(driver="potrf", kind=kind, tile=(1, 0), nb=2, index=2, world=3)
    with sj.FaultPlan([sj.FaultSpec(**spec)]) as pj:
        from slate_tpu.robust import inject as jinject
        want = np.asarray(jinject("potrf", a, point=sj.FaultSpec(**spec).point))
    t = torch.from_numpy(a.copy())
    with st.FaultPlan([st.FaultSpec(**spec)]) as pt:
        from slate_tpu_torch.robust import inject as tinject
        got = tinject("potrf", t, point=st.FaultSpec(**spec).point)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pt.fired == pj.fired
    np.testing.assert_array_equal(t.numpy(), a)    # out of place


def test_fault_plan_drives_potrf_info():
    a = np.eye(8) * 4.0
    plan = [("potrf", "zero_pivot", 0, 5)]
    with sj.FaultPlan([sj.FaultSpec(d, k, call_index=c, index=i) for d, k, c, i in plan]):
        _, ij = sj.potrf(a, {"exact_info": True})
    with st.FaultPlan([st.FaultSpec(d, k, call_index=c, index=i) for d, k, c, i in plan]):
        _, it = st.potrf(torch.from_numpy(a), {"exact_info": True})
    assert int(it) == int(ij) == 6


def test_spans_and_trace():
    """Drivers emit ``slate_spans_total`` with the JAX package's labels
    (routine, dtype, shape_bucket; nested calls add ``parent``)."""
    a, b = np.eye(4) * 2.0, np.ones((4, 1))
    st.obs.reset()
    st.posv(torch.from_numpy(a), torch.from_numpy(b))
    sj.posv(a, b)
    port = [dict(k) for k in st.obs.REGISTRY.get("slate_spans_total").series()]
    ref = [dict(k) for k in sj.obs.REGISTRY.get("slate_spans_total").series()]
    for labels in port:
        assert labels in ref, labels
    assert {"routine": "posv", "dtype": "float64", "shape_bucket": "<=4"} in port
    assert {"routine": "potrf", "dtype": "float64", "shape_bucket": "<=4",
            "parent": "posv"} in port
    st.obs.validate_metrics(st.obs.metrics_doc())
    st.trace.on()
    try:
        with st.trace.trace_block("outer", n=3):
            st.trace.trace_event("mark", x=1)
        path = st.trace.finish(os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                            f"torch_trace_{os.getpid()}.json"))
    finally:
        st.trace.off()
    try:
        import json
        with open(path) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]]
        assert names == ["mark", "outer"]
        assert st.trace.finish() is None       # idempotent
    finally:
        os.remove(path)
