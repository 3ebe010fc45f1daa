"""The port's native host runtime (``slate_tpu_torch.native``, ctypes over
``native/slate_rt.cpp``) against its Python versions and the JAX package's
``slate_tpu.native``: mirrors ``tests/test_native.py``, then the port's own
rules — the build writes only under its build directory, a failed build or
load raises instead of falling back, and every exported symbol is declared.

The JAX package's maps are read through its Python versions unless its
library is already loaded in this process, so these tests never build or
load anything under ``native/``."""

import ctypes
import json
import os
import re

import numpy as np
import pytest

import slate_tpu_torch
from slate_tpu_torch import native
from slate_tpu_torch.core import grid as grid_funcs
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.core.types import GridOrder
from slate_tpu_torch.utils import trace

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "native")
BACKENDS = ["native", "python"]


@pytest.fixture(params=BACKENDS)
def backend(request):
    """Each test once on the compiled library and once on the Python versions."""
    if request.param == "python":
        with native.use_python():
            assert native.backend() == "python"
            yield "python"
    else:
        assert native.backend() == "native"
        yield "native"


@pytest.fixture
def jnative(monkeypatch):
    """The JAX package's native module, held to what it has loaded already:
    its library if this process loaded it, else its Python versions."""
    from slate_tpu import native as jn

    monkeypatch.setattr(jn, "_load", lambda: jn._lib)
    return jn


def _listing(path):
    return {f: os.stat(os.path.join(path, f)).st_mtime_ns for f in os.listdir(path)}


class TestOwnerMap:
    def test_matches_lambda_col(self, backend):
        om = native.owner_map(7, 5, 2, 3, GridOrder.Col)
        fn = grid_funcs.process_2d_grid(GridOrder.Col, 2, 3)
        assert om.dtype == np.int32 and om.shape == (7, 5)
        assert all(om[i, j] == fn(i, j) for i in range(7) for j in range(5))

    def test_matches_lambda_row(self, backend):
        om = native.owner_map(6, 6, 3, 2, GridOrder.Row)
        fn = grid_funcs.process_2d_grid(GridOrder.Row, 3, 2)
        assert all(om[i, j] == fn(i, j) for i in range(6) for j in range(6))

    def test_python_versions_equivalent(self):
        args = [(9, 11, 2, 2, GridOrder.Col), (9, 11, 3, 2, GridOrder.Row),
                (0, 4, 2, 2, GridOrder.Col), (1, 1, 5, 7, GridOrder.Row)]
        got = [native.owner_map(*a) for a in args]
        tiles = native.local_tiles(9, 11, 3, 2, 4, GridOrder.Row)
        assert native.backend() == "native"
        with native.use_python():
            assert native.backend() == "python"
            for a, om in zip(args, got):
                np.testing.assert_array_equal(om, native.owner_map(*a))
            np.testing.assert_array_equal(
                tiles, native.local_tiles(9, 11, 3, 2, 4, GridOrder.Row))
        assert native.backend() == "native"

    def test_local_tiles_partition(self, backend):
        mt, nt, p, q = 8, 9, 2, 3
        seen = set()
        for rank in range(p * q):
            tiles = native.local_tiles(mt, nt, p, q, rank)
            assert tiles.dtype == np.int64 and tiles.shape[1] == 2
            for (i, j) in map(tuple, tiles):
                assert (i, j) not in seen
                seen.add((i, j))
        assert len(seen) == mt * nt     # every tile owned exactly once
        assert native.local_tiles(mt, nt, p, q, p * q).shape == (0, 2)

    def test_redist_plan(self, backend):
        src, dst, moved = native.redist_plan(6, 6, (2, 2), (3, 2))
        assert src.shape == dst.shape == (6, 6)
        assert moved == int(np.count_nonzero(src != dst))
        # same grid -> nothing moves
        _, _, moved0 = native.redist_plan(6, 6, (2, 2), (2, 2))
        assert moved0 == 0


@pytest.mark.parametrize("mt,nt,p,q", [(7, 5, 2, 3), (16, 12, 4, 2), (3, 9, 1, 4),
                                       (0, 5, 2, 2)])
def test_maps_match_the_jax_package(backend, jnative, mt, nt, p, q):
    for order in ("col", "row"):
        np.testing.assert_array_equal(native.owner_map(mt, nt, p, q, order),
                                      jnative.owner_map(mt, nt, p, q, order))
        for rank in (0, p * q - 1, p * q):
            np.testing.assert_array_equal(native.local_tiles(mt, nt, p, q, rank, order),
                                          jnative.local_tiles(mt, nt, p, q, rank, order))
        got = native.redist_plan(mt, nt, (p, q), (q, p), order, "col")
        ref = jnative.redist_plan(mt, nt, (p, q), (q, p), order, "col")
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]


class TestMemoryPool:
    def test_alloc_free_cycle(self, backend):
        pool = native.MemoryPool(block_bytes=1 << 20, nblocks=4)
        assert pool.backend == backend
        ids = [pool.alloc() for _ in range(4)]
        assert sorted(ids) == [0, 1, 2, 3]
        assert pool.in_use == 4 and pool.capacity == 4 and pool.peak == 4
        assert pool.alloc() == -1             # exhausted
        assert pool.free(ids[0])
        assert pool.in_use == 3
        assert not pool.free(ids[0])          # double free detected
        assert pool.alloc() == ids[0]         # block recycled
        assert pool.peak == 4
        pool.close()
        with pytest.raises(SlateError, match="closed"):
            pool.alloc()
        pool.close()                          # idempotent

    def test_bad_id_rejected(self, backend):
        pool = native.MemoryPool(64, 2)
        assert not pool.free(99)
        assert not pool.free(-1)
        assert not pool.free(2**70)
        with pytest.raises(SlateError):
            native.MemoryPool(64, -1)


class TestNativeTrace:
    def test_capture_and_dump(self, tmp_path):
        native.trace_clear()
        native.trace_enable(True)
        assert native.trace_begin("outer")
        assert native.trace_begin('in"ner\n')
        native.trace_end()
        native.trace_end()
        native.trace_enable(False)
        assert not native.trace_begin("disarmed")   # nothing opened, no end owed
        assert native.trace_count() == 2
        path = str(tmp_path / "trace.json")
        assert native.trace_dump(path)
        events = json.load(open(path))["traceEvents"]
        assert {e["name"] for e in events} == {"outer", 'in"ner\n'}
        assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
        native.trace_clear()
        assert native.trace_count() == 0
        with native.use_python():
            assert native.trace_count() == 0 and not native.trace_dump(path)

    def test_trace_block_feeds_native(self):
        native.trace_clear()
        trace.on()
        try:
            with trace.trace_block("native-hook"):
                with trace.trace_block("inner"):
                    pass
        finally:
            trace.off()
        assert native.trace_count() == 2
        trace.finish(os.devnull)
        native.trace_clear()


class TestMatrixIntegration:
    def test_owner_map_root_view(self):
        A = slate_tpu_torch.Matrix(8 * 16, 6 * 16, nb=16, p=2, q=3, device="cpu")
        om = A.owner_map()
        assert om.shape == (8, 6)
        assert all(om[i, j] == A.tileRank(i, j) for i in range(8) for j in range(6))

    def test_owner_map_transposed_view(self):
        A = slate_tpu_torch.Matrix(4 * 8, 3 * 8, nb=8, p=2, q=2, device="cpu")
        T = A.T
        om = T.owner_map()
        assert om.shape == (T.mt, T.nt)
        assert all(om[i, j] == T.tileRank(i, j)
                   for i in range(T.mt) for j in range(T.nt))

    def test_local_tiles_match_owner_map(self):
        A = slate_tpu_torch.Matrix(6 * 8, 6 * 8, nb=8, p=2, q=2, device="cpu")
        om = A.owner_map()
        for rank in range(4):
            tiles = {tuple(t) for t in A.local_tiles(rank)}
            expect = {(i, j) for i in range(6) for j in range(6)
                      if om[i, j] == rank}
            assert tiles == expect


def test_root_views_take_the_native_maps(monkeypatch):
    """Root views call the runtime; offset and custom-map views walk tileRank."""
    calls = []
    real = native.owner_map
    monkeypatch.setattr(native, "owner_map",
                        lambda *a: calls.append(a) or real(*a))
    A = slate_tpu_torch.Matrix(40, 24, nb=8, p=2, q=3, order="row", device="cpu")
    om = A.owner_map()
    assert calls == [(5, 3, 2, 3, GridOrder.Row)]
    S = A.sub(1, 4, 0, 2)
    np.testing.assert_array_equal(S.owner_map(), om[1:5, 0:3])
    C = slate_tpu_torch.Matrix.from_array(np.zeros((16, 16)), nb=4, p=2, q=2,
                                          tile_rank=lambda i, j: (i + j) % 4,
                                          device="cpu")
    assert C.owner_map()[1, 2] == 3
    assert len(calls) == 1


def test_build_writes_only_under_its_build_dir(tmp_path):
    before = _listing(NATIVE_DIR)
    path = native.build(build_dir=str(tmp_path))        # forced: the dir is empty
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    assert re.fullmatch(r"libslate_rt_[0-9a-f]{16}\.so", os.path.basename(path))
    assert native.build(build_dir=str(tmp_path)) == path     # built once per digest
    lib = native.load(path)
    out = np.empty(6, dtype=np.int32)
    lib.srt_owner_map(2, 3, 2, 2, 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    np.testing.assert_array_equal(out.reshape(2, 3), native.owner_map(2, 3, 2, 2))
    assert _listing(NATIVE_DIR) == before
    assert os.path.dirname(native.build()) == native._BUILD_DIR


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    broken = tmp_path / "slate_rt.cpp"
    src = open(native._SRC).read()
    broken.write_text(src.replace("int64_t srt_pool_alloc(void* p) {",
                                  "int64_t srt_pool_alloc(void* p) { syntax error"))
    with pytest.raises(SlateError, match="build failed") as err:
        native.build(str(broken), str(tmp_path / "b"))
    assert "error" in str(err.value)
    assert not [f for f in os.listdir(tmp_path / "b") if f.endswith((".so", ".tmp"))]
    # the library the module would load: a failed build leaves no Python route
    monkeypatch.setattr(native, "_SRC", str(broken))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(SlateError, match="build failed"):
        native.owner_map(2, 2, 1, 1)
    with pytest.raises(SlateError, match="build failed"):
        native.backend()
    with pytest.raises(SlateError, match="build failed"):
        native.MemoryPool(64, 1)
    with pytest.raises(SlateError, match="build failed"):
        trace.on()
    assert not trace.is_on()
    trace.off()                   # disarming builds nothing, so it cannot fail
    assert native._lib is None
    monkeypatch.setenv("SLATE_TPU_NATIVE", "0")          # only when asked
    assert native.backend() == "python"
    np.testing.assert_array_equal(native.owner_map(2, 2, 1, 1), np.zeros((2, 2)))


def test_a_library_that_does_not_load_raises(tmp_path):
    bad = tmp_path / "libslate_rt_0000000000000000.so"
    bad.write_bytes(b"not an ELF file")
    with pytest.raises(SlateError, match="did not load"):
        native.load(str(bad))


def test_every_exported_symbol_is_declared():
    src = open(os.path.join(NATIVE_DIR, "slate_rt.cpp")).read()
    body = src[src.index('extern "C" {'):]
    exported = dict(re.findall(r"^(?:void\*?|int32_t|int64_t) (srt_\w+)\(([^)]*)\)",
                               body, flags=re.M))
    assert len(exported) == 16
    lib = native._native()
    ctype = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32,
             "void*": ctypes.c_void_p, "const char*": ctypes.c_char_p,
             "int32_t*": ctypes.POINTER(ctypes.c_int32),
             "int64_t*": ctypes.POINTER(ctypes.c_int64)}
    for name, params in exported.items():
        fn = getattr(lib, name)
        types = [re.sub(r"\s*\w+$", "", p.strip()).replace(" *", "*")
                 for p in params.split(",") if p.strip()]
        assert fn.argtypes == [ctype[t] for t in types], name
        ret = re.search(rf"^(\S+) {name}\(", body, flags=re.M).group(1)
        assert fn.restype == {"void": None, "void*": ctypes.c_void_p,
                              "int32_t": ctypes.c_int32,
                              "int64_t": ctypes.c_int64}[ret], name


def test_arguments_that_would_fault_the_library_are_refused():
    for bad in [(2, 2, 0, 1), (2, 2, 1, 0), (-1, 2, 1, 1), (2, 2, 2**31, 1)]:
        with pytest.raises(SlateError):
            native.owner_map(*bad)
    with pytest.raises(SlateError):
        native.redist_plan(4, 4, (2, 2), (0, 2))
    buf = np.empty((3, 2), dtype=np.int32)
    for wrong in (buf, buf.astype(np.int64)[:, ::2], np.empty(5, np.int64)):
        with pytest.raises(SlateError, match="buffer"):
            native._out(wrong, np.int64, 6, "test")
    assert native._out(np.empty((3, 2), np.int64), np.int64, 6, "test")

