"""print / checkpoint / debug utilities, pool tracking, trace finish and phase
attempts of the port, against the JAX package: mirrors ``tests/test_utils.py``.

``print_matrix`` text is held to the JAX package's character for character,
``.npz`` checkpoints load across the two packages both ways, and the
re-gridding load runs on four gloo ranks (one pool for the module).  The JAX
package is imported lazily (the ranks import this module, torch only)."""

import gc
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import slate_tpu_torch as slate
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.parallel.launch import RankPool
from slate_tpu_torch.utils import debug


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    import slate_tpu
    from slate_tpu.utils import debug as jdebug

    return SimpleNamespace(jnp=jnp, slate=slate_tpu, debug=jdebug)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
        yield p


def rng(seed=0):
    return np.random.default_rng(seed)


def cpu(a):
    return torch.from_numpy(np.asarray(a))


class TestPrint:
    def _a(self, m=6, n=5):
        return rng(1).standard_normal((m, n)).astype(np.float32)

    def _both(self, jx, a, nb=2):
        return (slate.Matrix.from_array(cpu(a), nb=nb),
                jx.slate.Matrix.from_array(a, nb=nb))

    def test_verbose_0_silent(self, jx):
        buf = io.StringIO()
        out = slate.print_matrix("A", self._both(jx, self._a())[0], verbose=0, file=buf)
        assert out is None and buf.getvalue() == ""

    def test_verbose_1_meta_only(self, jx):
        A, J = self._both(jx, self._a())
        buf = io.StringIO()
        out = slate.print_matrix("A", A, verbose=1, file=buf)
        assert "Matrix 6x5" in out and "grid 1x1" in out
        assert "[" not in out and buf.getvalue() == out + "\n"
        assert out == jx.slate.print_matrix("A", J, verbose=1, file=io.StringIO())

    def test_verbose_2_abbreviated(self, jx):
        a = rng(2).standard_normal((40, 40)).astype(np.float32)
        A, J = self._both(jx, a, nb=8)
        out = slate.print_matrix("B", A, verbose=2, file=io.StringIO())
        assert "..." in out
        assert out == jx.slate.print_matrix("B", J, verbose=2, file=io.StringIO())

    @pytest.mark.parametrize("dtype", [np.float32, np.complex128])
    def test_verbose_3_full(self, jx, dtype):
        a = (self._a(3, 3) + (0.5j * self._a(3, 3) if dtype == np.complex128 else 0)
             ).astype(dtype)
        A, J = self._both(jx, a)
        out = slate.print_matrix("C", A, verbose=3, file=io.StringIO())
        assert f"{a[0, 0].real:10.4f}".strip() in out
        assert out == jx.slate.print_matrix("C", J, verbose=3, file=io.StringIO())

    def test_verbose_4_tile_rules(self, jx):
        a = self._a(5, 7)
        A = slate.Matrix.from_array(cpu(a), nb=2, tile_nb=[3, 2, 2])
        J = jx.slate.Matrix.from_array(a, nb=2, tile_nb=[3, 2, 2])
        out = slate.print_matrix("D", A, verbose=4, file=io.StringIO())
        assert "|" in out and "-" in out
        assert out == jx.slate.print_matrix("D", J, verbose=4, file=io.StringIO())
        H = slate.HermitianMatrix.from_array("lower", cpu(a[:5, :5]), nb=2).T
        JH = jx.slate.HermitianMatrix.from_array(jx.slate.Uplo.Lower, a[:5, :5], nb=2).T
        assert slate.print_matrix("H", H, verbose=4, file=io.StringIO()) == \
            jx.slate.print_matrix("H", JH, verbose=4, file=io.StringIO())

    def test_plain_array(self, jx):
        for verbose in (1, 3):
            for a in (np.eye(3, dtype=np.float32), rng(3).standard_normal((4, 2))):
                out = slate.print_matrix("E", a, verbose=verbose, file=io.StringIO())
                assert "array" in out
                assert out == jx.slate.print_matrix("E", a, verbose=verbose,
                                                    file=io.StringIO())
                assert slate.print_matrix("E", cpu(a), verbose=verbose,
                                          file=io.StringIO()) == out


class TestCheckpoint:
    def test_general_round_trip(self, tmp_path, jx):
        a = rng(2).standard_normal((12, 10)).astype(np.float32)
        A = slate.Matrix.from_array(cpu(a), nb=4)
        p = str(tmp_path / "m.npz")
        slate.save_matrix(p, A)
        B = slate.load_matrix(p, device="cpu")
        assert isinstance(B, slate.Matrix)
        assert B.storage.nb == 4 and B.device.type == "cpu"
        np.testing.assert_array_equal(B.array.numpy(), a)
        J = jx.slate.load_matrix(p)                      # port -> JAX
        assert isinstance(J, jx.slate.Matrix) and J.storage.nb == 4
        np.testing.assert_array_equal(np.asarray(J.array), a)
        with pytest.raises(SlateError, match="CUDA"):
            slate.load_matrix(p)                          # cuda unless asked

    def test_hermitian_round_trip(self, tmp_path, jx):
        a = rng(3).standard_normal((8, 8)).astype(np.float32)
        J = jx.slate.HermitianMatrix.from_array(jx.slate.Uplo.Upper, a, nb=4)
        p = str(tmp_path / "h.npz")
        jx.slate.save_matrix(p, J)                       # JAX -> port
        B = slate.load_matrix(p, device="cpu")
        assert isinstance(B, slate.HermitianMatrix)
        assert B.uplo == slate.Uplo.Upper and B.storage.nb == 4
        np.testing.assert_array_equal(B.array.numpy(), a)
        p2 = str(tmp_path / "h2.npz")
        slate.save_matrix(p2, B, note="port")
        with np.load(p) as z1, np.load(p2) as z2:
            assert sorted(z2.files) == sorted(z1.files + ["meta_note"])
            for k in z1.files:
                np.testing.assert_array_equal(z1[k], z2[k])

    def test_regrid_on_load(self, tmp_path, pool, jx):
        a = rng(4).standard_normal((16, 16)).astype(np.float32)
        A = slate.Matrix.from_array(cpu(a), nb=4, p=1, q=1)
        src, out = str(tmp_path / "g.npz"), str(tmp_path / "g2.npz")
        slate.save_matrix(src, A)
        res = pool.run(_regrid_job, src, out)
        for gridinfo, placements, arr in res:
            assert gridinfo == (2, 2)
            assert placements == ["S(0)", "S(1)"]     # the block layout
            np.testing.assert_array_equal(arr, a)
        J = jx.slate.load_matrix(out)        # written once, from the gathered shards
        assert J.gridinfo()[1:] == (2, 2)
        np.testing.assert_array_equal(np.asarray(J.array), a)

    def test_plain_array_round_trip(self, tmp_path, jx):
        a = rng(5).standard_normal((5, 3))
        p = str(tmp_path / "a.npz")
        slate.save_matrix(p, a)
        t = slate.load_matrix(p, device="cpu")
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), a)
        np.testing.assert_array_equal(jx.slate.load_matrix(p), a)

    def test_band_round_trip(self, tmp_path, jx):
        n, kd = 10, 2
        a = rng(6).standard_normal((n, n)).astype(np.float32)
        band = np.tril(np.triu(np.tril(a + a.T, kd), -kd)).astype(np.float32)
        J = jx.slate.core.matrix.HermitianBandMatrix(jx.slate.Uplo.Lower, n, kd, nb=4)
        J.set_array(jx.jnp.asarray(band))
        p = str(tmp_path / "b.npz")
        jx.slate.save_matrix(p, J)
        B = slate.load_matrix(p, device="cpu")
        assert isinstance(B, slate.HermitianBandMatrix) and B.kd == kd
        np.testing.assert_array_equal(B.array.numpy(), band)
        p2 = str(tmp_path / "b2.npz")
        slate.save_matrix(p2, B)
        J2 = jx.slate.load_matrix(p2)
        assert type(J2).__name__ == "HermitianBandMatrix" and J2.kd == kd
        np.testing.assert_array_equal(np.asarray(J2.array), band)


def _regrid_job(src, out):
    """On each of four ranks: load ``src`` onto a 2x2 grid, then save the
    grid-bound wrapper to ``out`` (grid rank 0 writes it)."""
    B = slate.load_matrix(src, p=2, q=2, device="cpu")
    arr = B.storage.array
    res = (B.gridinfo()[1:], [str(x) for x in arr.placements], B.array.numpy())
    slate.save_matrix(out, B)
    return res


class TestDebug:
    def test_check_finite(self, jx):
        A = slate.Matrix.from_array(torch.ones(4, 4), nb=2)
        assert debug.check_finite(A)
        bad = np.ones((4, 4), np.float32)
        bad[2, 1] = np.nan
        bad[3, 0] = np.inf
        with pytest.raises(SlateError, match="non-finite") as err:
            debug.check_finite(slate.Matrix.from_array(cpu(bad), nb=2))
        with pytest.raises(jx.slate.SlateError) as jerr:
            jx.debug.check_finite(jx.slate.Matrix.from_array(bad, nb=2))
        assert str(err.value) == str(jerr.value)
        assert debug.check_finite(torch.ones(0, 3))

    def test_check_owner_map(self, jx, monkeypatch):
        monkeypatch.setattr(jx.slate.native, "_load", lambda: jx.slate.native._lib)
        for p, q, order in [(2, 2, "col"), (2, 3, "row")]:
            A = slate.Matrix(32, 40, nb=8, p=p, q=q, order=order, device="cpu")
            assert debug.check_owner_map(A)
            assert jx.debug.check_owner_map(
                jx.slate.Matrix(32, 40, nb=8, p=p, q=q, order=order))
        C = slate.Matrix.from_array(torch.zeros(16, 16), nb=4, p=2, q=2,
                                    tile_rank=lambda i, j: 5)
        with pytest.raises(SlateError, match="owner out of range"):
            debug.check_owner_map(C)

    def test_check_structure_hermitian(self, jx):
        a = rng(7).standard_normal((6, 6)).astype(np.complex64)
        a = a + a.conj().T
        A = slate.HermitianMatrix.from_array("lower", cpu(a), nb=2)
        assert debug.check_structure(A)
        a2 = a + 1j * np.eye(6, dtype=np.complex64)
        with pytest.raises(SlateError, match="imaginary") as err:
            debug.check_structure(slate.HermitianMatrix.from_array("lower", cpu(a2), nb=2))
        with pytest.raises(jx.slate.SlateError) as jerr:
            jx.debug.check_structure(
                jx.slate.HermitianMatrix.from_array(jx.slate.Uplo.Lower, a2, nb=2))
        assert str(err.value) == str(jerr.value)
        B = slate.BandMatrix(6, 6, 1, 1, 2, device="cpu")
        B.set_array(torch.ones(6, 6))
        with pytest.raises(SlateError, match=r"\|1.00e\+00\| outside \(kl=1, ku=1\)"):
            debug.check_structure(B)

    def test_check_no_leaks(self, jx):
        pool = slate.native.MemoryPool(64, 2)
        bid = pool.alloc()
        with pytest.raises(SlateError, match="still allocated") as err:
            debug.check_no_leaks(pool)
        assert str(err.value) == "pool: 1 of 2 blocks still allocated (peak 1)"
        pool.free(bid)
        assert debug.check_no_leaks(pool)

    def test_tile_summary(self, jx, monkeypatch):
        monkeypatch.setattr(jx.slate.native, "_load", lambda: jx.slate.native._lib)
        A = slate.Matrix(32, 40, nb=8, p=2, q=2, device="cpu")
        s = debug.tile_summary(A)
        assert "rank 0: 6 tiles" in s and "grid 2x2" in s
        assert s == jx.debug.tile_summary(jx.slate.Matrix(32, 40, nb=8, p=2, q=2))


class TestPoolTracking:
    """Workspace-pool accounting wired into MatrixStorage (Memory.cc +
    Debug::printNumFreeMemBlocks analogue; opt-in)."""

    def test_live_workspace_report(self):
        debug.enable_pool_tracking(True)
        try:
            count0, _ = debug.live_workspace_report()
            M = slate.Matrix.from_array(torch.zeros(64, 64), nb=16)
            count, total = debug.live_workspace_report()
            assert count == count0 + 1
            assert total >= 16 * 16 * 4 * 16  # 4x4 tiles of 16x16 f32
            pool = M.storage.pool
            assert pool.capacity == 16 and pool.in_use == 0
            assert pool.block_bytes == 16 * 16 * 4
            debug.check_no_leaks(pool, "M")  # healthy storage passes
            # transient workspace: alloc/free round-trip keeps it leak-free
            bid = pool.alloc()
            assert bid >= 0 and pool.in_use == 1
            assert pool.free(bid) and pool.in_use == 0
            debug.check_no_leaks(pool, "M")
            del M, pool
            gc.collect()
            count2, _ = debug.live_workspace_report()
            assert count2 <= count - 1  # weak registry drops dead storages
        finally:
            debug.enable_pool_tracking(False)

    def test_tracking_off_is_free(self):
        M = slate.Matrix.from_array(torch.zeros(8, 8), nb=4)
        assert getattr(M.storage, "pool", None) is None


class TestTraceFinish:
    """trace.finish is idempotent and safe under trace.off()."""

    def test_finish_is_idempotent(self, tmp_path):
        from slate_tpu_torch.utils import trace

        trace.on()
        try:
            with trace.trace_block("region_a"):
                pass
            p1 = str(tmp_path / "t1.json")
            assert trace.finish(p1) == p1
            events = json.load(open(p1))["traceEvents"]
            assert any(e["name"] == "region_a" for e in events)
            # second call: nothing buffered -> no file, no duplicate
            p2 = str(tmp_path / "t2.json")
            assert trace.finish(p2) is None
            assert not os.path.exists(p2)
        finally:
            trace.off()

    def test_finish_under_off_returns_none(self, tmp_path):
        from slate_tpu_torch.utils import trace

        trace.off()
        p = str(tmp_path / "off.json")
        assert trace.finish(p) is None
        assert not os.path.exists(p)

    def test_events_after_flush_start_fresh_buffer(self, tmp_path):
        from slate_tpu_torch.utils import trace

        trace.on()
        try:
            with trace.trace_block("first"):
                pass
            trace.finish(str(tmp_path / "a.json"))
            with trace.trace_block("second"):
                pass
            pb = trace.finish(str(tmp_path / "b.json"))
            names = [e["name"] for e in json.load(open(pb))["traceEvents"]]
            assert names == ["second"]      # no replay of the flushed events
        finally:
            trace.off()


class TestPhaseAttempts:
    """Escalation-ladder retries accumulate per-attempt phase maps."""

    def test_ladder_keeps_failed_attempt_phases(self):
        from slate_tpu_torch.robust import Rung, run_ladder
        from slate_tpu_torch.utils import trace

        def failing_rung():
            tm = trace.Timers()
            tm["panel"] = 2.0
            trace.record_phases("inner_driver", tm)
            return None, False

        def winning_rung():
            tm = trace.Timers()
            tm["panel"] = 0.25
            trace.record_phases("inner_driver", tm)
            return "ok", True

        out = run_ladder("t_ladder_phases",
                         [Rung("fast", failing_rung), Rung("full", winning_rung)])
        assert out == "ok"
        attempts = trace.phase_attempts("t_ladder_phases")
        assert attempts[0] == {"inner_driver.panel": 2.0}
        assert attempts[1] == {"inner_driver.panel": 0.25}
        assert trace.last_phases("inner_driver") == {"panel": 0.25}

    def test_fresh_ladder_run_resets_attempt_history(self):
        from slate_tpu_torch.robust import Rung, run_ladder
        from slate_tpu_torch.utils import trace

        def ok_rung():
            trace.record_phases("d2", {"phase": 1.0})
            return "x", True

        run_ladder("t_ladder_reset", [Rung("a", ok_rung)])
        run_ladder("t_ladder_reset", [Rung("a", ok_rung)])
        assert list(trace.phase_attempts("t_ladder_reset")) == [0]

    def test_plain_record_lands_under_attempt_zero(self):
        from slate_tpu_torch.utils import trace

        trace.record_phases("t_plain", {"stage": 3.0})
        assert trace.phase_attempts("t_plain") == {0: {"stage": 3.0}}
