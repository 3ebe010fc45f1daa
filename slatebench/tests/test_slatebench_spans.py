"""The readers of the program's spans (``entry_ms``, ``factor_ms``,
``guard_ms``, ``getrs_ms``, ``lu_stall_ms``): hand-computed means on a
fabricated span list, and nothing to read where the spans cannot be matched
to the window's solves."""

import types

import pytest

from .conftest import SEED

CELL = "hpl_f64.n49152"
READERS = ("entry_ms.solve", "factor_ms.solve", "guard_ms.solve",
           "getrs_ms.solve", "lu_stall_ms.solve")


def _solve(ids, t, gesv_ms, factor_ms, guard_ms, getrs_ms, entry_s):
    """The span records of one solve opened at host time ``t``."""
    root = next(ids)

    def rec(name, parent, t_open, t_close, device_ms):
        return {"name": name, "cat": "slate", "args": {}, "id": root if
                name == "gesv" else next(ids), "parent": parent,
                "root": root, "tid": 1, "t_open": t_open, "t_close": t_close,
                "device": None if device_ms is None else "cuda:0",
                "device_ms": device_ms, "device_open_ms": None,
                "device_close_ms": None}

    gesv = rec("gesv", None, t, t + 2.0, gesv_ms)
    getrf = rec("getrf", root, t + 1e-4, t + 1.9, 2.0)
    kids = [rec("getrf.factor", getrf["id"], t + entry_s, t + 0.1, factor_ms),
            rec("getrf.guard", getrf["id"], t + 0.1, t + 0.2, guard_ms),
            rec("getrf.pivots", getrf["id"], t + 1.8, t + 1.85, None),
            rec("getrs", root, t + 1.9, t + 1.95, getrs_ms)]
    return kids + [getrf, gesv]


def _records():
    ids = iter(range(1, 1000))
    return (_solve(ids, 100.0, 2200.0, 2150.0, 10.0, 20.0, 0.0005)
            + _solve(ids, 103.0, 2300.0, 2240.0, 14.0, 30.0, 0.0007))


def _run(attempted=2, t_process=90.0, setup_s=9.5, window_s=6.0):
    return types.SimpleNamespace(attempted=attempted, t_process=t_process,
                                 setup_s=setup_s, window_s=window_s)


@pytest.fixture
def reader():
    from slatebench.cells import Cell, load_benchmark

    cell = Cell(load_benchmark(), CELL)
    return cell.reader


@pytest.fixture
def recorded(monkeypatch):
    """The program's ``trace.spans()`` handing over ``records``, once."""
    from slate_tpu_torch.utils import trace

    def install(records):
        box = [list(records)]

        def spans():
            out, box[0] = box[0], []
            return out
        monkeypatch.setattr(trace, "spans", spans)
    return install


def test_each_reader_gives_the_hand_computed_mean(reader, recorded):
    recorded(_records())
    run = _run()
    got = {name: reader(name)(run, {}) for name in READERS}
    assert got["entry_ms.solve"] == pytest.approx((0.5 + 0.7) / 2)
    assert got["factor_ms.solve"] == pytest.approx((2150.0 + 2240.0) / 2)
    assert got["guard_ms.solve"] == pytest.approx((10.0 + 14.0) / 2)
    assert got["getrs_ms.solve"] == pytest.approx((20.0 + 30.0) / 2)
    # gesv less factor, guard and getrs: 20 and 16 ms
    assert got["lu_stall_ms.solve"] == pytest.approx((20.0 + 16.0) / 2)


def test_a_root_count_other_than_the_solves_reads_nothing(reader, recorded):
    for attempted in (1, 3):
        recorded(_records())
        run = _run(attempted=attempted)
        assert all(reader(name)(run, {}) is None for name in READERS)


def test_roots_outside_the_window_are_not_counted(reader, recorded):
    """A gesv call before the window opened (the warm solve, under a
    ``trace.on()`` left on) is not one of the window's solves."""
    ids = iter(range(5000, 6000))
    recorded(_solve(ids, 95.0, 9000.0, 8000.0, 10.0, 20.0, 0.001)
             + _records())
    run = _run()
    assert reader("factor_ms.solve")(run, {}) == pytest.approx(2195.0)


def test_no_spans_recorded_reads_nothing(reader, recorded):
    recorded([])
    run = _run()
    assert all(reader(name)(run, {}) is None for name in READERS)


def test_a_span_timed_on_the_host_alone_reads_no_device_time(reader,
                                                             recorded):
    recs = _records()
    for r in recs:
        r["device_ms"] = None
    recorded(recs)
    run = _run()
    assert reader("factor_ms.solve")(run, {}) is None
    assert reader("lu_stall_ms.solve")(run, {}) is None
    assert reader("entry_ms.solve")(run, {}) == pytest.approx(0.6)


def test_a_program_without_spans_reads_nothing(reader, monkeypatch):
    """The parent's program has no ``trace.spans()``: the readers return
    None and raise nothing."""
    from slate_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "spans")
    run = _run()
    assert all(reader(name)(run, {}) is None for name in READERS)


@pytest.mark.parametrize("side", ["program", "control"])
def test_under_a_profiler_the_program_reads_its_host_spans_the_control_none(
        tiny_root, bench, side):
    """A profiler held open over a whole CPU run: the program's window
    solves give the entry's host time (the warm solve before the window is
    not counted) and no device time; the control, solving in the program's
    place, gives nothing."""
    from torch.profiler import ProfilerActivity, profile

    from slatebench import run as runner
    from slatebench.cells import Cell

    kw = Cell(bench, CELL, tiny_root).entry().control_options() \
        if side == "control" else None
    with profile(activities=[ProfilerActivity.CPU]):
        run, res = runner.execute(CELL, SEED, 0.3, True, device="cpu",
                                  root=tiny_root, entry_kw=kw)
    assert run.attempted >= 1
    got = set(READERS) & set(res["metrics"])
    assert got == ({"entry_ms.solve"} if side == "program" else set())


@pytest.mark.card
def test_a_traced_run_on_the_card_reads_every_span_metric(cuda_device,
                                                          tiny_root):
    from slatebench import run as runner

    _, res = runner.execute(CELL, SEED, 0.3, True, device=cuda_device,
                            root=tiny_root)
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(m)
    assert all(m[k] > 0.0 for k in READERS if k != "lu_stall_ms.solve")
    # the gesv span's events bracket the other three on one stream
    assert m["lu_stall_ms.solve"] >= -1e-3
