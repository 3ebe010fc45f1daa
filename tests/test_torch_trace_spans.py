"""The port's spans: recorded under ``trace.on()`` or any running profiler,
one tree per top-level call, read by ``trace.spans()`` or ``trace.finish()``,
and timed on the card through events that nothing waits for while the
program runs.  Every test here runs on the CPU."""

import json
import os
import time

import numpy as np
import pytest
import torch

import slate_tpu_torch as st
from slate_tpu_torch import native
from slate_tpu_torch.utils import trace

GESV_TREE = {"gesv": None, "getrf": "gesv", "getrf.factor": "getrf",
             "getrf.guard": "getrf", "getrf.pivots": "getrf", "getrs": "gesv"}
DEVICE_TIMED = {"gesv", "getrf", "getrf.factor", "getrf.guard", "getrs"}


@pytest.fixture(autouse=True)
def _empty_buffer():
    trace.finish(os.devnull)
    yield
    trace.finish(os.devnull)


def _system(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, n)) + n * np.eye(n)),
            torch.from_numpy(rng.standard_normal((n, 1))))


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        fn()


def _by_name(records):
    return {r["name"]: r for r in records}


def test_without_tracing_or_a_profiler_gesv_records_no_span():
    assert not trace.recording()
    st.gesv(*_system())
    assert trace.spans() == []
    assert trace.finish(os.devnull) is None


def test_a_profiled_gesv_records_one_tree():
    A, b = _system()
    _profiled(lambda: st.gesv(A, b))
    recs = trace.spans()
    names = [r["name"] for r in recs]
    assert sorted(names) == sorted(GESV_TREE)        # getrf once, not twice
    by = _by_name(recs)
    root = by["gesv"]
    assert root["parent"] is None and root["root"] == root["id"]
    for name, parent in GESV_TREE.items():
        r = by[name]
        assert r["root"] == root["id"]
        if parent is not None:
            p = by[parent]
            assert r["parent"] == p["id"]
            assert p["t_open"] <= r["t_open"] <= r["t_close"] <= p["t_close"]
        # CPU tensors: timed on the host alone
        assert r["device"] is None and r["device_ms"] is None
        assert r["device_open_ms"] is None and r["device_close_ms"] is None
    # getrf's own labels ride on the one region its scope opened
    assert {"m": "24", "n": "24", "dtype": "float64",
            "parent": "gesv"}.items() <= by["getrf"]["args"].items()
    # the children run in order: factor, guard, pivots, then getrs
    order = [by[n]["t_open"] for n in ("getrf.factor", "getrf.guard",
                                        "getrf.pivots", "getrs")]
    assert order == sorted(order)
    assert len({r["id"] for r in recs}) == len(recs)


def test_two_calls_give_two_roots():
    A, b = _system()

    def twice():
        st.gesv(A, b)
        st.gesv(A, b)

    _profiled(twice)
    recs = trace.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["gesv", "gesv"]
    assert roots[0]["id"] != roots[1]["id"]
    for root in roots:
        mine = [r for r in recs if r["root"] == root["id"]]
        assert sorted(r["name"] for r in mine) == sorted(GESV_TREE)


def test_spans_clears_what_it_returns_and_keeps_instants_for_finish(tmp_path):
    def work():
        with trace.trace_block("outer"):
            trace.trace_event("mark")

    _profiled(work)
    assert [r["name"] for r in trace.spans()] == ["outer"]
    assert trace.spans() == []
    path = trace.finish(str(tmp_path / "t.json"))
    assert [e["name"] for e in json.load(open(path))["traceEvents"]] == ["mark"]


def test_finish_writes_the_same_spans(tmp_path):
    A, b = _system()
    _profiled(lambda: st.gesv(A, b))
    path = trace.finish(str(tmp_path / "t.json"))
    events = json.load(open(path))["traceEvents"]
    assert trace.spans() == []                        # finish took them
    assert sorted(e["name"] for e in events) == sorted(GESV_TREE)
    by = {e["name"]: e for e in events}
    for name, parent in GESV_TREE.items():
        e = by[name]
        assert e["ph"] == "X" and e["dur"] >= 0
        assert e["args"]["root_id"] == by["gesv"]["args"]["span_id"]
        assert e["args"]["parent_id"] == (by[parent]["args"]["span_id"]
                                          if parent else None)
    # the same tree again, through spans(): the same names, links and labels
    _profiled(lambda: st.gesv(A, b))
    recs = _by_name(trace.spans())
    for name, e in by.items():
        assert {k: v for k, v in e["args"].items()
                if not k.endswith("_id")} == recs[name]["args"]


def test_the_pivots_span_covers_the_pivots_phase():
    A, b = _system(n=96)
    _profiled(lambda: st.gesv(A, b))
    phase = trace.last_phases("getrf")["pivots"]
    span = _by_name(trace.spans())["getrf.pivots"]
    assert 0.0 < phase <= span["t_close"] - span["t_open"]


def test_a_profiled_region_never_synchronizes_nor_arms_the_native_capture(
        monkeypatch):
    count = native.trace_count()
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    monkeypatch.setattr(native, "trace_begin",
                        lambda name: pytest.fail("native capture armed"))
    timers = trace.Timers(device=torch.device("cuda"))

    def work():
        assert trace.recording() and not trace.is_on()
        with timers.time("phase"):
            pass
        st.gesv(*_system())

    _profiled(work)
    assert syncs == [] and set(timers) == {"phase"}
    assert len(trace.spans()) == len(GESV_TREE)
    monkeypatch.undo()
    assert native.trace_count() == count


def test_emit_span_and_trace_event_record_under_a_profiler_alone():
    t = time.perf_counter()
    trace.emit_span("serve.pad", t, t - 1.0, routine="gesv")    # off: dropped
    _profiled(lambda: trace.emit_span("serve.pad", t, t + 0.5, routine="gesv"))
    (rec,) = trace.spans()
    assert rec["name"] == "serve.pad" and rec["cat"] == "slate.serve"
    assert rec["parent"] is None and rec["root"] == rec["id"]
    assert (rec["t_open"], rec["t_close"]) == (t, t + 0.5)
    assert rec["args"] == {"routine": "gesv"}


class _Event:
    """A stand-in for a timing CUDA event, stamped on the host's clock."""

    made, waited = [], []

    def __init__(self, device):
        self.t = time.perf_counter()
        _Event.made.append(self)

    def synchronize(self):
        _Event.waited.append(self)

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_device_timed_spans_resolve_their_events_only_when_read(
        monkeypatch, tmp_path):
    """With the card's events stood in for, a device-timed span keeps its
    duration and its offsets from the root's open event, and nothing waits
    for an event before the spans are read."""
    _Event.made, _Event.waited = [], []
    monkeypatch.setattr(trace, "_timed_device",
                        lambda d: None if d is None else torch.device(d))
    monkeypatch.setattr(trace, "_event", _Event)
    A, b = _system()
    _profiled(lambda: st.gesv(A, b))
    assert len(_Event.made) == 2 * len(DEVICE_TIMED) and _Event.waited == []
    by = _by_name(trace.spans())
    assert _Event.waited
    assert by["gesv"]["device_open_ms"] == 0.0
    for name in GESV_TREE:
        r = by[name]
        if name not in DEVICE_TIMED:
            assert r["device"] is None and r["device_ms"] is None
            continue
        assert r["device"] == "cpu"
        assert 0.0 <= r["device_ms"] <= 1e3 * (r["t_close"] - r["t_open"])
        assert r["device_close_ms"] - r["device_open_ms"] == \
            pytest.approx(r["device_ms"])
        assert r["device_open_ms"] == pytest.approx(
            1e3 * (r["t_open"] - by["gesv"]["t_open"]), abs=5.0)
    inner = sum(by[n]["device_ms"] for n in ("getrf.factor", "getrf.guard",
                                              "getrs"))
    assert inner <= by["gesv"]["device_ms"]
    # finish(): each device-timed span once more, on the device's own track
    _profiled(lambda: st.gesv(A, b))
    events = json.load(open(trace.finish(str(tmp_path / "t.json"))))["traceEvents"]
    dev = [e for e in events if e.get("cat") == "slate.device"]
    assert sorted(e["name"] for e in dev) == sorted(DEVICE_TIMED)
    (meta,) = [e for e in events if e["ph"] == "M"]
    assert {e["tid"] for e in dev} == {meta["tid"]}
    host = {e["name"]: e for e in events if e.get("cat") == "slate"}
    assert {e["tid"] for e in host.values()}.isdisjoint({meta["tid"]})


def test_driver_calls_keep_the_span_counter_and_drop_the_seconds_histogram():
    st.obs.reset()
    st.gesv(*_system())
    assert st.obs.REGISTRY.get("slate_span_seconds") is None
    c = st.obs.REGISTRY.get("slate_spans_total")
    assert c.value(routine="gesv", dtype="float64", shape_bucket="<=32") == 1.0


def test_the_lookahead_route_records_its_spans_and_counts_its_route():
    """The blocked driver opens getrf.factor (the private copy and every
    panel) and getrf.guard under getrf, with no getrf.pivots span; getrf's
    region carries the route, the panel width and the panel count; the
    ``pivots`` phase reads 0, since no pivot reaches the host; and
    ``slate_lu_route_total`` counts each route (Target Auto on a CPU tensor
    stays on the library route); ``getrf`` carries its NaN guard, ``fused``
    on the lookahead route and ``library`` on the other, and
    ``slate_lu_guard_total`` counts each."""
    st.obs.reset()
    A, b = _system(n=40)
    _profiled(lambda: st.gesv(A, b, {"target": "tiled", "block_size": 16}))
    assert trace.last_phases("getrf")["pivots"] == 0.0
    by = _by_name(trace.spans())
    assert sorted(by) == sorted(set(GESV_TREE) - {"getrf.pivots"})
    assert by["getrf.factor"]["parent"] == by["getrf.guard"]["parent"] == by["getrf"]["id"]
    assert by["getrf.factor"]["t_close"] <= by["getrf.guard"]["t_open"]
    assert {"route": "lookahead", "guard": "fused", "nb": "16", "panels": "3",
            "target": "tiled"}.items() <= by["getrf"]["args"].items()
    _profiled(lambda: st.gesv(A, b))
    assert {"route": "library", "guard": "library", "target": "auto"}.items() \
        <= _by_name(trace.spans())["getrf"]["args"].items()
    c = st.obs.REGISTRY.get("slate_lu_route_total")
    assert c.value(route="lookahead") == 1.0 and c.value(route="library") == 1.0
    g = st.obs.REGISTRY.get("slate_lu_guard_total")
    assert g.value(guard="fused") == 1.0 and g.value(guard="library") == 1.0
