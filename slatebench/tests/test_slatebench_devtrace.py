"""The device trace's arithmetic: busy time is a union of intervals, gaps
are labelled by the harness span the host was in."""

from slatebench import devtrace


def test_overlapping_kernels_count_once_and_gaps_take_the_host_label():
    spans = devtrace.Spans()
    spans.add(0.0, 1.2, "regenerate")
    spans.add(1.2, 3.0, "solve")
    ev = [(0, 400, "a"), (200, 600, "b"), (1500, 2000, "a"),
          (2600, 2800, "c")]
    out = devtrace.summarize(ev, 0, 3000, spans, lambda ns: ns / 1000.0,
                             "between")
    assert out["busy_s"] == (600 + 500 + 200) / 1e9
    assert out["window_s"] == 3000 / 1e9
    assert out["busy_by_label"] == {"regenerate": 600 / 1e9,
                                    "solve": 700 / 1e9}
    assert out["device_ops"][0] == ["a", 900 / 1e9]
    labels = dict((round(v * 1e9), n) for n, v in out["idle_gaps"])
    assert labels == {900: "regenerate", 600: "solve", 200: "solve"}


def test_events_outside_the_window_are_clipped():
    out = devtrace.summarize([(-100, 100, "a"), (900, 1200, "b")], 0, 1000,
                             None, lambda ns: ns, "idle")
    assert out["busy_s"] == 200 / 1e9
    assert [g[0] for g in out["idle_gaps"]] == ["idle"]
