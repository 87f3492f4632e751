"""The kernels' roofline counts give back PERF.md's bounds at its shapes,
and a share over 105% is an error, not a number."""

import types

import pytest

from portbench.harness import bench, trace


def test_segdp_bound_at_the_kernel_table_shape():
    seg = bench.roofline("segdp")
    # Bc 1024, SEGR 2048, W 256: 2.66e8 band cells x 12 operations
    rec = {"Bc": 1024, "SEGR": 2048, "LBW": 2600, "NB": 129, "W": 256,
           "T": 3072, "rows": round(2.66e8 / 256)}
    s, by = seg.bound_s(rec)
    assert by == "operations"
    assert s * 1e3 == pytest.approx(0.191, rel=0.005)


def test_sseg_bound_at_the_kernel_table_shape():
    k1 = bench.roofline("sseg")
    s, by = k1.bound_s({"N": 1 << 24, "out_budget": 1 << 24, "count": [0]})
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(36 * (1 << 24) / 3.35e12 * 1e3)
    # records past the budget are dropped, not written
    s2, _ = k1.bound_s({"N": 1 << 24, "out_budget": 10, "count": [10**9]})
    assert s2 == pytest.approx((36 * (1 << 24) + 320) / 3.35e12)


def _window(dur_us, launches):
    ev = [("void (anonymous namespace)::segdp_warp<8, 3>(...)", "kernel",
           float(i * 10_000), d) for i, d in enumerate(dur_us)]
    return types.SimpleNamespace(trace=trace.Trace(ev, 1.0),
                                 launches={"segdp": launches})


REC = {"Bc": 1024, "SEGR": 2048, "LBW": 2600, "NB": 129, "W": 256, "T": 3072,
       "rows": round(2.66e8 / 256)}


def test_share_of_the_roofline():
    w = _window([382.0], [REC])                  # twice the 0.191 ms bound
    assert trace.roofline_share(w, "segdp") == pytest.approx(50.0, rel=0.01)


def test_share_over_105_percent_is_an_error():
    w = _window([150.0], [REC])
    with pytest.raises(RuntimeError, match="over 105%"):
        trace.roofline_share(w, "segdp")


def test_share_is_absent_without_a_reading():
    assert trace.roofline_share(
        types.SimpleNamespace(trace=None, launches=None), "segdp") is None
    # launches that the trace does not pair up with
    assert trace.roofline_share(_window([400.0], [REC, REC]), "segdp") is None
    assert trace.roofline_share(_window([400.0], []), "segdp") is None
