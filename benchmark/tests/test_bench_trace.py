"""The trace arithmetic on synthetic intervals: the union of device
intervals, the idle share, clipping to the window, the breakdown."""

import importlib.util
import os

import pytest

from benchmark.trace import TraceData, reduce_events, top_breakdown, union_length

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")


def _reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("intervals,total", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 1), (2, 3)], 2.0),  # a gap
    ([(0, 2), (1, 3)], 3.0),  # overlap counted once
    ([(1, 3), (0, 2), (0.5, 1.5)], 3.0),  # nested, out of order
    ([(0, 1), (1, 2)], 2.0),  # touching
    ([(2, 2), (3, 1)], 0.0),  # empty and inverted
])
def test_union_length(intervals, total):
    assert union_length(intervals) == pytest.approx(total)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_reduce_clips_to_the_recorded_steps():
    events = [
        _ev("ProfilerStep#3", "user_annotation", 100.0, 100.0),
        _ev("ProfilerStep#4", "user_annotation", 200.0, 100.0),
        _ev("k_before", "kernel", 50.0, 100.0),  # 100..150 inside
        _ev("k_mid", "kernel", 160.0, 20.0),
        _ev("k_overlap", "kernel", 170.0, 20.0),  # overlaps k_mid: union 160..190
        _ev("Memcpy HtoD", "gpu_memcpy", 250.0, 10.0),
        _ev("k_after", "kernel", 290.0, 50.0),  # 290..300 inside
        _ev("k_outside", "kernel", 400.0, 10.0),
        _ev("aten::mm", "cpu_op", 190.0, 60.0),
        {"ph": "i", "name": "marker", "ts": 120.0},
    ]
    d = reduce_events(events)
    assert d.steps == 2
    assert d.window_s == pytest.approx(200e-6)
    assert d.busy_s == pytest.approx((50 + 30 + 10 + 10) * 1e-6)
    assert len(d.device_ops) == 5
    idle = _reader("device_idle_share.eval")(d, {"kind": "mc", "loop": "eval"})
    assert idle == pytest.approx(50.0)
    assert _reader("device_idle_share.train")(d, {"kind": "mc"}) is None
    b = top_breakdown(d)
    assert b["device_ops"][0][0] == "k_before"
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(60e-6)  # 190..250
    assert sum(gaps.values()) == pytest.approx(100e-6)


def _idle_keyed_on_mc(trace, context):
    """The eval idle share as its reader read it while it keyed on the mc kind."""
    if context.get("kind") != "mc" or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


@pytest.mark.parametrize("ops", [
    [],
    [("k", 0.5, 1.75)],
    [("bp4_qc_kernel", 0.5, 0.9), ("gemm", 0.85, 1.1), ("Memcpy HtoD", 1.3, 1.3000001), ("k", 1.7, 1.75)],
    [("k%d" % i, 0.5 + 0.001 * i, 0.5 + 0.001 * i + 0.0007) for i in range(1000)],
])
def test_eval_idle_share_keys_on_the_eval_loop(ops):
    read = _reader("device_idle_share.eval")
    d = TraceData((0.5, 1.75), 10, ops)
    mc_context = {"kind": "mc", "loop": "eval", "k1_bound_ms": 1.0, "ops": {}, "k1_launches": 7}
    assert read(d, mc_context) == _idle_keyed_on_mc(d, {"kind": "mc"})  # to the bit
    assert read(TraceData((0.0, 0.0), 1, []), mc_context) is None  # an empty window
    for context in ({"kind": "train", "numbers": {}}, {"kind": "stub"}, {"kind": "mc"}, {"loop": "train"}):
        assert read(d, context) is None


def test_no_recorded_step_gives_no_trace():
    assert reduce_events([_ev("k", "kernel", 0.0, 1.0)]) is None


def test_k1_readers():
    d = TraceData((0.0, 1.0), 2, [("void bp4_qc_kernel<0,0,6,3,0>(...)", 0.0, 0.2),
                                  ("elementwise", 0.2, 0.5), ("Memset", 0.5, 0.6)])
    ctx = {"kind": "mc", "k1_bound_ms": 10.0, "ops": {"k1": 6.7e9, "gnn": 0.0, "gf2": 0.0}}
    assert _reader("k1_ms_per_step")(d, ctx) == pytest.approx(100.0)
    assert _reader("k1_roofline")(d, ctx) == pytest.approx(10.0)
    assert _reader("cascade_other_ms_per_step")(d, ctx) == pytest.approx(200.0)
    # 6.7e9 operations a batch in 0.5 s a batch against 67e12/s
    assert _reader("cascade_mfu")(d, ctx) == pytest.approx(100.0 * 6.7e9 / (0.5 * 67e12))
    assert _reader("launches_per_step.train")(d, {"kind": "train"}) == pytest.approx(1.0)
    empty = TraceData((0.0, 1.0), 2, [("elementwise", 0.0, 0.1)])
    assert _reader("k1_ms_per_step")(empty, ctx) is None
    assert _reader("k1_roofline")(empty, ctx) is None
