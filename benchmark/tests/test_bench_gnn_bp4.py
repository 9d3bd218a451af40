"""The GNN_BP4 cell on the CPU at a small batch: the kind and its files are
found by name, the port agrees with the reference at --trace 0 and 1, each
planted fault and both lower-precision controls fail the check, a program
without the CLI mode fails at once, and the GNN_BP4 readers read fixed
traces to known values and nothing from a program without the spans."""

import json
import os
import time

import pytest
import torch

from benchmark import gnn_bp4, gnn_bp4_counts, run
from benchmark.harness import load_json
from benchmark.run import find_kind, load_run, read_metric, run_cell
from benchmark.trace import TraceData

CELL = "n882_gnn_bp4.gnn_p03"
BATCH = 24
SEED = 2**33 + 4242  # a seed wider than 32 bits
NEW = ("gnn_bp4_ms_per_step", "gnn_bp4_msg_ms_per_step", "gnn_bp4_logits_ms_per_step", "gnn_bp4_roofline",
       "gnn_bp4_step_mfu")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.fixture
def one_traced_step(monkeypatch):
    load = run.load_json

    def patched(path):
        data = load(path)
        if path.endswith(os.path.join("traffic", "gnn_p03.json")):
            data.update(trace_skip=0, trace_steps=1)
        return data

    monkeypatch.setattr(run, "load_json", patched)


def _run(trace=False, seed=SEED):
    return run_cell(CELL, seed, 1e-6, trace, device="cpu", batch=BATCH, t_start=time.perf_counter())


def test_the_kind_and_every_file_are_found_by_name():
    m = load_json("BENCHMARK.json")
    cell = next(w for w in m["workloads"] if w["name"] == CELL)
    conf = next(c for c in m["configs"] if c["name"] == cell["config"])
    assert cell["chips"] == 1 and conf["reduced"] == []
    assert os.path.exists(os.path.join(run.ROOT, load_json(conf["file"])["weights"]))
    assert find_kind(load_json(f"benchmark/traffic/{cell['traffic']}.json")["kind"]) is gnn_bp4
    assert set(load_json(f"benchmark/limits/{CELL}.json")) == {"llr_gap", "mismatches", "batches_unchecked"}
    mine = {x["name"] for x in m["end_to_end"] + m["per_layer"] if CELL in x.get("workloads", [CELL])}
    assert set(NEW) | {"syndromes_per_s", "setup_s", "device_idle_share.eval", "syndrome_ms_per_step",
                       "idle_between_batches_ms_per_step", "host_gap_ms_per_step", "setup_code_s",
                       "setup_kernels_s"} == mine
    for name in NEW:
        assert os.path.exists(os.path.join(run.ROOT, "benchmark", "metrics", f"{name}.py"))


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_port_equals_reference(one_traced_step, trace):
    res, out = _run(trace)
    assert res["correct"], out.notes
    checks = res["checks"]
    assert checks["llr_gap"]["value"] <= 1e-5 and checks["mismatches"]["value"] == 0
    assert checks["batches_unchecked"]["value"] == 0
    assert out.context["loop"] == "eval" and out.context["gnn_bp4_decodes"] == 1
    assert out.context["gf2_products"] == 6  # two syndromes, four accounting products
    assert torch.backends.cuda.matmul.allow_tf32 is False
    if trace:
        for name in NEW + ("syndrome_ms_per_step", "device_idle_share.eval", "idle_between_batches_ms_per_step",
                           "host_gap_ms_per_step", "setup_code_s"):
            assert name in res["metrics"], name
    else:
        assert set(res["metrics"]) == {"syndromes_per_s", "setup_s"}
    json.dumps(res)


@pytest.mark.parametrize("fault", gnn_bp4.FAULTS)
def test_each_planted_fault_fails_its_check(fault):
    r = load_run(CELL, SEED, 0.0, False, device="cpu", batch=BATCH)
    got = gnn_bp4.readings(r, fault=fault)
    limits = load_json(f"benchmark/limits/{CELL}.json")
    assert got["llr_gap"] > limits["llr_gap"] or got["mismatches"] > 0, got
    if fault == "iteration_left_out":
        assert got["mismatches"] > 0 and "CN updates" in got["notes"][0]


@pytest.mark.parametrize("control", gnn_bp4.CONTROLS)
def test_both_controls_break_the_llr_gap(control):
    r = load_run(CELL, SEED, 0.0, False, device="cpu", batch=BATCH)
    got = gnn_bp4.readings(r, control=control)
    assert got["llr_gap"] > load_json(f"benchmark/limits/{CELL}.json")["llr_gap"]


def test_readings_refuse_what_they_do_not_know():
    r = load_run(CELL, SEED, 0.0, False, device="cpu", batch=BATCH)
    with pytest.raises(ValueError):
        gnn_bp4.readings(r, control="fp16")
    with pytest.raises(ValueError):
        gnn_bp4.readings(r, fault="unstable_sort")


def test_a_program_without_the_cli_mode_fails_at_once(monkeypatch):
    from feedback_gnn_tpu_torch.cli import osd_eval

    make = osd_eval.make_parser

    def without_mode():
        ap = make()
        next(a for a in ap._actions if "--mode" in a.option_strings).choices.remove("gnn-bp4")
        return ap

    monkeypatch.setattr(osd_eval, "make_parser", without_mode)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="no --mode gnn-bp4"):
        _run()
    assert time.perf_counter() - t0 < 5.0


def _snapshot(monkeypatch, spans, batches=10):
    from feedback_gnn_tpu_torch import obs

    snap = {"batches": batches, "spans": {k: {"count": 1, "host_s": v, "device_s": v, "by": {}}
                                          for k, v in spans.items()},
            "counters": {}, "keys": {}}
    monkeypatch.setattr(obs, "snapshot", lambda: snap)


CONTEXT = dict(kind="gnn_bp4", loop="eval", gnn_bp4_bound_ms=150.0, gf2_bound_ms=0.5)


def test_readers_read_fixed_traces(monkeypatch):
    _snapshot(monkeypatch, {"gnn_bp4.decode": 16.0, "gnn_bp4.vn": 7.0, "gnn_bp4.cn": 6.5, "gnn_bp4.logits": 2.0})
    trace = TraceData((0.0, 8.5), 5, [("sgemm", 0.0, 8.0)])
    assert read_metric("gnn_bp4_ms_per_step", trace, CONTEXT) == pytest.approx(1600.0)
    assert read_metric("gnn_bp4_msg_ms_per_step", trace, CONTEXT) == pytest.approx(1350.0)
    assert read_metric("gnn_bp4_logits_ms_per_step", trace, CONTEXT) == pytest.approx(200.0)
    assert read_metric("gnn_bp4_roofline", trace, CONTEXT) == pytest.approx(100 * 150.0 / 1600.0)
    # per batch: the decode's 150 ms and the GF(2) products' 0.5 ms over 1700 ms of window a batch
    assert read_metric("gnn_bp4_step_mfu", trace, CONTEXT) == pytest.approx(100 * 150.5 / 1700.0)
    for name in ("gnn_bp4_roofline", "gnn_bp4_step_mfu"):
        assert read_metric(name, trace, dict(CONTEXT, kind="osd")) is None


def test_readers_are_silent_without_the_programs_record(monkeypatch):
    _snapshot(monkeypatch, {}, batches=0)
    trace = TraceData((0.0, 8.5), 5, [])
    for name in NEW[:4]:
        assert read_metric(name, trace, CONTEXT) is None, name
    assert read_metric("gnn_bp4_step_mfu", trace, dict(CONTEXT, gnn_bp4_bound_ms=None)) is None


def test_the_bound_at_the_cells_shape():
    from benchmark.reference.codes import build_code

    conf = load_json("benchmark/configs/n882_gnn_bp4.json")
    dims = gnn_bp4_counts.dims_of(build_code(conf["code"]))
    flops = gnn_bp4_counts.gnn_bp4_flops(dims, conf["gnn_bp4"], 20480)
    assert flops == pytest.approx(9.97e12, rel=1e-3)
    ms, what = gnn_bp4_counts.gnn_bp4_bound_ms(dims, conf["gnn_bp4"], 20480)
    assert what == "operations" and ms == pytest.approx(1e3 * flops / 67e12)
    assert gnn_bp4_counts.gnn_bp4_bytes(dims, conf["gnn_bp4"], 20480) / 3.35e12 < flops / 67e12
