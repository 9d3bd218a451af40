"""The gather BP4 cell on the CPU at a small batch: the kind and its files
are found by name, the port agrees with the reference at --trace 0 and 1,
each planted fault and the bfloat16 control fail the check, the family
builder refuses a matrix file other than the configured one, a program
without the CLI's --code fails at once, and the gather BP4 readers read
fixed traces to known values and nothing from a program without the spans."""

import json
import os
import shutil
import time

import pytest
import torch

from benchmark import gather_bp4, run
from benchmark.harness import load_json
from benchmark.reference import codes as ref_codes
from benchmark.reference import family_gb_oc
from benchmark.run import find_kind, load_run, read_metric, run_cell
from benchmark.trace import TraceData

CELL = "gb48oc_bp4.bp4_p02"
BATCH = 16
SEED = 2**33 + 2626  # a seed wider than 32 bits
NEW = ("gather_bp4_ms_per_step", "gather_bp4_vn_ms_per_step", "gather_bp4_cn_ms_per_step", "gather_bp4_roofline",
       "gather_bp4_step_mfu")


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
        if path.endswith(os.path.join("traffic", "bp4_p02.json")):
            data.update(trace_skip=0, trace_steps=1)
        return data

    monkeypatch.setattr(run, "load_json", patched)


@pytest.fixture
def more_noise(monkeypatch):
    """p = 0.08 for the bfloat16 control: at 16 samples and p = 0.02 the
    captured CN outputs are all alike (iteration 0) or reliable (10 to
    16.6), where a bfloat16 carry leaves no trace that float32 rounding
    does not leave too; the card's check captures 1,024 samples, whose
    undecided checks give the moderate outputs that p = 0.08 gives 16."""
    load = run.load_json

    def patched(path):
        data = load(path)
        if path.endswith(os.path.join("traffic", "bp4_p02.json")):
            data.update(p=0.08)
        return data

    monkeypatch.setattr(run, "load_json", patched)


def _run(trace=False, seed=SEED):
    return run_cell(CELL, seed, 1e-6, trace, device="cpu", batch=BATCH, t_start=time.perf_counter())


def test_the_kind_and_every_file_are_found_by_name():
    m = load_json("BENCHMARK.json")
    cell = next(w for w in m["workloads"] if w["name"] == CELL)
    conf = next(c for c in m["configs"] if c["name"] == cell["config"])
    assert cell["chips"] == 1 and conf["reduced"] == []
    assert find_kind(load_json(f"benchmark/traffic/{cell['traffic']}.json")["kind"]) is gather_bp4
    assert load_json(f"benchmark/limits/{CELL}.json") == {"llr_gap": 1e-3, "mismatches": 0, "batches_unchecked": 0}
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
    assert checks["llr_gap"]["value"] <= 1e-4 and checks["mismatches"]["value"] == 0
    assert checks["batches_unchecked"]["value"] == 0
    assert out.context["loop"] == "eval" and out.context["gather_bp4_decodes"] == 1
    assert out.context["gf2_products"] == 6  # two syndromes, four accounting products
    assert torch.backends.cuda.matmul.allow_tf32 is False
    if trace:
        for name in NEW + ("syndrome_ms_per_step", "device_idle_share.eval", "idle_between_batches_ms_per_step",
                           "host_gap_ms_per_step", "setup_code_s"):
            assert name in res["metrics"], name
    else:
        assert set(res["metrics"]) == {"syndromes_per_s", "setup_s"}
    json.dumps(res)


@pytest.mark.parametrize("fault", gather_bp4.FAULTS)
def test_each_planted_fault_fails_its_check(fault):
    r = load_run(CELL, SEED, 0.0, False, device="cpu", batch=BATCH)
    got = gather_bp4.readings(r, fault=fault)
    limits = load_json(f"benchmark/limits/{CELL}.json")
    assert got["llr_gap"] > limits["llr_gap"] or got["mismatches"] > 0, got
    if fault == "iteration_left_out":
        assert "63 VN updates" in got["notes"][0]
    if fault == "pad_slot_leak":
        assert got["llr_gap"] > limits["llr_gap"] and "pad slots" in got["notes"][0]


def test_the_bf16_control_breaks_the_llr_gap(more_noise):
    r = load_run(CELL, SEED, 0.0, False, device="cpu", batch=BATCH)
    limit = load_json(f"benchmark/limits/{CELL}.json")["llr_gap"]
    assert gather_bp4.readings(r)["llr_gap"] <= limit / 10
    got = gather_bp4.readings(r, control="bf16")
    assert got["llr_gap"] > limit and got["mismatches"] == 0


def test_readings_refuse_what_they_do_not_know():
    r = load_run(CELL, SEED, 0.0, False, device="cpu", batch=BATCH)
    with pytest.raises(ValueError):
        gather_bp4.readings(r, control="tf32")
    with pytest.raises(ValueError):
        gather_bp4.readings(r, fault="unstable_sort")


def test_the_family_builder_refuses_another_matrix(tmp_path, monkeypatch):
    spec = load_json("benchmark/configs/gb48oc_bp4.json")["code"]
    assert ref_codes.build_code(spec).n == 48
    copy = tmp_path / "feedback_gnn_tpu" / "codes" / "data"
    copy.mkdir(parents=True)
    shutil.copy(os.path.join(run.ROOT, spec["npz"]), copy)
    monkeypatch.setattr(family_gb_oc, "ROOT", str(tmp_path))
    assert ref_codes.build_code(spec).n == 48  # the same bytes elsewhere
    path = tmp_path / spec["npz"]
    raw = bytearray(path.read_bytes())
    raw[-30] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="SHA-256"):
        ref_codes.build_code(spec)


def test_a_program_without_the_code_option_fails_at_once(monkeypatch):
    from feedback_gnn_tpu_torch.cli import osd_eval

    make = osd_eval.make_parser

    def without_code():
        ap = make()
        action = next(a for a in ap._actions if "--code" in a.option_strings)
        ap._remove_action(action)
        return ap

    monkeypatch.setattr(osd_eval, "make_parser", without_code)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="no --code gb48_oc"):
        _run()
    assert time.perf_counter() - t0 < 5.0


def _snapshot(monkeypatch, spans, batches=10):
    from feedback_gnn_tpu_torch import obs

    snap = {"batches": batches, "spans": {k: {"count": 1, "host_s": v, "device_s": v, "by": {}}
                                          for k, v in spans.items()},
            "counters": {}, "keys": {}}
    monkeypatch.setattr(obs, "snapshot", lambda: snap)


CONTEXT = dict(kind="gather_bp4", loop="eval", gather_bp4_bound_ms=16.9, gf2_bound_ms=0.1)


def test_readers_read_fixed_traces(monkeypatch):
    _snapshot(monkeypatch, {"bp4.decode": 55.0, "bp4.vn": 21.0, "bp4.cn": 33.0, "bp4.logits": 0.05})
    trace = TraceData((0.0, 16.5), 3, [("add", 0.0, 16.0)])
    assert read_metric("gather_bp4_ms_per_step", trace, CONTEXT) == pytest.approx(5500.0)
    assert read_metric("gather_bp4_vn_ms_per_step", trace, CONTEXT) == pytest.approx(2100.0)
    assert read_metric("gather_bp4_cn_ms_per_step", trace, CONTEXT) == pytest.approx(3300.0)
    assert read_metric("gather_bp4_roofline", trace, CONTEXT) == pytest.approx(100 * 16.9 / 5500.0)
    # per batch: the decode's 16.9 ms and the GF(2) products' 0.1 ms over 5500 ms of window a batch
    assert read_metric("gather_bp4_step_mfu", trace, CONTEXT) == pytest.approx(100 * 17.0 / 5500.0)
    for name in ("gather_bp4_roofline", "gather_bp4_step_mfu"):
        assert read_metric(name, trace, dict(CONTEXT, kind="gnn_bp4")) is None


def test_readers_are_silent_without_the_programs_record(monkeypatch):
    _snapshot(monkeypatch, {}, batches=0)
    trace = TraceData((0.0, 16.5), 3, [])
    for name in NEW[:4]:
        assert read_metric(name, trace, CONTEXT) is None, name
    assert read_metric("gather_bp4_step_mfu", trace, dict(CONTEXT, gather_bp4_bound_ms=None)) is None
