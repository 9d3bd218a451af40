"""The readers of the program's spans and counters on synthetic snapshots:
each reads its number from the snapshot, and None from an empty one or from
a program without ``feedback_gnn_tpu_torch.obs``."""

import importlib.util
import os
import sys

import pytest

import feedback_gnn_tpu_torch
from feedback_gnn_tpu_torch import obs

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")
BATCHES = 10


def _reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(device_s, host_s=None):
    return {"count": BATCHES, "host_s": device_s if host_s is None else host_s, "device_s": device_s, "by": {}}


SNAPSHOT = {
    "batches": BATCHES,
    "spans": {
        "step.sample": _span(0.020), "step.account": _span(0.010),
        "cascade.compact": _span(0.150), "cascade.gnn": _span(0.300),
        "cascade.bp": _span(0.500), "k1.kernel": _span(0.230),
        "sim.between_batches": _span(0.025, host_s=0.030), "sim.host_gap": _span(0.001, host_s=0.004),
        "setup.code": _span(1.5, host_s=1.25), "setup.kernels": _span(0.5, host_s=0.0625),
    },
    "counters": {
        "cascade.flagged.level1": 2580, "cascade.capacity.level1": 3072,
        "cascade.flagged.level2": 512, "cascade.capacity.level2": 1024,
        "cascade.flagged.round": 1280, "cascade.capacity.round": 5120,
    },
    "keys": {},
}
EXPECTED = {
    "syndrome_ms_per_step": 3.0,  # (20 + 10 ms) / 10 batches
    "compaction_ms_per_step": 15.0,
    "gnn_ms_per_step": 30.0,
    "bp4_wrapper_ms_per_step": 27.0,  # (500 - 230 ms) / 10
    "idle_between_batches_ms_per_step": 2.5,  # device time
    "host_gap_ms_per_step": 0.4,  # host time
    "capacity_fill.level1": 100.0 * 2580 / 3072,
    "capacity_fill.level2": 50.0,
    "capacity_fill.rounds": 25.0,
    "setup_code_s": 1.25,  # host seconds
    "setup_kernels_s": 0.0625,
}
EMPTY = {"batches": 0, "spans": {}, "counters": {}, "keys": {}}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_snapshot(monkeypatch, name):
    monkeypatch.setattr(obs, "snapshot", lambda: SNAPSHOT)
    assert _reader(name)(None, {"kind": "mc"}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_from_an_empty_snapshot(monkeypatch, name):
    monkeypatch.setattr(obs, "snapshot", lambda: EMPTY)
    assert _reader(name)(None, {"kind": "mc"}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_without_the_programs_spans(monkeypatch, name):
    """A program without obs (the parent of the change that brought it)."""
    monkeypatch.delattr(feedback_gnn_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "feedback_gnn_tpu_torch.obs", None)
    assert _reader(name)(None, {"kind": "mc"}) is None


def test_bp4_wrapper_without_k1_is_all_of_bp(monkeypatch):
    """The gather backend runs no K1: the wrapper's time is every BP run's."""
    spans = {k: v for k, v in SNAPSHOT["spans"].items() if k != "k1.kernel"}
    monkeypatch.setattr(obs, "snapshot", lambda: dict(SNAPSHOT, spans=spans))
    assert _reader("bp4_wrapper_ms_per_step")(None, {"kind": "mc"}) == pytest.approx(50.0)


def test_every_new_reader_is_in_the_manifest():
    import json

    with open(os.path.join(os.path.dirname(METRICS), "..", "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in EXPECTED:
        assert per_layer[name]["source"] in ("program_span", "program_counter")
