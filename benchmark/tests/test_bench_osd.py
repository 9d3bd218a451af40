"""The BP4 + OSD-0 cell on the CPU at small batches: the kind and its files
are found by name, the port (K1's plain version here) agrees with the
reference at --trace 0 and 1, and the check comes out false for a sort that
breaks ties otherwise, an OSD sub-batch too small for the flagged samples
and a flipped OSD bit, and for K1's bfloat16 carry; the OSD readers read
fixed traces to known values, and OSD's bound counts the flagged samples,
not the sub-batch's padding, at the operations of forward elimination that
the reference counts.

The runs take the cell's configuration and mix with fewer BP iterations, a
higher p and one traced step (``small``), so that OSD has work at a batch
of a few dozen."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import osd, osd_counts, run
from benchmark.harness import load_json
from benchmark.reference import osd as ref_osd
from benchmark.run import find_kind, load_run, read_metric, run_cell
from benchmark.trace import TraceData

CELL = "n882_bp4_osd.osd_p10"
BATCH = 32
SEED = 2**33 + 4242  # a seed wider than 32 bits


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.fixture
def small(monkeypatch):
    """The cell with ``small.iters`` BP iterations (20 unless set), p =
    0.13, one traced step and the OSD capacity ``small.cap`` (the batch
    unless set)."""
    load = run.load_json

    class Small:
        cap = BATCH
        iters = 20

    def patched(path):
        data = load(path)
        if path.endswith(os.path.join("traffic", "osd_p10.json")):
            data.update(p=0.13, trace_skip=0, trace_steps=1, osd_cap=Small.cap)
        elif path.endswith("n882_bp4_osd.json"):
            data["decoder"] = dict(data["decoder"], num_iter=Small.iters)
        return data

    monkeypatch.setattr(run, "load_json", patched)
    return Small


def _run(trace=False, seed=SEED, **kw):
    return run_cell(CELL, seed, 1e-6, trace, device="cpu", batch=BATCH, t_start=time.perf_counter(), **kw)


def test_the_kind_and_every_file_are_found_by_name():
    m = load_json("BENCHMARK.json")
    cell = next(w for w in m["workloads"] if w["name"] == CELL)
    conf = next(c for c in m["configs"] if c["name"] == cell["config"])
    assert cell["chips"] == 1 and conf["reduced"] == [] and "weights" not in load_json(conf["file"])
    assert find_kind(load_json(f"benchmark/traffic/{cell['traffic']}.json")["kind"]) is osd
    assert set(load_json(f"benchmark/limits/{CELL}.json")) == {"llr_gap", "mismatches", "overflow",
                                                              "batches_unchecked"}
    mine = {x["name"] for x in m["end_to_end"] + m["per_layer"] if CELL in x.get("workloads", [CELL])}
    assert {"syndromes_per_s", "setup_s", "osd_ms_per_step", "osd_compact_ms_per_step", "capacity_fill.osd",
            "osd_roofline", "osd_step_mfu", "osd_bp_wrapper_ms_per_step", "k1_ms_per_step", "k1_roofline"} <= mine


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_port_equals_reference(small, trace):
    res, out = _run(trace)
    assert res["correct"], out.notes
    checks = res["checks"]
    assert checks["llr_gap"]["value"] == 0.0 and checks["mismatches"]["value"] == 0
    assert checks["overflow"]["value"] == 0 and checks["batches_unchecked"]["value"] == 0
    assert out.context["loop"] == "eval" and out.context["k1_launches"] == 1
    assert out.context["osd_ranks"] == (429, 429) and out.context["osd_ops_per_sample"] > 0
    assert torch.backends.cuda.matmul.allow_tf32 is False  # the reference's check sets TF32 off
    if trace:  # the program's spans and counters are read; the trace's kernels are the card's
        for name in ("osd_ms_per_step", "osd_compact_ms_per_step", "capacity_fill.osd", "osd_roofline",
                     "osd_step_mfu", "osd_bp_wrapper_ms_per_step", "syndrome_ms_per_step",
                     "device_idle_share.eval"):
            assert name in res["metrics"], name
        assert 0 < res["metrics"]["capacity_fill.osd"]["value"] <= 100
    else:
        assert set(res["metrics"]) == {"syndromes_per_s", "setup_s"}
    json.dumps(res)


def test_unstable_sort_is_caught(small):
    """Ties in the reliabilities change OSD-0's solution only where they
    straddle the last pivots, which few samples meet: after two BP
    iterations most reliabilities tie, and some of three seeds' checked
    batches meet such a sample.  Every mismatch is an OSD solution's."""
    small.iters = 2
    caught = 0
    undo = osd.plant_fault("unstable_sort")
    try:
        for seed in (SEED, 5, 77):
            res, out = _run(seed=seed)
            bad = res["checks"]["mismatches"]["value"]
            caught += bad > 0
            assert res["correct"] is (bad == 0)
            assert all(" solution: " in n for n in out.notes[1:]), out.notes
    finally:
        undo()
    assert caught >= 1


def test_an_overflowing_sub_batch_is_caught(small):
    small.cap = 1
    res, out = _run()
    assert res["correct"] is False
    assert res["checks"]["overflow"]["value"] > 0, out.notes


def test_a_flipped_osd_bit_is_caught(small, monkeypatch):
    from feedback_gnn_tpu_torch.decoders import osd as osd_mod

    orig = osd_mod.osd0_decode

    def flipped(llr, pcm, syndrome):
        out = orig(llr, pcm, syndrome).clone()
        out[0, 5] ^= 1
        return out

    monkeypatch.setattr(osd_mod, "osd0_decode", flipped)
    res, out = _run()
    assert res["correct"] is False
    assert res["checks"]["mismatches"]["value"] > 0, out.notes


def test_the_bf16_control_breaks_the_llr_gap(small):
    r = load_run(CELL, SEED, 0.0, False, device="cpu", batch=BATCH)
    got = osd.readings(r, control="bf16")
    assert got["llr_gap"] > load_json(f"benchmark/limits/{CELL}.json")["llr_gap"]
    assert got["mismatches"] == 0  # everything after the decode is recomputed from its own marginals


def test_readings_refuse_what_they_do_not_know():
    r = load_run(CELL, SEED, 0.0, False, device="cpu", batch=BATCH)
    with pytest.raises(ValueError):
        osd.readings(r, control="tf32")
    with pytest.raises(ValueError):
        osd.readings(r, fault="half_batch")


def test_a_program_without_the_qc_step_fails_at_once(monkeypatch):
    from feedback_gnn_tpu_torch import models

    monkeypatch.setattr(models, "bp4_osd_eval_step", lambda graph, code, generator, p, batch, **kw: None)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="takes no qc"):
        _run()
    assert time.perf_counter() - t0 < 5.0


def test_reference_osd0_equals_the_program_on_tied_reliabilities():
    import feedback_gnn_tpu_torch.codes as tc
    from feedback_gnn_tpu_torch.decoders.osd import osd0_decode

    code = tc.create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17])
    rng = np.random.default_rng(3)
    for h, piv in ((code.hx, code.pivot_hx), (code.hz, code.pivot_hz)):
        assert ref_osd.pivot_rows(h).tolist() == list(piv)
        basis = np.asarray(h)[piv]
        rank, n = basis.shape
        values = np.array([0.0, -0.0, 1.5, -2.0], np.float32)
        llr = torch.as_tensor(values[rng.integers(0, 4, (40, n))])
        syn = torch.as_tensor((basis @ rng.integers(0, 2, (n, 40)) % 2).astype(np.int32))
        want = osd0_decode(llr, basis, syn)
        for block in (1, 7, 64):
            assert torch.equal(ref_osd.osd0(llr, basis, syn, block=block)[0], want)


def _snapshot(monkeypatch, spans, counters, batches=10):
    from feedback_gnn_tpu_torch import obs

    snap = {"batches": batches, "spans": {k: {"count": 1, "host_s": v, "device_s": v, "by": {}}
                                          for k, v in spans.items()},
            "counters": counters, "keys": {}}
    monkeypatch.setattr(obs, "snapshot", lambda: snap)


# per flagged sample (both sides): OPS integer operations at 64 a clock on 132 SMs at 1.98 GHz
OPS = 2.8e5
SAMPLE_MS = OPS / (132 * 64 * 1.98e9) * 1e3
CONTEXT = dict(kind="osd", loop="eval", k1_bound_ms=3.0, gf2_bound_ms=0.5, osd_ranks=(429, 429), n=882,
               osd_ops_per_sample=OPS)


def test_osd_readers_read_fixed_traces(monkeypatch):
    _snapshot(monkeypatch, {"osd.eliminate": 2.0, "osd.flag": 0.03, "osd.compact": 0.01, "osd.bp": 0.9,
                            "k1.kernel": 0.5}, {"osd.flagged": 7000, "osd.capacity": 10240})
    trace = TraceData((0.0, 4.0), 10, [("bp4_qc_kernel<...>", 0.0, 0.5)])
    assert read_metric("osd_ms_per_step", trace, CONTEXT) == pytest.approx(200.0)
    assert read_metric("osd_compact_ms_per_step", trace, CONTEXT) == pytest.approx(4.0)
    assert read_metric("capacity_fill.osd", trace, CONTEXT) == pytest.approx(100 * 7000 / 10240)
    assert read_metric("osd_roofline", trace, CONTEXT) == pytest.approx(100 * 7000 * SAMPLE_MS / 2000.0)
    # per batch: K1 3.0 + GF(2) 0.5 + OSD 700 samples, over 400 ms of window a batch
    assert read_metric("osd_step_mfu", trace, CONTEXT) == pytest.approx(100 * (3.5 + 700 * SAMPLE_MS) / 400.0)
    assert read_metric("osd_step_mfu", trace, dict(CONTEXT, kind="mc")) is None
    # the BP wrapper: osd.bp less its child k1.kernel, over 10 batches
    assert read_metric("osd_bp_wrapper_ms_per_step", trace, CONTEXT) == pytest.approx(40.0)


def test_osd_bound_counts_flagged_samples_not_the_cap(monkeypatch):
    assert osd_counts.osd_bound_ms(700, OPS) == pytest.approx(700 * SAMPLE_MS)
    trace = TraceData((0.0, 4.0), 10, [])
    reads = []
    for capacity in (7168, 10240, 20480):  # the same flagged samples in sub-batches of more padding
        _snapshot(monkeypatch, {"osd.eliminate": 2.0}, {"osd.flagged": 7000, "osd.capacity": capacity})
        reads.append(read_metric("osd_roofline", trace, CONTEXT))
    assert reads[0] == reads[1] == reads[2]
    # an overflowing sub-batch decodes only its capacity
    _snapshot(monkeypatch, {"osd.eliminate": 2.0}, {"osd.flagged": 7000, "osd.capacity": 5120})
    assert read_metric("osd_roofline", trace, CONTEXT) == pytest.approx(reads[0] * 5120 / 7000)


def test_osd_readers_are_silent_without_the_programs_record(monkeypatch):
    _snapshot(monkeypatch, {}, {}, batches=0)
    trace = TraceData((0.0, 4.0), 10, [])
    for name in ("osd_ms_per_step", "osd_compact_ms_per_step", "capacity_fill.osd", "osd_roofline",
                 "osd_step_mfu", "osd_bp_wrapper_ms_per_step"):
        assert read_metric(name, trace, CONTEXT) is None, name
    # the program's record without the reference's count of operations: no bound
    _snapshot(monkeypatch, {"osd.eliminate": 2.0}, {"osd.flagged": 7000, "osd.capacity": 10240})
    for name in ("osd_roofline", "osd_step_mfu"):
        assert read_metric(name, trace, dict(CONTEXT, osd_ops_per_sample=None)) is None, name


def _forward_ops(llr, basis, syn):
    """Each sample's 32-bit operations of forward elimination, written out
    column by column: at each row's pivot (its leftmost one once cleared),
    a test of each row below, and a XOR of each word from the pivot's on
    of each row below holding a one there."""
    rank, n = basis.shape
    words = -(-(n + 1) // 32)
    out = []
    for b in range(llr.shape[0]):
        order = np.argsort(llr[b], kind="stable")
        t = np.concatenate([basis[:, order], syn[:, b:b + 1]], axis=1) % 2
        ops = 0
        for r in range(rank):
            piv = int(np.flatnonzero(t[r, :n])[0])
            below = r + 1 + np.flatnonzero(t[r + 1:, piv])
            t[below] ^= t[r]
            ops += (rank - 1 - r) + below.size * (words - piv // 32)
        out.append(ops)
    return out


@pytest.mark.parametrize("side", ["x", "z"])
def test_reference_counts_the_operations_of_forward_elimination(side):
    import feedback_gnn_tpu_torch.codes as tc

    code = tc.create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17])
    h, piv = (code.hx, code.pivot_hx) if side == "x" else (code.hz, code.pivot_hz)
    basis = np.asarray(h)[piv].astype(np.int64)
    rng = np.random.default_rng(5)
    llr = rng.normal(size=(12, basis.shape[1])).astype(np.float32)
    llr[:4] = np.round(llr[:4])  # ties
    syn = basis @ rng.integers(0, 2, (basis.shape[1], 12)) % 2
    _, ops = ref_osd.osd0(torch.as_tensor(llr), basis, torch.as_tensor(syn.astype(np.int32)), block=5)
    rank = basis.shape[0]
    assert ops.tolist() == _forward_ops(llr, basis, syn)
    assert all(x > rank * (rank - 1) // 2 for x in ops.tolist())  # some XORs beside the tests
    # an identity basis is already eliminated: its row tests alone, 7 + 6 + ... + 0
    eye = np.eye(8, 20, dtype=np.int64)
    _, tests = ref_osd.osd0(torch.zeros(3, 20), eye, torch.ones(8, 3, dtype=torch.int32))
    assert tests.tolist() == [28, 28, 28]
