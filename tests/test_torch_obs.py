"""The port's spans and counters (feedback_gnn_tpu_torch/obs.py), on the CPU.

Off records nothing; on records nesting, parents and batches on the
profiler's clock; the profiler's own flag turns it on; memory stays
bounded; the instrumented evaluation step records every stage span in
every batch, covering the step; the capacity counters equal the flags
recomputed from the step's own decodes; the launch registry counts what
the module globals used to.
"""

import contextlib
import json
import statistics
import time
import types
from collections import Counter
from dataclasses import replace

import pytest
import torch
import torch.profiler as tp

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import _build, obs
from feedback_gnn_tpu_torch.decoders import bp2_qc, bp4_qc
from feedback_gnn_tpu_torch.decoders import cascade as tcas
from feedback_gnn_tpu_torch.decoders.compact import capacity
from feedback_gnn_tpu_torch.decoders.gnn_feedback import load_weights
from feedback_gnn_tpu_torch.entry import WEIGHTS
from feedback_gnn_tpu_torch.ops import mod2_matmul
from feedback_gnn_tpu_torch.sim import sim_ler

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
CFG = tcas.CascadeConfig(num_iter1=8, num_iter2=4, num_rounds=2, compact_fraction=0.5, stage1_prepass=4,
                         round_fraction=0.25, qc_batch_tile=8)
STAGES = ("step.sample", "cascade.bp", "cascade.gnn", "cascade.compact", "step.account")


@pytest.fixture(autouse=True)
def fresh_registry():
    """Each test starts and ends with tracing off and nothing recorded."""
    obs.enable(False)
    obs.reset()
    yield
    obs.enable(False)
    obs.reset()


@pytest.fixture(scope="module")
def gb48():
    torch.set_num_threads(1)  # several test workers share the cores
    code = tc.create_generalized_bicycle_codes(*GB48)
    graph = tc.QuantumGraph.from_code(code, stage_mode=True).to("cpu")
    params = load_weights(WEIGHTS["n882"], "cpu")  # trained weights: the rounds converge some samples
    return graph, tc.qc_pair_from_code(code), params


def _step(gb48, batch, cfg=CFG):
    graph, qc, params = gb48

    def step(gen, p):
        return tcas.sandwich_eval_step(graph, [params], cfg, gen, p, batch, qc=qc, return_overflow=True)

    return step


def _profiler():
    return tp.profile(activities=[tp.ProfilerActivity.CPU])


def test_off_records_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", lambda *a: made.append(a))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(a))
    assert not obs.on()
    assert obs.span("a", x=1) is obs.NULL and obs.begin("b") is obs.NULL
    with obs.span("a"):
        with obs.span("b", round=0):
            pass
    obs.begin("c").close()
    obs.count_device("d", torch.ones(3, dtype=torch.bool))
    obs.end_batch()
    snap = obs.snapshot()
    assert made == [] and obs.recent() == []
    assert snap == {"batches": 0, "spans": {}, "counters": {}, "keys": {}}
    with pytest.raises(TypeError):
        obs.span("a")(len)  # a per-batch span decorates nothing


def test_on_records_nesting_parents_and_batches():
    obs.enable()
    assert obs.on()
    with obs.span("outer", stage="x"):
        with obs.span("inner", round=1):
            pass
    gap = obs.begin("between")
    obs.end_batch()  # folds batch 0's spans
    gap.close()
    with obs.span("outer", stage="y"):
        pass
    rec = obs.recent()
    assert [(r["name"], r["parent"], r["batch"]) for r in rec] == [("between", None, 0), ("outer", None, 1)]
    assert all(r["t0_ns"] <= r["t1_ns"] for r in rec)
    snap = obs.snapshot()
    assert snap["batches"] == 1
    assert snap["spans"]["outer"]["count"] == 2 and snap["spans"]["inner"]["count"] == 1
    assert set(snap["spans"]["outer"]["by"]["stage"]) == {"x", "y"}
    assert snap["spans"]["inner"]["by"]["round"][1]["count"] == 1
    for s in snap["spans"].values():  # the CPU's device time is its host time
        assert s["device_s"] == s["host_s"] >= 0
    assert obs.recent() == []


def test_parent_recorded_before_folding():
    obs.enable()
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    assert [(r["name"], r["parent"], r["batch"]) for r in obs.recent()] == [("inner", "outer", 0),
                                                                            ("outer", None, 0)]


def test_host_times_on_the_profilers_clock(tmp_path):
    """A span's host start and end agree with its record_function range in
    the exported trace: ts (us) + baseTimeNanoseconds, Unix time."""
    with _profiler() as prof:
        for i in range(20):
            with obs.span(f"clock{i}"):
                time.sleep(1e-3)
    mine = {r["name"]: r for r in obs.recent()}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    starts, ends = [], []
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") in mine and e.get("cat") == "user_annotation":
            r = mine[e["name"]]
            starts.append(abs(base + float(e["ts"]) * 1e3 - r["t0_ns"]))
            ends.append(abs(base + (float(e["ts"]) + float(e["dur"])) * 1e3 - r["t1_ns"]))
    assert len(starts) == 20
    assert statistics.median(starts) <= 200e3 and statistics.median(ends) <= 200e3


def test_the_profiler_flag_turns_it_on():
    # obs reads this flag of torch's: a torch that moves it fails here
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert not obs.on()
    with _profiler():
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert obs.on()
        with obs.span("traced"):
            pass
        obs.end_batch()
    assert not obs.on()
    with obs.span("untraced"):
        pass
    snap = obs.snapshot()
    assert snap["batches"] == 1 and set(snap["spans"]) == {"traced"}


def test_setup_spans_record_with_tracing_off():
    @obs.setup("code", fn="f")
    def f(x):
        return x + 1

    assert f(1) == 2 and f(2) == 3
    with obs.setup("kernels"):
        pass
    snap = obs.snapshot()
    assert snap["spans"]["setup.code"]["count"] == 2
    assert snap["spans"]["setup.code"]["by"]["fn"]["f"]["count"] == 2
    assert snap["spans"]["setup.kernels"]["count"] == 1
    assert obs.recent() == []  # folded at once: no batch boundary comes with tracing off


def test_memory_stays_bounded_over_many_batches():
    obs.enable()
    for _ in range(10_000):
        with obs.span("a"):
            with obs.span("b"):
                pass
        obs.count("c", 2)
        obs.count_device("d", torch.ones(3, dtype=torch.bool))
        obs.end_batch()
        assert obs.recent() == []
    snap = obs.snapshot()
    assert snap["batches"] == 10_000
    assert snap["spans"]["a"]["count"] == snap["spans"]["b"]["count"] == 10_000
    assert snap["counters"]["c"] == 20_000 and snap["counters"]["d"] == 30_000


def test_eval_step_records_every_stage_in_every_batch(gb48, tmp_path):
    """Under a CPU profiler every batch records each stage span, the stage
    spans cover at least 95 % of the step's wall time, and every operation
    from a batch's first stage to its last runs inside a stage span."""
    step = _step(gb48, 512)
    gen = torch.Generator()
    step(gen.manual_seed(1), 0.06)  # warm-up, untraced
    batches, walls = 3, []
    with _profiler() as prof:
        for i in range(batches):
            t0 = time.perf_counter()
            step(gen.manual_seed(10 + i), 0.06)
            walls.append(time.perf_counter() - t0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    stages = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in STAGES)
    firsts = [a for a, _, name in stages if name == "step.sample"]
    lasts = [b for _, b, name in stages if name == "step.account"]
    assert len(firsts) == len(lasts) == batches
    outside = [e["name"] for e in events if e.get("cat") == "cpu_op"
               and any(a <= float(e["ts"]) <= b for a, b in zip(firsts, lasts))
               and not any(a <= float(e["ts"]) <= b for a, b, _ in stages)]
    assert outside == []
    snap = obs.snapshot()
    rounds = CFG.num_rounds
    assert snap["batches"] == batches
    count = {name: s["count"] for name, s in snap["spans"].items()}
    # a compaction span before and after the level-1 decode, two a round, the
    # scatter back and the overflow count
    assert count == {"step.sample": batches, "step.account": batches, "cascade.bp": batches * (2 + rounds),
                     "cascade.gnn": batches * rounds, "cascade.compact": batches * (2 + 2 * rounds + 2)}
    by_stage = snap["spans"]["cascade.bp"]["by"]["stage"]
    assert {k: v["count"] for k, v in by_stage.items()} == {"prepass": batches, "level1": batches,
                                                            "round": batches * rounds}
    assert sorted(snap["spans"]["cascade.gnn"]["by"]["round"]) == list(range(rounds))
    covered = sum(snap["spans"][name]["host_s"] for name in STAGES)
    assert covered >= 0.95 * sum(walls)


def test_sim_ler_records_the_gaps_between_batches(gb48):
    obs.enable()
    sim_ler(_step(gb48, 64), [0.06], 64, 3, num_target_block_errors=None, early_stop=False, verbose=False,
            device="cpu")
    snap = obs.snapshot()
    assert snap["batches"] == 3
    assert snap["spans"]["sim.host_gap"]["count"] == snap["spans"]["sim.between_batches"]["count"] == 3
    assert obs.recent() == []


def _differ(graph, x_hat, z_hat, syn_x, syn_z):
    return ((mod2_matmul(graph.hz, x_hat) != syn_z).any(dim=0)
            | (mod2_matmul(graph.hx, z_hat) != syn_x).any(dim=0))


def test_flagged_counters_equal_the_recomputed_flags(gb48, monkeypatch):
    """Each level's flagged count is the sum of the flags the compaction
    ordered by; each round's, the samples of the round sub-batch still
    flagged after the decodes before it; each capacity its sub-batch."""
    graph, qc, params = gb48
    flags, decodes = [], []
    first, decode = tcas.flagged_first, tcas.bp4_decode_qc

    def flagged_first(f, cap):
        out = first(f, cap)
        flags.append((f, out[1]))
        return out

    def bp(graph_, qc_, llr, syn_x, syn_z, *args, **kw):
        res = decode(graph_, qc_, llr, syn_x, syn_z, *args, **kw)
        decodes.append((syn_x, syn_z, res))
        return res

    monkeypatch.setattr(tcas, "flagged_first", flagged_first)
    monkeypatch.setattr(tcas, "bp4_decode_qc", bp)
    cfg = replace(CFG, num_iter1=16, num_iter2=16)
    batch, rounds = 512, cfg.num_rounds
    obs.enable()
    _step(gb48, batch, cfg)(torch.Generator().manual_seed(3), 0.05)
    counters = obs.snapshot()["counters"]

    (flags0, _), (flags1, valid2) = flags
    cap = capacity(cfg.compact_fraction, batch, cfg.qc_batch_tile)
    cap2 = min(cap, capacity(cfg.round_fraction, batch, cfg.qc_batch_tile))
    errors, in_rounds = valid2, 0
    for syn_x, syn_z, res in decodes[2:]:  # the rounds' decodes, after the prepass and level 1
        in_rounds += int(errors.sum())
        errors = errors & _differ(graph, res.x_hat, res.z_hat, syn_x, syn_z)
    assert len(decodes) == 2 + rounds
    # every level partly filled, and a round converges some of its samples
    assert 0 < int(flags1.sum()) <= cap2 and 0 < int(flags0.sum()) <= cap
    assert in_rounds < rounds * int(flags1.sum())
    assert counters == {
        "cascade.flagged.level1": int(flags0.sum()), "cascade.capacity.level1": cap,
        "cascade.flagged.level2": int(flags1.sum()), "cascade.capacity.level2": cap2,
        "cascade.flagged.round": in_rounds, "cascade.capacity.round": rounds * cap2,
    }


def test_flagged_counters_count_nothing_when_off(gb48):
    _step(gb48, 64)(torch.Generator().manual_seed(3), 0.08)
    assert obs.snapshot()["counters"] == {}


def test_launch_registry_counts_what_the_globals_did(monkeypatch):
    """K1 and K2 counted one a launch, K1 keyed by its launch shape and its
    launch under the span k1.kernel; the plain versions count nothing.  The
    launch is faked (the kernels run only on a card)."""
    fake = types.SimpleNamespace(fgt_bp4_qc_launch=lambda *a: 0, fgt_bp2_qc_launch=lambda *a: 0)
    monkeypatch.setattr(_build, "load_kernels", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    qc = tc.qc_pair_from_code(tc.create_generalized_bicycle_codes(*GB48))
    n, mx, mz = qc.n, qc.qx.mb * qc.l, qc.qz.mb * qc.l
    shapes = [(32, 8, "boxplus-phi", None, "float32"), (32, 8, "boxplus-phi", None, "float32"),
              (16, 4, "minsum", None, "bfloat16"), (8, 2, "boxplus-phi", "tf", "float32")]
    obs.enable()
    for b, iters, cn, phi, msg in shapes:
        bp4_qc._launch_kernel(qc, torch.zeros(3, n, b), torch.zeros(mx, b), torch.zeros(mz, b), iters, cn, 1.0,
                              phi, msg_dtype=msg)
    bp4_qc._launch_kernel(qc, torch.zeros(3, n, 0), torch.zeros(mx, 0), torch.zeros(mz, 0), 8, "minsum", 1.0,
                          None)  # an empty batch launches nothing
    for b in (32, 64):
        bp2_qc._launch_kernel(qc.qx, torch.zeros(n, b), torch.zeros(mx, b), 8, "minsum", 1.0)
    bp4_qc.bp4_qc_marginals(qc, torch.zeros(3, n, 8), torch.zeros(mx, 8), torch.zeros(mz, 8), 2)  # plain
    snap = obs.snapshot()
    assert obs.counter("k1.launches") == snap["counters"]["k1.launches"] == len(shapes)
    assert snap["keys"]["k1.launches"] == Counter(shapes)
    assert obs.counter("k2.launches") == 2 and "k2.launches" not in snap["keys"]
    assert snap["spans"]["k1.kernel"]["count"] == len(shapes)
    for module in (bp4_qc, bp2_qc):
        assert not hasattr(module, "launches")
