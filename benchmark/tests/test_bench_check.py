"""The harness's runs on the CPU at small batches: the port (whose K1 takes
its plain version here) agrees with the reference, and the check comes out
false with the timed path broken underneath, for each fault a cell can
have, and for the lower-precision control.  The card's check is skipped
here: these tests call the run directly.

The training kind has no cell in BENCHMARK.json (its host-bound rate
spreads too widely for a bound, PERF.md §7); its runs and checks are held
to the same tests through a manifest that adds the cell."""

import json
import time

import pytest
import torch

from benchmark import mc, train
from benchmark.harness import load_json
from benchmark.run import load_run, run_cell

MC_BATCH, TRAIN_BATCH = 64, 8
SEED = 2**33 + 12345  # a seed wider than 32 bits
TRAIN = "n882_nG3.train_b100"


def with_train_cell():
    """BENCHMARK.json with the training cell and its end-to-end metric."""
    m = load_json("BENCHMARK.json")
    if all(w["name"] != TRAIN for w in m["workloads"]):
        m["workloads"].append({"name": TRAIN, "config": "n882_nG3", "traffic": "train_b100", "chips": 1,
                               "why": "the train step at B=100"})
        m["end_to_end"].insert(0, {"name": "train_samples_per_s", "unit": "samples/s", "better": "higher",
                                   "bound": 0.25, "source": "host_clock", "workloads": [TRAIN]})
    return m


def _run(workload, batch, **kw):
    return run_cell(workload, SEED, 1e-6, False, device="cpu", batch=batch, t_start=time.perf_counter(),
                    manifest=with_train_cell(), **kw)


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("workload,batch", [
    ("n882_nG3.mc_p08", MC_BATCH),
    ("n1270_nG5.mc_p05", MC_BATCH),
    (TRAIN, TRAIN_BATCH),
])
def test_port_equals_reference(workload, batch):
    res, out = _run(workload, batch)
    assert res["correct"], out.notes
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    if "mc" in workload:
        assert out.context["loop"] == "eval"  # the eval idle share reads it
        assert res["checks"]["llr_gap"]["value"] == 0.0
        assert res["checks"]["mismatches"]["value"] == 0
    json.dumps(res)


def _mc_faults(monkeypatch, fault):
    from feedback_gnn_tpu_torch.decoders import bp4_qc, cascade

    k1, step = bp4_qc.bp4_qc_marginals, cascade.sandwich_eval_step
    if fault == "state_unchanged":  # every decode hands back its input
        monkeypatch.setattr(bp4_qc, "bp4_qc_marginals", lambda qc, llr, sx, sz, it, *a, **k: tuple(llr.unbind(0)))
    elif fault == "half_batch":  # half of the batch decoded, its counts doubled
        def half(graph, params, cfg, gen, p, batch, **kw):
            return tuple(2 * c for c in step(graph, params, cfg, gen, p, batch // 2, **kw))
        monkeypatch.setattr(cascade, "sandwich_eval_step", half)
    elif fault == "count_altered":
        def more(*a, **kw):
            f, lg, ov = step(*a, **kw)
            return f, lg + 1, ov
        monkeypatch.setattr(cascade, "sandwich_eval_step", more)
    elif fault == "marginal_altered":
        def bent(*a, **kw):
            x, y, z = k1(*a, **kw)
            x = x.clone()
            x[0, 0] += 1.0
            return x, y, z
        monkeypatch.setattr(bp4_qc, "bp4_qc_marginals", bent)
    elif fault == "gnn_altered":
        gnn = cascade.feedback_gnn_apply

        def bent_gnn(*a, **kw):
            out = gnn(*a, **kw).clone()
            out[1, 2, 0] *= 1.5
            return out
        monkeypatch.setattr(cascade, "feedback_gnn_apply", bent_gnn)
    elif fault == "noise_altered":
        noise = cascade.pauli_iid

        def bent_noise(*a, **kw):
            nx, nz = noise(*a, **kw)
            nx = nx.clone()
            nx[3, 1] ^= True
            return nx, nz
        monkeypatch.setattr(cascade, "pauli_iid", bent_noise)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "count_altered", "marginal_altered",
                                   "gnn_altered", "noise_altered"])
def test_mc_fault_makes_the_run_incorrect(monkeypatch, fault):
    _mc_faults(monkeypatch, fault)
    res, out = _run("n882_nG3.mc_p08", MC_BATCH)
    assert res["correct"] is False, (fault, res["checks"], out.notes)


@pytest.mark.parametrize("fault", ["stops_early", "skips_a_step"])
def test_mc_loop_that_decodes_less_is_incorrect(monkeypatch, fault):
    from feedback_gnn_tpu_torch.sim import montecarlo

    sim_ler = montecarlo.sim_ler

    def loop(step, ps, batch, nbatches, **kw):
        if fault == "stops_early":  # one batch fewer than asked, reported as such
            return sim_ler(step, ps, batch, nbatches - 1, **kw)
        outs = []

        def skipping(gen, p):  # the second batch's counts are the first's, and it is not decoded
            if len(outs) == 1:
                outs.append(outs[0])
            else:
                outs.append(step(gen, p))
            return outs[-1]
        return sim_ler(skipping, ps, batch, nbatches, **kw)

    monkeypatch.setattr(montecarlo, "sim_ler", loop)
    res, out = _run("n882_nG3.mc_p08", MC_BATCH)
    assert res["correct"] is False
    assert res["checks"]["mismatches"]["value"] >= 1, (res["checks"], out.notes)


def test_mc_control_is_incorrect():
    res, _ = _run("n882_nG3.mc_p08", MC_BATCH, control="bf16")
    assert res["correct"] is False
    assert res["checks"]["llr_gap"]["value"] > res["checks"]["llr_gap"]["limit"]


@pytest.mark.parametrize("control", [None, "bf16"])
def test_mc_readings_are_the_checked_numbers_of_a_run(control):
    """What calibrate.py prints for an mc cell: the numbers a run with no
    window checks, and three lines of its notes."""
    r = load_run("n882_nG3.mc_p08", SEED, 0.0, False, device="cpu", batch=MC_BATCH, manifest=with_train_cell())
    got = mc.readings(r, control=control)
    _, out = _run("n882_nG3.mc_p08", MC_BATCH, control=control)
    assert got == {c.name: c.value for c in out.checks} | {"notes": out.notes[1:4]}


@pytest.mark.parametrize("fault", train.FAULTS)
def test_train_fault_makes_the_run_incorrect(fault):
    undo = train._patch_fault(fault)
    try:
        res, out = _run(TRAIN, TRAIN_BATCH)
    finally:
        undo()
    assert res["correct"] is False, (fault, res["checks"], out.notes)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_fault_in_the_window_makes_the_run_incorrect(monkeypatch, fault):
    """A step that turns faulty once warm, after the set-up's checked steps."""
    from feedback_gnn_tpu_torch.train import trainer

    make = trainer.make_train_step

    def make_warm_faulty(graph, cfg, optimizer):
        step, calls, last = make(graph, cfg, optimizer), [], []

        def faulty(params, opt_state, nx, nz):
            calls.append(1)
            if len(calls) > 3 and fault == "unchanged":
                return (params, opt_state) + tuple(last[-1][2:])
            if len(calls) > 3:
                h = nx.shape[1] // 2
                nx, nz = nx[:, :h], nz[:, :h]
            last.append(step(params, opt_state, nx, nz))
            return last[-1]
        return faulty

    monkeypatch.setattr(trainer, "make_train_step", make_warm_faulty)
    res, out = _run(TRAIN, TRAIN_BATCH)
    assert res["correct"] is False, (fault, res["checks"], out.notes)
    assert any(n.startswith("window step") for n in out.notes)


def test_main_refuses_without_a_card(capsys):
    from benchmark.run import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--workload", "n882_nG3.mc_p08", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
