"""The port's Monte-Carlo harness, plotting store, config and evaluate CLI
against the JAX package's.

``sim_ler`` of both packages is driven by the same deterministic stub step,
whose counts depend only on (point, iteration): the step finds them from
the key (JAX) or the generator's seed (port) that the harness derived for
that batch.  Checkpoints are the same JSON, so each package resumes the
other's.  The slice as a whole: scripts/evaluate.py's ``run`` and the
port's, with each package's channel sampler replaced by the same numpy
noise per (point, iteration), give equal counts.
"""

import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feedback_gnn_tpu import config as jconfig
from feedback_gnn_tpu.decoders import cascade as jcas
from feedback_gnn_tpu.sim import montecarlo as jmc

from feedback_gnn_tpu_torch import config as tconfig
from feedback_gnn_tpu_torch.decoders import cascade as tcas
from feedback_gnn_tpu_torch.sim import PlotLER, batch_seed, montecarlo, sim_ler

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTED = ("flagged_errors", "logical_errors", "num_blocks", "status", "overflow")


def jax_key_index(seed, npts, iters):
    """{key words: (point, iteration)} of the keys JAX's sim_ler derives."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), 0)  # process 0
    table = {}
    for i in range(npts):
        point = jax.random.fold_in(base, i)
        for it in range(iters):
            table[tuple(np.asarray(jax.random.fold_in(point, it)).tolist())] = (i, it)
    return table


def jax_key_noise(seed, npts, iters, make):
    """A replacement for a JAX sampler ``f(key, ...)``: the arrays
    ``make(point, iteration)`` of the batch whose key sim_ler derived, also
    under jit (a host callback on the key)."""
    table = jax_key_index(seed, npts, iters)
    shapes = tuple(jax.ShapeDtypeStruct(a.shape, jnp.bool_) for a in make(0, 0))

    def sampler(key, *rest):
        out = jax.pure_callback(lambda k: tuple(make(*table[tuple(np.asarray(k).tolist())])), shapes, key)
        return tuple(out) if len(out) > 1 else out[0]

    return sampler


def port_seed_noise(seed, npts, iters, make):
    """The same for a port sampler ``f(generator, ...)``, by the
    generator's seed."""
    table = {batch_seed(seed, 0, i, it): (i, it) for i in range(npts) for it in range(iters)}

    def sampler(generator, *rest):
        out = tuple(torch.as_tensor(a) for a in make(*table[generator.initial_seed()]))
        return out if len(out) > 1 else out[0]

    return sampler


def stub_counts(i, it, per_point):
    """Deterministic (flagged, logical, overflow) of batch (i, it)."""
    logical = per_point[i][it % len(per_point[i])]
    return logical + (i + it) % 3, logical, (it % 2) * (i + 1)


class Stubs:
    """The same stub step for both harnesses, counting its calls."""

    def __init__(self, seed, per_point, iters, overflow, interrupt_after=None):
        self.per_point, self.overflow, self.calls = per_point, overflow, 0
        self.interrupt_after = interrupt_after
        self.jtable = jax_key_index(seed, len(per_point), iters)
        self.ttable = {batch_seed(seed, 0, i, it): (i, it)
                       for i in range(len(per_point)) for it in range(iters)}

    def _out(self, i, it):
        self.calls += 1
        if self.interrupt_after is not None and self.calls > self.interrupt_after:
            raise KeyboardInterrupt
        c = stub_counts(i, it, self.per_point)
        return c if self.overflow else c[:2]

    def jax_step(self, key, p):
        return tuple(jnp.int32(v) for v in self._out(*self.jtable[tuple(np.asarray(key).tolist())]))

    def port_step(self, gen, p):
        assert gen.device.type == "cpu"
        return tuple(torch.tensor(v, dtype=torch.int32) for v in self._out(*self.ttable[gen.initial_seed()]))


CASES = {
    # target reached within the first point, then the second point
    "target": dict(per_point=[[7, 3, 12], [1, 0, 2]], kw=dict(num_target_block_errors=20, max_mc_iter=9)),
    "max_iter": dict(per_point=[[1], [2]], kw=dict(num_target_block_errors=100, max_mc_iter=4)),
    "early_stop": dict(per_point=[[3], [0], [5]], kw=dict(num_target_block_errors=100, max_mc_iter=3)),
    "no_early_stop": dict(per_point=[[3], [0], [5]],
                          kw=dict(num_target_block_errors=100, max_mc_iter=3, early_stop=False)),
    "no_target": dict(per_point=[[4, 9]], kw=dict(num_target_block_errors=None, max_mc_iter=5)),
}


def run_both(case, overflow, seed=4, **extra):
    spec = CASES[case]
    kw = dict(spec["kw"], **extra)
    ps = [0.1 + 0.01 * i for i in range(len(spec["per_point"]))]
    stubs = Stubs(seed, spec["per_point"], kw["max_mc_iter"], overflow)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    with redirect_stdout(jbuf):
        ref = jmc.sim_ler(stubs.jax_step, ps, batch_size=50, seed=seed, **kw)
    with redirect_stdout(tbuf):
        out = sim_ler(stubs.port_step, ps, batch_size=50, seed=seed, device="cpu", **kw)
    return ref, out, jbuf.getvalue(), tbuf.getvalue()


@pytest.mark.parametrize("overflow", [False, True], ids=["two_outputs", "overflow_output"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sim_ler_matches_jax(case, overflow):
    """Equal counts, status, overflow and stop point; the same warning for
    a nonzero overflow."""
    ref, out, jlog, tlog = run_both(case, overflow)
    for k in COUNTED + ("ps", "flagged_rate", "ler"):
        np.testing.assert_array_equal(getattr(out, k), getattr(ref, k), err_msg=k)
    assert ("compaction-capacity overflows" in tlog) == ("compaction-capacity overflows" in jlog) == (
        overflow and ref.overflow.sum() > 0)
    assert out.summary().splitlines()[0] == ref.summary().splitlines()[0]
    if case == "target":
        assert out.status.tolist() == [4, 1] and out.num_blocks.tolist() == [150, 450]
    if case == "early_stop":
        assert out.status.tolist() == [1, 2, 0]


def interrupted(fn, ckpt, stubs_kw, interrupt_after, seed=4):
    """Run ``fn`` (a sim_ler) until the stub interrupts it; returns the
    partial result and the stubs."""
    stubs = Stubs(seed, interrupt_after=interrupt_after, **stubs_kw)
    step = stubs.jax_step if fn is jmc.sim_ler else stubs.port_step
    extra = {} if fn is jmc.sim_ler else dict(device="cpu")
    with redirect_stdout(io.StringIO()):
        res = fn(step, [0.1, 0.11], batch_size=50, max_mc_iter=6, num_target_block_errors=15, seed=seed,
                 checkpoint_path=ckpt, **extra)
    return res


STUB_KW = dict(per_point=[[2, 1, 4], [6, 0, 5]], iters=6, overflow=True)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_checkpoint_resume(tmp_path, writer, reader):
    """An interrupted run returns partial results and leaves a checkpoint
    with the JAX package's keys; resuming it (in either package) reaches
    the counts of an uninterrupted run."""
    fns = {"jax": jmc.sim_ler, "port": sim_ler}
    full = interrupted(sim_ler, None, STUB_KW, interrupt_after=None)
    ckpt = str(tmp_path / "mc.json")
    part = interrupted(fns[writer], ckpt, STUB_KW, interrupt_after=4)
    assert part.num_blocks.tolist() == [200, 0] and part.status.tolist() == [0, 0]
    with open(ckpt) as f:
        saved = json.load(f)
    assert set(saved) == {"flagged", "logical", "blocks", "iters", "runtime", "status", "overflow", "ps",
                          "batch_size"}
    assert saved["iters"] == [4, 0]
    resumed = interrupted(fns[reader], ckpt, STUB_KW, interrupt_after=None)
    for k in COUNTED:
        np.testing.assert_array_equal(getattr(resumed, k), getattr(full, k), err_msg=k)
    assert full.status.tolist() == [1, 4]


def test_checkpoint_of_other_sweep_is_ignored(tmp_path):
    ckpt = tmp_path / "mc.json"
    ckpt.write_text(json.dumps({"ps": [0.3], "batch_size": 50, "logical": [99], "status": [4]}))
    res = interrupted(sim_ler, str(ckpt), STUB_KW, interrupt_after=None)
    assert res.status.tolist() == [1, 4]


def test_batch_generator_is_reproducible():
    """The generator of batch (seed, point, iteration) draws the same
    numbers in every run and on resumption, other batches other numbers;
    the process index changes them too."""
    draws = {}

    def step(gen, p):
        draws.setdefault(len(draws), torch.rand(4, generator=gen))
        return 0, 1

    kw = dict(batch_size=1, max_mc_iter=3, num_target_block_errors=None, verbose=False, device="cpu")
    sim_ler(step, [0.1, 0.2], seed=9, **kw)
    first = dict(draws)
    draws.clear()
    sim_ler(step, [0.1, 0.2], seed=9, **kw)
    assert all(torch.equal(first[k], draws[k]) for k in first) and len(first) == 6
    assert len({tuple(v.tolist()) for v in first.values()}) == 6
    g = torch.Generator().manual_seed(batch_seed(9, 0, 1, 2))
    assert torch.equal(torch.rand(4, generator=g), first[5])  # point 1, iteration 2 alone
    assert batch_seed(9, 1, 1, 2) != batch_seed(9, 0, 1, 2) != batch_seed(8, 0, 1, 2)


@pytest.mark.parametrize("fold", [True, False])
def test_process_index_folds_into_seed(monkeypatch, fold):
    seeds = []
    monkeypatch.setattr(montecarlo, "_process_index", lambda: 3)
    sim_ler(lambda g, p: seeds.append(g.initial_seed()) or (0, 1), [0.1], batch_size=1, max_mc_iter=1,
            verbose=False, seed=2, fold_process_key=fold, device="cpu")
    assert seeds == [batch_seed(2, 3 if fold else 0, 0, 0)]


def test_plot_ler_stores_curves_and_plots(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    plot = PlotLER("t")
    res = plot.simulate(lambda g, p: (3, 1), [0.1, 0.2], batch_size=10, max_mc_iter=2, verbose=False,
                        add_flagged=True, legend="x", device="cpu")
    assert res.ler.tolist() == [0.1, 0.1]
    assert plot._legends == ["x (flagged)", "x"] and plot._is_ler == [False, True]
    plot.plot(save_path=str(tmp_path / "ler.png"))
    assert (tmp_path / "ler.png").stat().st_size > 0
    plot.remove()
    assert plot._legends == ["x (flagged)"]


ARGVS = [
    [],
    ["-c", "n1270", "-p", "0.12", "0.1", "-nG", "3", "-bs", "10000", "--qc-kernel"],
    ["-p", "0.08", "--compact", "0.4", "--prepass", "12", "--rounds-cap", "0.08", "--target-errors", "50"],
    ["--rescue-phi", "tf,accurate", "--rescue-cap", "0.05", "--cn-type", "minsum", "--factor1", "0.8",
     "--iters1", "32", "--iters2", "8", "--p0", "0.04", "--seed", "3", "--checkpoint", "c.json"],
    ["--data-shards", "2", "--edge-shards", "2", "--multihost", "--weights", "w.npz", "--max-mc-iter", "7"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_from_args_matches_jax(argv):
    ref = jconfig.config_from_args(jconfig.make_eval_parser().parse_args(argv))
    out = tconfig.config_from_args(tconfig.make_eval_parser().parse_args(argv))
    ref_fields, out_fields = asdict(ref), asdict(out)
    assert out_fields.pop("device") is None
    assert out_fields == ref_fields
    assert out.resolve_weights() == ref.resolve_weights()
    assert os.path.exists(tconfig.CODE_REGISTRY[out.code]["coarse_weights"])


def test_eval_parser_matches_jax():
    """The same flags with the same defaults and choices, plus --device."""
    def flags(ap):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs) for a in ap._actions}

    out = flags(tconfig.make_eval_parser())
    assert out.pop("device") == (("--device",), None, None, None)
    assert out == flags(jconfig.make_eval_parser())
    assert {k: v["nG"] for k, v in tconfig.CODE_REGISTRY.items()} == \
        {k: v["nG"] for k, v in jconfig.CODE_REGISTRY.items()}


def _load_jax_evaluate():
    spec = importlib.util.spec_from_file_location("jax_evaluate", os.path.join(REPO, "scripts", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--compact", "0.5", "--rescue-phi", "tf", "--rescue-cap", "0.5"]],
                         ids=["plain", "compact_rescue"])
def test_evaluate_run_matches_jax(monkeypatch, extra):
    """scripts/evaluate.py's run() and the port's on [[882,24]] with the
    shipped weights (gather backend, tiny schedule), each package's Pauli
    sampler replaced by the same numpy noise per (point, iteration): the
    SimResults' counts are equal."""
    argv = ["-bs", "32", "--iters1", "8", "--iters2", "4", "-nG", "2", "--max-mc-iter", "2",
            "-p", "0.12", "0.1", "--seed", "5"] + extra
    n, b = 882, 32

    def noise(i, it):
        p = (0.12, 0.1)[i]
        u = np.random.default_rng([i, it, 7]).random((n, b))
        return u < 2 * p / 3, (u >= p / 3) & (u < p)

    monkeypatch.setattr(jcas, "pauli_iid", jax_key_noise(5, 2, 2, noise))
    monkeypatch.setattr(tcas, "pauli_iid", port_seed_noise(5, 2, 2, noise))
    with redirect_stdout(io.StringIO()):
        ref = _load_jax_evaluate().run(jconfig.config_from_args(jconfig.make_eval_parser().parse_args(argv)))
    from feedback_gnn_tpu_torch.cli import evaluate

    out = evaluate.main(argv + ["--device", "cpu"])
    for k in COUNTED:
        np.testing.assert_array_equal(getattr(out, k), getattr(ref, k), err_msg=k)
    assert out.logical_errors.sum() > 0 and out.num_blocks.tolist() == [64, 64]


def test_bench_settings_follow_bench_py_overrides():
    from feedback_gnn_tpu_torch.cli import bench

    s = bench.bench_settings({})
    assert (s.batch, s.p, s.windows, s.use_qc) == (20480, 0.05, 5, True)
    c = s.cfg
    assert (c.num_iter1, c.num_iter2, c.num_rounds, c.compact_fraction, c.stage1_prepass,
            c.round_fraction, c.qc_batch_tile) == (64, 16, 5, 0.15, 12, 0.05, 128)
    s = bench.bench_settings({"BENCH_BATCH": "512", "BENCH_P": "0.08", "BENCH_ITERS": "2", "BENCH_NO_QC": "1",
                              "BENCH_CN": "minsum", "QC_TILE": "64", "BENCH_COMPACT": "0",
                              "BENCH_PREPASS": "0", "BENCH_ROUNDS": "0"})
    assert (s.batch, s.p, s.windows, s.use_qc) == (512, 0.08, 2, False)
    c = s.cfg
    assert (c.cn_type, c.qc_batch_tile, c.compact_fraction, c.stage1_prepass, c.round_fraction) == \
        ("minsum", 64, None, None, None)


def test_timed_windows_counts_every_step():
    """Each window lasts at least its length and ends on a fetched count;
    the rates are batch x steps / seconds."""
    from feedback_gnn_tpu_torch.cli.bench import timed_windows

    calls = []

    def step(gen, p):
        calls.append(p)
        return torch.tensor(1), torch.tensor(0), torch.tensor(0)

    rates, step_ms, outs = timed_windows(step, (None, 0.05), 100, windows=3, window_s=0.01)
    assert len(rates) == len(step_ms) == 3 and len(outs) == len(calls) >= 3
    assert all(r > 0 for r in rates) and all(ms > 0 for ms in step_ms)
