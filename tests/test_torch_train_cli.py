"""The port's training CLIs (cli/train.py, cli/train_from_scratch.py,
cli/generate_dataset.py) on the CPU, at GB-48 scale through the functions
their ``main`` calls, and the slice as a whole against the JAX package:
the same flags as the JAX scripts, and one train step on mined noise.

The whole step is held by its monitors (equal) and its loss at rtol 5e-3:
stage 1 starts from the uniform prior on samples BP fails on, and its
saturated marginals differ between two math libraries by O(1) (ROADMAP
C); the card against the CPU differ so by 1.9e-3 in the loss at this
schedule (chip_smoke.py's train phase, PERF.md).  Each stage on its own
is held tightly in tests/test_torch_train.py.
"""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

# torch.optim imports torch._dynamo at its first use; import it while the
# test modules are collected, before tests/refutil.py (run by
# tests/test_gf2.py) puts stub modules into sys.modules, whose source the
# import's inspection cannot read
import torch._dynamo  # noqa: F401

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders import gnn_feedback as jgnn
from feedback_gnn_tpu.train import data as jdata
from feedback_gnn_tpu.train import trainer as jt

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.cli import generate_dataset, train, train_from_scratch
from feedback_gnn_tpu_torch.decoders import gnn_feedback as tgnn
from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
from feedback_gnn_tpu_torch.train import trainer as tt
from feedback_gnn_tpu_torch.train.data import FailureMiner

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])


@pytest.fixture(scope="module")
def gb48():
    code = tc.create_generalized_bicycle_codes(*GB48)
    return tc.QuantumGraph.from_code(code, stage_mode=True).to("cpu"), tc.qc_pair_from_code(code)


# ---- the flags ----------------------------------------------------------------


class _Parsed(Exception):
    pass


def _jax_script_parser(relpath, monkeypatch):
    """The ArgumentParser a JAX script's main() builds (caught at parse_args)."""
    spec = importlib.util.spec_from_file_location("jax_script", os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def catch(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as exc:
        mod.main()
    monkeypatch.undo()
    return exc.value.args[0]


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     tuple(sorted(a.choices)) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("script,module", [
    ("scripts/train.py", train), ("scripts/train_from_scratch.py", train_from_scratch),
    ("examples/generate_dataset.py", generate_dataset),
])
def test_flags_are_the_jax_scripts(script, module, monkeypatch):
    ref = _flags(_jax_script_parser(script, monkeypatch))
    out = _flags(module.make_parser())
    assert out.pop("device") == (("--device",), None, None, None, None)
    assert out == ref


# ---- the CLIs on GB-48 -----------------------------------------------------------


def test_train_cli_mines_trains_and_saves(gb48, tmp_path):
    graph, _ = gb48
    out = str(tmp_path / "w.pkl")
    args = train.make_parser().parse_args(
        ["--mine", "--mine-weights", "5", "6", "--mine-batches", "1", "--mine-batch-size", "64",
         "--iters1", "8", "--iters2", "4", "--loss-from", "1", "--batch-size", "8", "--log-every", "2",
         "--weights-out", out, "--device", "cpu"])
    params = train.train(args, graph, "cpu")
    for key, leaf in flatten_with_paths(tgnn.load_weights(out)).items():
        assert torch.equal(leaf, flatten_with_paths(params)[key].detach()), key
    jgnn.load_weights(out)  # the JAX package reads it

    # again from a data dir, starting from those weights
    x = np.random.default_rng(0).integers(0, 2, (24, graph.n), dtype=np.uint8)
    np.save(tmp_path / "n882_x_all.npy", x)
    np.save(tmp_path / "n882_z_all.npy", x[::-1].copy())
    out2 = str(tmp_path / "w2.pkl")
    args = train.make_parser().parse_args(
        ["--data-dir", str(tmp_path), "--weights-in", out, "--iters1", "8", "--iters2", "4",
         "--loss-from", "1", "--batch-size", "8", "--weights-out", out2, "--device", "cpu"])
    params2 = train.train(args, graph, "cpu")
    moved = [not torch.equal(a.detach(), b.detach())
             for a, b in zip(flatten_with_paths(params).values(), flatten_with_paths(params2).values())]
    assert any(moved)


def test_generate_dataset_easy_hard_and_mix(gb48, tmp_path):
    graph, _ = gb48
    out = str(tmp_path / "data")
    easy = generate_dataset.make_parser().parse_args(
        ["--wt", "4", "6", "--batches", "1", "-bs", "128", "--out", out, "--device", "cpu"])
    shards = generate_dataset.generate(easy, graph, "cpu")
    assert sorted(shards) == [4, 6]
    w = str(tmp_path / "coarse.pkl")
    tgnn.save_reference_weights(tgnn.load_weights(
        os.path.join(REPO, "feedback_gnn_tpu", "weights", "feedback_GNN_n882_k24_wt_4_40_iter_16_16.npz")), w)
    hard = generate_dataset.make_parser().parse_args(
        ["--wt", "4", "4", "--batches", "1", "-bs", "64", "--out", out, "--hard", "--coarse-weights", w,
         "--oversample", "3", "--device", "cpu"])
    hshards = generate_dataset.generate(hard, graph, "cpu")
    ex = np.load(os.path.join(out, "n882_easy_x_all.npy"))
    hx = np.load(os.path.join(out, "n882_hard_x_all.npy"))
    mx = np.load(os.path.join(out, "n882_x_all.npy"))
    assert ex.shape[0] == sum(v[0].shape[0] for v in shards.values()) > 0
    assert hx.shape[0] == hshards[4][0].shape[0]
    assert mx.shape == (ex.shape[0] + 3 * hx.shape[0], graph.n)
    assert os.path.exists(os.path.join(out, "n882_easy_wt6_z.npy"))


CURRICULUM = ["--out-dir", None, "--wt", "4", "8", "--coarse-hi", "6", "--mine-batches", "2",
              "--mine-batch-size", "128", "--mine-compact-cap", "64", "--easy-cap", "40", "--hard-cap", "4",
              "--hard-oversample", "3", "--coarse-epochs", "1", "--batch-size", "16", "--eval-p", "0.1",
              "--eval-batch", "128", "--eval-target-errors", "5", "--mine-ahead", "2", "--device", "cpu"]
ARTIFACTS = ["n882_easy.npz", "n882_coarse_16_16.npz", "n882_hard.npz", "n882_final_64_16_mixed.npz",
             "n882_scratch_eval.json"]


def test_curriculum_runs_and_resumes(gb48, tmp_path, monkeypatch):
    graph, qc = gb48
    argv = list(CURRICULUM)
    argv[1] = str(tmp_path)
    args = train_from_scratch.make_parser().parse_args(argv)
    shipped = tgnn.load_weights(os.path.join(REPO, "feedback_gnn_tpu", "weights",
                                             "feedback_GNN_n882_k24_wt_4_60_iter_64_16_mixed.npz"))
    first = train_from_scratch.curriculum(args, graph, qc, shipped)
    assert sorted(os.listdir(tmp_path)) == sorted(ARTIFACTS)
    with open(tmp_path / "n882_scratch_eval.json") as f:
        assert json.load(f) == first
    for name in ("trained", "shipped"):
        assert first[name]["overflow"] == [0] and first[name]["blocks"][0] > 0
    with np.load(tmp_path / "n882_easy.npz") as d:
        assert list(d["weights"]) == [4, 6, 8] and d["x"].shape[0] == d["kept"].sum() > 0
    stamps = {a: os.stat(tmp_path / a).st_mtime_ns for a in ARTIFACTS[:-1]}

    # a second call resumes from the artifacts: nothing mined or trained again
    def refuse(*a, **k):
        raise AssertionError("recomputed a finished phase")

    monkeypatch.setattr(train_from_scratch, "make_optimizer", refuse)
    monkeypatch.setattr(FailureMiner, "__call__", refuse)
    again = train_from_scratch.curriculum(args, graph, qc, None)
    assert {a: os.stat(tmp_path / a).st_mtime_ns for a in ARTIFACTS[:-1]} == stamps
    assert again == {"trained": first["trained"]}


# ---- the slice against JAX -------------------------------------------------------


def test_train_step_on_mined_noise_matches_jax():
    """JAX's gather miner's failures, then one train step of each package
    from the same parameters at tests/test_training.py's 16/8 schedule."""
    jcode = jc.create_generalized_bicycle_codes(*GB48)
    jg = JQuantumGraph.from_code(jcode, stage_mode=True)
    tg = tc.QuantumGraph.from_code(tc.create_generalized_bicycle_codes(*GB48), stage_mode=True).to("cpu")
    nx, nz, flagged = jdata.make_bp_failure_miner(jg, num_iter=16)(jax.random.PRNGKey(3), 6, 256)
    mask = np.asarray(flagged)
    nx, nz = (np.asarray(a)[:, mask][:, :32].astype(np.float32) for a in (nx, nz))
    cfg = dict(num_iter1=16, num_iter2=8, loss_from=4)
    jparams = jgnn.init_feedback_gnn(jax.random.PRNGKey(0))
    jopt = jt.make_optimizer(jt.TrainConfig(**cfg))
    ref = jt.make_train_step(jg, jt.TrainConfig(**cfg), jopt)(jparams, jopt.init(jparams), jnp.asarray(nx),
                                                             jnp.asarray(nz))
    tparams = tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    opt = tt.make_optimizer(tt.TrainConfig(**cfg))
    out = tt.make_train_step(tg, tt.TrainConfig(**cfg), opt)(tparams, opt.init(tparams), torch.tensor(nx),
                                                             torch.tensor(nz))
    np.testing.assert_allclose(float(out[2]), float(ref[2]), rtol=5e-3)
    assert float(out[3]) == float(ref[3]) and float(out[4]) == float(ref[4])
