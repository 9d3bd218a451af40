"""The port's GNN_BP4 training CLI and example CLIs (cli/train_gnn_bp4.py,
cli/qldpc_codes.py, cli/n882.py, cli/n1270.py) against the JAX package's
scripts: the same flags and defaults, the same JSON layout and code table,
the same evaluation configuration; each run on the CPU at a small size."""

import contextlib
import importlib.util
import io
import json
import os
import sys
import types

import numpy as np
import pytest

# torch.optim imports torch._dynamo at its first use; import it while the
# test modules are collected (see tests/test_torch_train_cli.py)
import torch
import torch._dynamo  # noqa: F401

import jax

from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders import gnn_full as jg
from feedback_gnn_tpu.io.checkpoint import load_pytree as j_load_pytree

from feedback_gnn_tpu_torch.cli import evaluate, n882, n1270, qldpc_codes, train_gnn_bp4
from feedback_gnn_tpu_torch.decoders import gnn_full as tg
from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_train_cli import _flags, _jax_script_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_file(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout(tree):
    """The nested key structure of a JSON document (leaves by their type)."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return type(tree).__name__ if not isinstance(tree, (int, float)) or isinstance(tree, bool) else "number"


def test_train_gnn_bp4_flags_are_the_jax_script(monkeypatch):
    ref = _flags(_jax_script_parser("scripts/train_gnn_bp4.py", monkeypatch))
    out = _flags(train_gnn_bp4.make_parser())
    assert out.pop("device") == (("--device",), None, None, None, None)
    assert out == ref


def test_train_gnn_bp4_cli_on_gb48(tmp_path, capsys):
    """Three steps and one evaluation batch a point; the JSON has the JAX
    script's layout (runs/gnn_bp4_gb48.json), the weights load back in
    both packages, and the loss is logged at steps 0 and 2."""
    out, weights = str(tmp_path / "r.json"), str(tmp_path / "w.npz")
    results, losses, params = train_gnn_bp4.main(
        ["--code", "gb48", "--steps", "3", "--eval-batches", "1", "--eval-batch-size", "64",
         "--eval-p", "0.03", "0.05", "--device", "cpu", "--out", out, "--weights-out", weights])
    log = capsys.readouterr().out
    assert "it 0: loss" in log and "it 2: loss" in log and "trained p=0.05: LER" in log
    assert len(losses) == 3 and np.isfinite(losses).all()
    with open(out) as f:
        written = json.load(f)
    with open(os.path.join(REPO, "runs", "gnn_bp4_gb48.json")) as f:
        ref = json.load(f)
    ref_point = _layout(next(iter(ref["init"].values())))
    assert list(written) == list(ref) and written["cfg"] == ref["cfg"]
    for tag in ("init", "trained"):
        assert list(written[tag]) == ["0.03", "0.05"]
        assert all(_layout(v) == ref_point and v["blocks"] == 64 for v in written[tag].values())
    assert written["steps"] == 3 and written["code"] == "gb48"

    cfg = tg.GNNBP4Config(**written["cfg"])
    back = flatten_with_paths(tg.load_gnn_bp4_weights(weights, cfg, "cpu"))
    with np.load(weights) as data:
        assert sorted(data.files) == sorted(back)
        for k, v in back.items():
            np.testing.assert_array_equal(v.numpy(), data[k])
            assert torch.equal(v, flatten_with_paths(params)[k].detach()), k
    from feedback_gnn_tpu.codes import create_generalized_bicycle_codes

    jgraph = JQuantumGraph.from_code(create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]))
    jp = j_load_pytree(weights, jg.init_gnn_bp4(jax.random.PRNGKey(0), jg.GNNBP4Config(**written["cfg"]), jgraph))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(back)
    for path, leaf in jflat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf), back[key].numpy())


def test_qldpc_codes_table_is_the_jax_example(monkeypatch):
    """The printed table line for line, and N, K and the matrices of every row."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # the example inserts the repo's root
    example = _load_file("examples/qldpc_codes.py", "jax_qldpc_codes")
    ref_zoo = example.build_zoo()
    monkeypatch.setattr(sys, "argv", ["qldpc_codes.py"])
    ref_out, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        example.main()
    with contextlib.redirect_stdout(out):
        zoo = qldpc_codes.main([])
    assert out.getvalue() == ref_out.getvalue()
    assert list(zoo) == list(ref_zoo)
    for name, code in zoo.items():
        ref = ref_zoo[name]
        assert (code.N, code.K) == (ref.N, ref.K), name
        np.testing.assert_array_equal(code.hx, ref.hx)
        np.testing.assert_array_equal(code.hz, ref.hz)


@pytest.mark.parametrize("argv", [["-p", "0.1"], ["-p", "0.08", "0.06", "-id", "3", "--qc-kernel"],
                                  ["-id", "2", "--seed", "5", "-nG", "2", "-bs", "64", "--compact", "0.4",
                                   "--prepass", "12"]])
@pytest.mark.parametrize("code", ["n882", "n1270"])
def test_example_clis_configure_as_the_jax_examples(code, argv, monkeypatch):
    """The EvalConfig each example hands to its evaluation, field by field
    (the JAX example's scripts/evaluate.run replaced by a recorder)."""
    seen = {}
    stub = types.ModuleType("evaluate")
    stub.run = lambda cfg: seen.setdefault("jax", cfg)
    monkeypatch.setitem(sys.modules, "evaluate", stub)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the example inserts scripts/
    monkeypatch.setattr(sys, "argv", [f"{code}.py"] + argv)
    _load_file(f"examples/{code}.py", f"jax_{code}").main()
    monkeypatch.setattr(evaluate, "run", lambda cfg: seen.setdefault("torch", cfg))
    {"n882": n882, "n1270": n1270}[code].main(argv)
    ref, out = vars(seen["jax"]), vars(seen["torch"])
    assert out.pop("device") is None
    assert vars(out.pop("cascade")) == vars(ref.pop("cascade"))
    assert out == ref


def test_n1270_cli_runs_on_cpu(capsys):
    """cli/n1270.py end to end, tiny: the QC backend's plain version."""
    res = n1270.main(["-p", "0.10", "--qc-kernel", "-bs", "16", "--iters1", "8", "--iters2", "4",
                      "-nG", "1", "--max-mc-iter", "1", "--device", "cpu"])
    assert int(res.num_blocks[0]) == 16 and 0 <= int(res.logical_errors[0]) <= 16
    assert "GHP_n1270_k28" in capsys.readouterr().out
