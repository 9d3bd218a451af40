"""The port's GNN_BP4 against the benchmark's plain reference
(benchmark/reference/gnn_bp4.py), its spans and counter, its CLI mode and
the count of its operations.

The reference is written on the edge lists of hx and hz, apart from the
port's padded slot layout; here both decode the same syndromes with the
same weights (seeded random ones from ``init_gnn_bp4``, and the shipped
trained ones), and every iteration's perp logits, the last LLRs and the
decisions are compared.  ``--mode gnn-bp4`` of cli/osd_eval.py runs
GNN_BP4 through ``sim_ler`` and must count what ``gnn_bp4_eval_step``
counts on the same seeds.  ``gnn_bp4_counts`` must count the dense layers'
operations that ``torch.utils.flop_counter`` sees the reference make.
Imports no JAX.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import feedback_gnn_tpu_torch.codes as tc
from benchmark import gnn_bp4_counts
from benchmark.reference import codes as ref_codes
from benchmark.reference import gnn_bp4 as ref
from feedback_gnn_tpu_torch import models, obs
from feedback_gnn_tpu_torch.cli import osd_eval
from feedback_gnn_tpu_torch.decoders import gnn_full
from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
from feedback_gnn_tpu_torch.ops.gf2mat import mod2_matmul
from feedback_gnn_tpu_torch.sim.montecarlo import batch_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
TOL = 1e-5  # float32 rounding of two orders of summation, relative to max(|ref|, 1)
WIDTHS = ("num_embed_dims", "num_msg_dims", "num_hidden_units", "num_mlp_layers", "num_iter", "activation")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))  # several test workers share the cores
    obs.reset()
    yield
    obs.reset()
    torch.set_num_threads(old)


def _code(name):
    return tc.ghp_882_24() if name == "n882" else tc.create_generalized_bicycle_codes(*GB48)


def _ref_code(code):
    """The reference's ``Code`` of the port's code (the decoder is compared
    here; the construction of [[882,24]] from its numbers is the
    benchmark's own test)."""
    hx, hz = np.asarray(code.hx, np.int64), np.asarray(code.hz, np.int64)
    return ref_codes.Code(hx.shape[1], int(code.K), None, hx, hz, ref_codes.gf2_kernel(hx),
                          ref_codes.gf2_kernel(hz), None, None)


def _port(code):
    host = tc.QuantumGraph.from_code(code, stage_mode=True)
    return host.to("cpu"), gnn_full.make_logit_rowsets(host, "cpu")


def _syndromes(code, b, seed, p=0.04):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((2, code.N, b), generator=g)
    nx, nz = (u[0] < p).to(torch.int32), (u[1] < p).to(torch.int32)
    hx, hz = (torch.as_tensor(np.asarray(h), dtype=torch.float32) for h in (code.hx, code.hz))
    return mod2_matmul(hx, nz), mod2_matmul(hz, nx)


def _save(params, path):
    np.savez(path, **{k: v.numpy() for k, v in flatten_with_paths(params).items()})
    return path


def _compare(code, params, cfg, path, b, seed, monkeypatch):
    graph, rows = _port(code)
    sx, sz = _syndromes(code, b, seed)
    seen = []
    orig = gnn_full._cal_logit
    monkeypatch.setattr(gnn_full, "_cal_logit", lambda *a: seen.append(orig(*a)) or seen[-1])
    with torch.no_grad():
        x_hat, z_hat, stack = gnn_full.gnn_bp4_apply(params, graph, rows, sx, sz, cfg, collect_logits=True)
    net = ref.load_net(_ref_code(code), path, cfg._asdict(), "cpu")
    perp, r_llrs, (rx, rz) = ref.decode(net, sx, sz)
    keep_x = torch.cat([rows[1].row_valid, rows[3].row_valid]) > 0
    keep_z = torch.cat([rows[0].row_valid, rows[2].row_valid]) > 0
    assert len(stack) == len(perp) == cfg.num_iter
    for (px, pz), (qx, qz) in zip(stack, perp):
        for a, want in ((px[keep_x], qx), (pz[keep_z], qz)):
            assert a.shape == want.shape
            assert float(((a - want).abs() / want.abs().clamp_min(1.0)).max()) <= TOL
    n = code.N
    for a, want in zip(seen[-1][4], r_llrs):
        assert float(((a[:n] - want).abs() / want.abs().clamp_min(1.0)).max()) <= TOL
    assert torch.equal(x_hat[:n], rx) and torch.equal(z_hat[:n], rz)


@pytest.mark.parametrize("name,b,seed", [("n882", 16, 0), ("gb48", 64, 0), ("gb48", 64, 1)])
def test_port_equals_reference_on_random_weights(tmp_path, monkeypatch, name, b, seed):
    code = _code(name)
    cfg = gnn_full.GNNBP4Config()
    params = gnn_full.init_gnn_bp4(torch.Generator().manual_seed(100 + seed), cfg)
    _compare(code, params, cfg, _save(params, str(tmp_path / "w.npz")), b, seed, monkeypatch)


@pytest.mark.parametrize("name,b", [("n882", 16), ("gb48", 64)])
def test_port_equals_reference_on_shipped_weights(monkeypatch, name, b):
    params, cfg = gnn_full.load_shipped(name, "cpu")
    _compare(_code(name), params, cfg, os.path.join(gnn_full.SHIPPED_DIR, f"gnn_bp4_{name}.npz"), b, 7,
             monkeypatch)


@pytest.mark.parametrize("name", ["n882", "gb48"])
def test_reference_logicals_are_the_ports(name):
    code = _code(name)
    lx, lz = ref.logicals(code.hx, code.hz)
    assert np.array_equal(lx, np.asarray(code.lx)) and np.array_equal(lz, np.asarray(code.lz))


def test_reference_builds_n882_from_the_configuration():
    with open(os.path.join(REPO, "benchmark", "configs", "n882_gnn_bp4.json")) as f:
        conf = json.load(f)
    code = ref_codes.build_code(conf["code"])
    port = tc.ghp_882_24()
    assert np.array_equal(code.hx, port.hx) and np.array_equal(code.hz, port.hz)
    _, cfg = gnn_full.load_shipped("n882", "cpu")
    assert {k: conf["gnn_bp4"][k] for k in WIDTHS} == {k: getattr(cfg, k) for k in WIDTHS}
    assert conf["gnn_bp4"]["reduce_op"] == cfg.reduce_op and conf["gnn_bp4"]["use_bias"] == cfg.use_bias
    assert os.path.samefile(os.path.join(REPO, conf["weights"]),
                            os.path.join(gnn_full.SHIPPED_DIR, "gnn_bp4_n882.npz"))


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a card's."""

    is_cuda = True


def test_spans_and_counter_of_the_step():
    code = _code("gb48")
    graph, rows = _port(code)
    params, cfg = gnn_full.load_shipped("gb48", "cpu")
    obs.enable()
    try:
        for s in range(3):
            models.gnn_bp4_eval_step(graph, rows, params, cfg, torch.Generator().manual_seed(s), 0.05, 32)
        snap = obs.snapshot()
    finally:
        obs.enable(False)
    it = cfg.num_iter
    assert snap["batches"] == 3
    spans = snap["spans"]
    assert spans["gnn_bp4.decode"]["count"] == 3 and spans["step.account"]["count"] == 3
    assert spans["step.sample"]["count"] == 6  # the draw, then the pads and syndromes
    for name in ("gnn_bp4.vn", "gnn_bp4.cn", "gnn_bp4.logits"):
        assert spans[name]["count"] == 3 * it
        assert {k: v["count"] for k, v in spans[name]["by"]["iteration"].items()} == {i: 3 for i in range(it)}
    assert "gnn_bp4.decodes" not in snap["counters"]  # a CPU decode counts nothing
    sx, sz = _syndromes(code, 8, 0)
    with torch.no_grad():
        gnn_full.gnn_bp4_apply(params, graph, rows, torch.Tensor._make_subclass(_OnCard, sx), sz, cfg)
    assert obs.snapshot()["keys"]["gnn_bp4.decodes"] == {(8, it): 1}


@pytest.mark.parametrize("weights", ["shipped", "explicit"])
def test_cli_mode_counts_what_the_step_counts(weights):
    argv = ["--mode", "gnn-bp4", "-p", "0.06", "-bs", "8", "--max-mc-iter", "2", "--target-errors", "1000",
            "--device", "cpu", "--seed", "5"]
    if weights == "explicit":
        argv += ["--weights", os.path.join(gnn_full.SHIPPED_DIR, "gnn_bp4_n882.npz")]
    res = osd_eval.main(argv)
    graph, rows = _port(tc.ghp_882_24())
    params, cfg = gnn_full.load_shipped("n882", "cpu")
    want = np.zeros(2, np.int64)
    for it in range(2):
        gen = torch.Generator().manual_seed(batch_seed(5, 0, 0, it))
        want += np.array([int(c) for c in models.gnn_bp4_eval_step(graph, rows, params, cfg, gen, 0.06, 8)])
    assert int(res.num_blocks[0]) == 16
    assert [int(res.flagged_errors[0]), int(res.logical_errors[0])] == want.tolist()


@pytest.mark.parametrize("widths", [dict(num_embed_dims=20, num_msg_dims=20, num_hidden_units=40, num_mlp_layers=2),
                                    dict(num_embed_dims=6, num_msg_dims=5, num_hidden_units=7, num_mlp_layers=3)])
def test_counts_are_the_reference_products(tmp_path, widths):
    code = _code("gb48")
    cfg = gnn_full.GNNBP4Config(num_iter=3, **widths)
    params = gnn_full.init_gnn_bp4(torch.Generator().manual_seed(1), cfg)
    rcode = _ref_code(code)
    net = ref.load_net(rcode, _save(params, str(tmp_path / "w.npz")), cfg._asdict(), "cpu")
    sx, sz = _syndromes(code, 5, 3)
    with FlopCounterMode(display=False) as fc:
        ref.decode(net, sx, sz)
    assert gnn_bp4_counts.gnn_bp4_flops(gnn_bp4_counts.dims_of(rcode), cfg._asdict(), 5) == fc.get_total_flops()


def test_counts_at_the_cells_widths():
    conf = json.load(open(os.path.join(REPO, "benchmark", "configs", "n882_gnn_bp4.json")))
    dims = gnn_bp4_counts.dims_of(ref_codes.build_code(conf["code"]))
    assert (dims.n, dims.m_x, dims.m_z, dims.edges_x, dims.edges_z) == (882, 441, 441, 2646, 2646)
    per = gnn_bp4_counts.gnn_bp4_flops(dims, conf["gnn_bp4"], 1)
    assert per == 8 * (4 * 2646 * 4800 + 882 * 6400 + 2 * 441 * 4880 + 882 * 120)
    ms, bound = gnn_bp4_counts.gnn_bp4_bound_ms(dims, conf["gnn_bp4"], 20480)
    assert bound == "operations" and 148.0 < ms < 150.0


def test_reference_steps_from_the_ports_own_states(monkeypatch):
    """The benchmark's check holds each update to the reference computed
    from the program's states before it: on the port's own recorded states
    every CN update, VN update and logits step of the reference agrees."""
    code = _code("gb48")
    graph, rows = _port(code)
    params, cfg = gnn_full.load_shipped("gb48", "cpu")
    states = []
    for name in ("_update_cn", "_update_vn"):
        orig = getattr(gnn_full, name)
        monkeypatch.setattr(gnn_full, name, lambda *a, _o=orig, _n=name, **k: states.append((_n, _o(*a, **k)))
                            or states[-1][1])
    sx, sz = _syndromes(code, 40, 2)
    with torch.no_grad():
        _, _, stack = gnn_full.gnn_bp4_apply(params, graph, rows, sx, sz, cfg, collect_logits=True)
    assert [n for n, _ in states] == ["_update_cn"] + ["_update_vn", "_update_cn"] * (cfg.num_iter - 1) + ["_update_vn"]
    net = ref.load_net(_ref_code(code), os.path.join(gnn_full.SHIPPED_DIR, "gnn_bp4_gb48.npz"), cfg._asdict(), "cpu")
    act = ref._act(cfg.activation)
    n, mx, mz = code.N, sx.shape[0], sz.shape[0]
    sign = {"x": 1.0 - 2.0 * sx.T.float(), "z": 1.0 - 2.0 * sz.T.float()}
    cn = [{"x": ref._sample_major(s[0], mx), "z": ref._sample_major(s[1], mz)} for k, s in states if k == "_update_cn"]
    vn = [ref._sample_major(s, n) for k, s in states if k == "_update_vn"]
    keep_x = torch.cat([rows[1].row_valid, rows[3].row_valid]) > 0
    keep_z = torch.cat([rows[0].row_valid, rows[2].row_valid]) > 0
    ones = torch.ones_like(vn[0])
    want = ref._cn_update(net, ones, {s: torch.zeros_like(cn[0][s]) for s in "xz"},
                          {s: torch.zeros_like(sign[s]) for s in "xz"}, act)
    for i in range(cfg.num_iter):
        for side in "xz":
            assert torch.allclose(cn[i][side], want[side], rtol=TOL, atol=TOL)
        assert torch.allclose(vn[i], ref._vn_update(net, ones if i == 0 else vn[i - 1], cn[i], sign, act),
                              rtol=TOL, atol=TOL)
        _, perp = ref._logits(net, vn[i])
        assert torch.allclose(stack[i][0][keep_x], perp["x"], rtol=TOL, atol=TOL)
        assert torch.allclose(stack[i][1][keep_z], perp["z"], rtol=TOL, atol=TOL)
        if i < cfg.num_iter - 1:
            logit = {"x": stack[i][1][keep_z][:mx].T * sign["x"], "z": stack[i][0][keep_x][:mz].T * sign["z"]}
            want = ref._cn_update(net, vn[i], cn[i], logit, act)


def test_reference_imports_nothing_of_the_program_or_jax():
    path = os.path.join(REPO, "benchmark", "reference", "gnn_bp4.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names and all(n.split(".")[0] in ("", "__future__", "numpy", "torch") for n in names), names
