"""The port's gather BP4 (decoders/bp4.py) on the GB codes with overcomplete
check matrices, [[48,6,8]] (1,000 checks a side, qubit degree up to 261)
and [[46,2,9]] (400 a side): against the benchmark's edge-list reference
(benchmark/reference/gather_bp4.py) update by update, against the JAX
package's gather decoder on injected noise, its pad slots, spans and
counter, ``cli/osd_eval.py --code``, the reference's family builder and
the count of its operations.

Tolerances: the reference check's own measures (marginals relative to the
magnitudes they sum, CN outputs as phi(|m|), extrinsics relative to
max(|m|, 1)) within 1e-5, float32 rounding of two orders of summation;
against JAX rtol = atol = 2e-3 on the marginals, the JAX suite's own.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders.bp4 import bp4_decode as j_bp4_decode
from feedback_gnn_tpu.decoders.cascade import prior_llr as j_prior_llr

import feedback_gnn_tpu_torch.codes as tc
from benchmark import counts, gather_bp4_counts
from benchmark.gather_bp4 import Recorder
from benchmark.harness import load_json
from benchmark.reference import codes as ref_codes
from benchmark.reference import gather_bp4 as ref
from feedback_gnn_tpu_torch import models, obs
from feedback_gnn_tpu_torch.cli import osd_eval
from feedback_gnn_tpu_torch.decoders import bp4
from feedback_gnn_tpu_torch.decoders.cascade import prior_llr
from feedback_gnn_tpu_torch.sim.montecarlo import batch_seed

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 1e-5
JTOL = dict(rtol=2e-3, atol=2e-3)
CODES = ("gb48_oc", "gb46_oc")
NPZ = {"gb48_oc": ("GB_48_6_H_2000", 48, 6, 1000), "gb46_oc": ("GB_46_2_H_800", 46, 2, 400)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _obs_reset():
    obs.reset()
    yield
    obs.enable(False)
    obs.reset()


def _spec(name):
    stem, n, k, rows = NPZ[name]
    path = os.path.join("feedback_gnn_tpu", "codes", "data", stem + ".npz")
    with open(os.path.join(REPO, path), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"family": "gb_oc", "n": n, "k": k, "npz": path, "sha256": digest, "rows": rows}


def _noise(n, b, p, seed):
    """Depolarizing noise [n, b] of one uniform draw a qubit, as int32."""
    u = np.random.default_rng(seed).random((n, b))
    return (u < 2 * p / 3).astype(np.int32), ((u >= p / 3) & (u < p)).astype(np.int32)


def _checked_step(name, batch, iters, p, word):
    """One plain BP4 step of the CLI mode, every update captured by the
    benchmark's recorder, and the reference's readings of it."""
    code = ref_codes.build_code(_spec(name))
    sides = ref.sides_of(code, "cpu")
    rec = Recorder(sides, code.n)
    rec.install()
    try:
        args = osd_eval.make_parser().parse_args(["--code", name, "--mode", "bp4", "-bs", str(batch),
                                                  "--iters", str(iters)])
        step, _ = osd_eval.make_step(args, osd_eval.build_code(name), torch.device("cpu"))
        rec.reset({0: (torch.arange(batch), set(range(iters)))}, None)
        rec.wrap(step)(torch.Generator().manual_seed(word), p)
    finally:
        rec.uninstall()
    cap = rec.captured[0]
    return code, sides, cap, ref.check_batch(sides, code, p, batch, word, cap, iters)


@pytest.mark.parametrize("name", CODES)
def test_every_update_equals_the_edge_list_reference(name):
    code, sides, cap, got = _checked_step(name, 8, 4, 0.05, 2**40 + 17)
    assert got["mismatches"] == 0, got["notes"]
    assert got["llr_gap"] <= TOL, got["notes"]
    assert sorted(cap["iters"]) == [0, 1, 2, 3] and cap["updates"] == (4, 4, 4)
    # the reference's decisions from the program's last messages are the program's
    last = cap["iters"][3]["cn_out"]
    want = ref.hard_decision(*ref.marginals(last["x"], last["z"], ref.prior(0.05, code.n, 8, "cpu"), sides))
    for prog, w in zip(cap["decisions"], want):
        assert torch.equal(prog[:code.n], w)


@pytest.mark.parametrize("name", CODES)
def test_pad_slots_hold_zero_after_every_update(name, monkeypatch):
    graph = tc.QuantumGraph.from_code(osd_eval.build_code(name), stage_mode=True).to("cpu")
    seen = []
    scatter, cn = bp4.scatter_from_cn, bp4.cn_update_phi

    def scatter_seen(msg_cn, g):
        out = scatter(msg_cn, g)
        seen.append(("scatter", out, g.vn_mask))
        return out

    def cn_seen(msg_cn, syndrome_pm, mask, phi_impl=None):
        out = cn(msg_cn, syndrome_pm, mask, phi_impl)
        seen.extend([("cn in", msg_cn, mask), ("cn out", out, mask)])
        return out

    monkeypatch.setattr(bp4, "scatter_from_cn", scatter_seen)
    monkeypatch.setattr(bp4, "cn_update_phi", cn_seen)
    nx, nz = _noise(graph.n, 4, 0.06, 3)
    sx = models.mod2_matmul(graph.hx, torch.as_tensor(np.pad(nz, ((0, graph.n_pad - graph.n), (0, 0)))))
    sz = models.mod2_matmul(graph.hz, torch.as_tensor(np.pad(nx, ((0, graph.n_pad - graph.n), (0, 0)))))
    bp4.bp4_decode(graph, prior_llr(0.06, graph.n, 4, n_pad=graph.n_pad), sx, sz, 3)
    assert len(seen) == 3 * 2 * 3
    for what, t, mask in seen:
        assert int((t[mask == 0] != 0).sum()) == 0, what
        assert int((t[mask > 0] != 0).sum()) > 0, what


def _low_weight(n, b, seed):
    """Pauli errors of weight 0, 1, 2, 3, 0, ... on the samples (X, Y or Z
    on each, uniformly), as int32 (noise_x, noise_z) [n, b]: below half the
    distance, where BP converges (an unconverged sample is chaotic, and two
    float32 decoders part there)."""
    rng = np.random.default_rng(seed)
    nx, nz = np.zeros((n, b), np.int32), np.zeros((n, b), np.int32)
    for j in range(b):
        q = rng.choice(n, size=j % 4, replace=False)
        kind = rng.integers(1, 4, size=len(q))  # 1 X, 2 Z, 3 Y
        nx[q, j], nz[q, j] = kind & 1, kind >> 1
    return nx, nz


@pytest.mark.parametrize("name", CODES)
def test_decisions_equal_the_jax_gather_decoder(name):
    jg = JQuantumGraph.from_code(getattr(jc, osd_eval.CODES[name])(), stage_mode=True)
    tg = tc.QuantumGraph.from_code(osd_eval.build_code(name), stage_mode=True).to("cpu")
    n, n_pad, b, p = tg.n, tg.n_pad, 8, 0.03
    nx, nz = (np.pad(v, ((0, n_pad - n), (0, 0))) for v in _low_weight(n, b, 11))
    sx = (np.asarray(jg.hx) @ nz % 2).astype(np.int32)
    sz = (np.asarray(jg.hz) @ nx % 2).astype(np.int32)
    jres = j_bp4_decode(jg, j_prior_llr(p, n, b, n_pad=n_pad), jnp.asarray(sx), jnp.asarray(sz), 16)
    tres = bp4.bp4_decode(tg, prior_llr(p, n, b, n_pad=n_pad), torch.as_tensor(sx), torch.as_tensor(sz), 16)
    for f in ("x_hat", "z_hat"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)))
    for f in ("llrx", "llry", "llrz"):
        np.testing.assert_allclose(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)), **JTOL)


def test_cli_code_option_counts_what_the_step_counts():
    argv = ["--code", "gb48_oc", "--mode", "bp4", "-p", "0.05", "-bs", "8", "--iters", "6", "--max-mc-iter", "2",
            "--target-errors", "1000", "--device", "cpu", "--seed", "3"]
    res = osd_eval.main(argv)
    graph = tc.QuantumGraph.from_code(tc.gb_n48_k6_d8_oc(), stage_mode=True).to("cpu")
    want = np.zeros(2, np.int64)
    for it in range(2):
        gen = torch.Generator().manual_seed(batch_seed(3, 0, 0, it))
        want += np.array([int(c) for c in models.bp4_plain_eval_step(graph, gen, 0.05, 8, num_iter=6)])
    assert int(res.num_blocks[0]) == 16
    assert [int(res.flagged_errors[0]), int(res.logical_errors[0])] == want.tolist()


@pytest.mark.parametrize("name", sorted(osd_eval.CODES))
def test_cli_code_table(name):
    code = osd_eval.build_code(name)
    assert (code.N, code.K) == {"n882": (882, 24), "gb48_oc": (48, 6), "gb46_oc": (46, 2)}[name]
    assert osd_eval.make_parser().parse_args(["--code", name]).code == name


def test_plain_bp2_refuses_a_code_without_qc_structure():
    args = osd_eval.make_parser().parse_args(["--code", "gb46_oc", "--mode", "bp2", "-bs", "4"])
    with pytest.raises(ValueError, match="block-circulant"):
        osd_eval.make_step(args, osd_eval.build_code("gb46_oc"), torch.device("cpu"))


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a card's."""

    is_cuda = True


def test_spans_end_batch_and_counter_of_the_step():
    graph = tc.QuantumGraph.from_code(tc.gb_n46_k2_d9_oc(), stage_mode=True).to("cpu")
    it = 3
    obs.enable()
    for s in range(2):
        models.bp4_plain_eval_step(graph, torch.Generator().manual_seed(s), 0.05, 8, num_iter=it)
    snap = obs.snapshot()
    assert snap["batches"] == 2
    spans = snap["spans"]
    assert spans["bp4.decode"]["count"] == 2 and spans["step.account"]["count"] == 2
    assert spans["step.sample"]["count"] == 4  # the draw, then the pads, syndromes and prior
    assert spans["bp4.logits"]["count"] == 2
    for name in ("bp4.vn", "bp4.cn"):
        assert spans[name]["count"] == 2 * it
        assert {k: v["count"] for k, v in spans[name]["by"]["iteration"].items()} == {i: 2 for i in range(it)}
    assert "bp4.decodes" not in snap["counters"]  # a CPU decode counts nothing
    llr = prior_llr(0.05, graph.n, 8, n_pad=graph.n_pad)
    zeros = torch.zeros((graph.gx.c_pad, 8), dtype=torch.int32)
    bp4.bp4_decode(graph, torch.Tensor._make_subclass(_OnCard, llr), zeros, zeros, 2)
    assert obs.snapshot()["keys"]["bp4.decodes"] == {(8, 2, "boxplus-phi", (94, 10)): 1}


@pytest.mark.parametrize("name", CODES)
def test_family_builder_reads_the_ports_matrices(name):
    hx, hz, lift = ref_codes.family_builder("gb_oc")(_spec(name))
    code = osd_eval.build_code(name)
    assert lift is None
    np.testing.assert_array_equal(hx, code.hx)
    np.testing.assert_array_equal(hz, code.hz)
    built = ref_codes.build_code(_spec(name))
    assert (built.n, built.k) == (code.N, code.K)


def test_the_configuration_names_the_file_it_reads():
    conf = load_json("benchmark/configs/gb48oc_bp4.json")
    assert conf["code"] == _spec("gb48_oc") and conf["port_code"] == "gb48_oc"
    with pytest.raises(ValueError, match="SHA-256"):
        ref_codes.build_code(dict(conf["code"], sha256="0" * 64))


class _Tiny:
    """An irregular CSS code: hx 2 x 4 with 5 edges, hz 1 x 4 with 4."""

    n = 4
    hx = np.array([[1, 1, 0, 0], [0, 1, 1, 1]])
    hz = np.array([[1, 1, 1, 1]])


def test_counts_by_hand_on_a_tiny_irregular_code():
    d = gather_bp4_counts.dims_of(_Tiny)
    assert (d.n, d.m, d.edges) == (4, 3, 9)
    # 2 iterations of 9 x 36 + 4 x 18 + 3, set-up 9 + 16, logits 9 x 12 + 3 x 9 + 4 x 32
    per_sample = 2 * (324 + 72 + 3) + 25 + (108 + 27 + 128)
    assert gather_bp4_counts.gather_bp4_ops(d, 5, 2) == 5 * per_sample
    assert gather_bp4_counts.gather_bp4_bytes(d, 5) == 4 * 5 * (12 + 3) + 4 * 5 * 12
    ms, what = gather_bp4_counts.gather_bp4_bound_ms(d, 5, 2)
    # a code this small moves more than it computes
    assert what == "bytes" and ms == pytest.approx(1e3 * 540 / counts.H100_BYTES)
    assert 1e3 * 5 * per_sample / counts.H100_F32_OPS < ms


def test_the_cells_bound_counts_true_edges():
    code = ref_codes.build_code(_spec("gb48_oc"))
    d = gather_bp4_counts.dims_of(code)
    assert (d.n, d.m, d.edges) == (48, 2000, 23808)  # 23,808 edges, not the 2 x 261 x 56 VN slots
    ms, what = gather_bp4_counts.gather_bp4_bound_ms(d, 20480, 64)
    assert what == "operations" and 16.8 < ms < 17.0
