"""The port's OSD-0 (decoders/osd.py) and BP+OSD steps (models.py) against
the JAX package.

OSD-0 is integer only: on the same LLRs, basis and syndromes the port's
solutions must equal JAX's bit for bit, also where LLR ties decide the
column order (the LLRs below are drawn from a few values, so most are
tied).  The BP+OSD steps get the same numpy noise as the JAX steps, whose
samplers are replaced by the injected noise; the counts must be equal.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu import models as jmodels
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.codes.graph import build_graph as j_build_graph
from feedback_gnn_tpu.decoders.bp4 import bp4_decode as j_bp4_decode
from feedback_gnn_tpu.decoders.cascade import prior_llr as j_prior_llr
from feedback_gnn_tpu.decoders.osd import bp_osd_correct as j_bp_osd_correct
from feedback_gnn_tpu.decoders.osd import osd0_decode as j_osd0_decode

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import models
from feedback_gnn_tpu_torch.decoders import BP4Result
from feedback_gnn_tpu_torch.decoders.osd import bp_osd_correct, osd0_decode

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_montecarlo import REPO, jax_key_noise, port_seed_noise

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
CODES = {
    "surface3": lambda m: m.create_surface_codes(3),
    "gb48": lambda m: m.create_generalized_bicycle_codes(*GB48),
    "ghp21": lambda m: m.create_QC_GHP_codes(7, m.create_cyclic_permuting_matrix(3, [2, 4, 0]), [0, 1, 3]),
}


@pytest.fixture(scope="module")
def gb48():
    return jc.create_generalized_bicycle_codes(*GB48), tc.create_generalized_bicycle_codes(*GB48)


def tied_llrs(rng, shape, levels):
    """LLRs drawn from ``levels`` distinct values (+-0.0 among them): most
    entries tie with others."""
    values = np.concatenate([[0.0, -0.0], rng.normal(size=levels - 2) * 3.0]).astype(np.float32)
    return values[rng.integers(0, levels, shape)]


@pytest.mark.parametrize("levels", [3, 12, 0], ids=["ties3", "ties12", "continuous"])
@pytest.mark.parametrize("code", sorted(CODES))
def test_osd0_matches_jax_bit_for_bit(code, levels):
    tcode = CODES[code](tc)
    rng = np.random.default_rng(len(code) * 10 + levels)
    for basis in (np.asarray(tcode.hx_basis), np.asarray(tcode.hz_basis)):
        rank, n = basis.shape
        b = 24
        llr = tied_llrs(rng, (b, n), levels) if levels else rng.normal(size=(b, n)).astype(np.float32)
        syndrome = (basis @ rng.integers(0, 2, (n, b)) % 2).astype(np.int32)
        ref = np.asarray(j_osd0_decode(jnp.asarray(llr), jnp.asarray(basis), jnp.asarray(syndrome)))
        out = osd0_decode(torch.as_tensor(llr), basis, torch.as_tensor(syndrome))
        assert out.dtype == torch.int32 and out.shape == (b, n)
        np.testing.assert_array_equal(out.numpy(), ref)
        # and it solves the syndrome
        np.testing.assert_array_equal(basis @ out.numpy().T % 2, syndrome)


def test_osd0_prefers_unreliable_positions():
    """With one strongly unreliable position carrying the error, OSD-0
    returns exactly that single flip."""
    basis = np.asarray(tc.create_surface_codes(3).hx_basis)
    n = basis.shape[1]
    noise = np.zeros((n, 1), np.int64)
    noise[3] = 1
    llr = np.full((1, n), 10.0, np.float32)
    llr[0, 3] = -10.0
    out = osd0_decode(torch.as_tensor(llr), basis, torch.as_tensor(basis @ noise % 2)).numpy()
    assert out[0, 3] == 1 and out.sum() == 1


def _bp_inputs(jcode, b, p, seed):
    """GB-48 depolarizing noise, padded, and a short BP4 decode of it by
    JAX (minsum x0.8, 6 iterations: many samples stay flagged)."""
    jg = JQuantumGraph.from_code(jcode, stage_mode=True)
    n, n_pad = jg.n, jg.n_pad
    rng = np.random.default_rng(seed)
    u = rng.random((n, b))
    nx = np.pad((u < 2 * p / 3).astype(np.int32), ((0, n_pad - n), (0, 0)))
    nz = np.pad(((u >= p / 3) & (u < p)).astype(np.int32), ((0, n_pad - n), (0, 0)))
    sx = (np.asarray(jg.hx) @ nz % 2).astype(np.int32)
    sz = (np.asarray(jg.hz) @ nx % 2).astype(np.int32)
    res = j_bp4_decode(jg, j_prior_llr(p, n, b, n_pad=n_pad), jnp.asarray(sx), jnp.asarray(sz), 6,
                       "minsum", 0.8)
    return jg, nx, nz, res


@pytest.mark.parametrize("cap", [None, 40, 8], ids=["full", "cap40", "cap8_overflow"])
def test_bp_osd_correct_matches_jax(gb48, cap):
    jcode, tcode = gb48
    jg, nx, nz, jres = _bp_inputs(jcode, 48, 0.12, seed=3)
    tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
    tres = BP4Result(*[torch.as_tensor(np.array(f)) if f is not None else None for f in jres])
    args = (jcode.pivot_hx, jcode.pivot_hz, jcode.hx_basis, jcode.hz_basis)
    ref = j_bp_osd_correct(jg, jres, jnp.asarray(nx), jnp.asarray(nz), *args, compact_cap=cap)
    out = bp_osd_correct(tg, tres, torch.as_tensor(nx), torch.as_tensor(nz), *args, compact_cap=cap)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    flagged, overflow = int(out[2].sum()), int(out[3])
    assert flagged > 8
    assert overflow == (flagged - 8 if cap == 8 else 0)


@pytest.mark.parametrize("cap", [None, 24, 4], ids=["full", "cap24", "cap4_overflow"])
def test_bp4_osd_counts_match_jax(gb48, monkeypatch, cap):
    jcode, tcode = gb48
    p, b = 0.12, 64
    rng = np.random.default_rng(21)
    u = rng.random((jcode.N, b))
    nx, nz = u < 2 * p / 3, (u >= p / 3) & (u < p)
    monkeypatch.setattr(jmodels, "pauli_iid", lambda *a: (jnp.asarray(nx), jnp.asarray(nz)))
    jg = JQuantumGraph.from_code(jcode, stage_mode=True)
    ref = jmodels.bp4_osd_eval_step(jg, jcode, jax.random.PRNGKey(0), p, b, num_iter=6,
                                    osd_compact_cap=cap)
    tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
    out = models.bp4_osd_count(tg, tcode, torch.as_tensor(nx), torch.as_tensor(nz), p, num_iter=6,
                               osd_compact_cap=cap)
    assert len(out) == len(ref) == (2 if cap is None else 3)
    assert [int(o) for o in out] == [int(r) for r in ref]
    assert int(out[0]) > 4 and int(out[1]) > 0
    if cap == 4:
        assert int(out[2]) == int(out[0]) - 4


@pytest.mark.parametrize("cap", [None, 24, 4], ids=["full", "cap24", "cap4_overflow"])
def test_bp2_osd_counts_match_jax(gb48, monkeypatch, cap):
    jcode, tcode = gb48
    hx, lx = np.asarray(tcode.hx), np.asarray(tcode.lx)
    basis, pivot = tc.row_basis(hx), tc.row_echelon(hx.T)[3]
    p, b = 0.08, 64
    noise = np.random.default_rng(22).random((hx.shape[1], b)) < p
    monkeypatch.setattr(jmodels, "bsc_sample", lambda key, p, shape: jnp.asarray(noise))
    ref = jmodels.bp2_osd_eval_step(j_build_graph(hx), hx, basis, pivot, lx, jax.random.PRNGKey(0),
                                    p, b, num_iter=6, osd_compact_cap=cap)
    out = models.bp2_osd_count(tc.build_graph(hx).to("cpu"), torch.as_tensor(hx), basis, pivot, lx,
                               torch.as_tensor(noise), p, num_iter=6, osd_compact_cap=cap)
    assert len(out) == len(ref) == (2 if cap is None else 3)
    assert [int(o) for o in out] == [int(r) for r in ref]
    assert int(out[0]) > 4
    if cap == 4:
        assert int(out[2]) == int(out[0]) - 4


def _load_jax_osd_eval():
    spec = importlib.util.spec_from_file_location("jax_osd_eval", os.path.join(REPO, "examples", "osd_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = ["-bs", "32", "--max-mc-iter", "2", "--target-errors", "100", "-p", "0.06", "0.05"]


def test_osd_eval_bp2_osd_matches_jax(monkeypatch):
    """examples/osd_eval.py --mode bp2-osd and its port on [[882,24]] at a
    tiny size, each sampler replaced by the same numpy noise per (point,
    iteration): the SimResults' counts are equal."""
    n, b = 882, 32
    argv = TINY + ["--mode", "bp2-osd", "--osd-cap", "16", "--seed", "3"]

    def noise(i, it):
        return np.random.default_rng([i, it]).random((n, b)) < (0.06, 0.05)[i]

    import feedback_gnn_tpu.sim as jsim
    from feedback_gnn_tpu_torch.cli import osd_eval

    captured = {}
    simulate = jsim.PlotLER.simulate
    monkeypatch.setattr(jsim.PlotLER, "simulate",
                        lambda self, *a, **k: captured.setdefault("ref", simulate(self, *a, **k)))
    monkeypatch.setattr(jmodels, "bsc_sample", jax_key_noise(3, 2, 2, lambda i, it: (noise(i, it),)))
    monkeypatch.setattr(sys, "argv", ["osd_eval.py"] + argv)
    _load_jax_osd_eval().main()
    ref = captured["ref"]

    monkeypatch.setattr(models, "bsc_sample", port_seed_noise(3, 2, 2, lambda i, it: (noise(i, it),)))
    out = osd_eval.main(argv + ["--device", "cpu"])
    for k in ("flagged_errors", "logical_errors", "num_blocks", "status", "overflow"):
        np.testing.assert_array_equal(getattr(out, k), getattr(ref, k), err_msg=k)
    assert out.flagged_errors.sum() > 0


@pytest.mark.parametrize("mode", ["bp4", "bp2", "bp4-osd"])
def test_osd_eval_modes_run_on_cpu(mode):
    """The other three modes of the port's CLI, sampled on the CPU: counts
    in range, one p point, the protocol's status."""
    from feedback_gnn_tpu_torch.cli import osd_eval

    res = osd_eval.main(["-bs", "16", "--max-mc-iter", "1", "-p", "0.1", "--mode", mode, "--iters", "4",
                         "--osd-cap", "8", "--device", "cpu"])
    assert res.num_blocks.tolist() == [16]
    assert 0 <= res.logical_errors[0] <= 16 and 0 <= res.flagged_errors[0] <= 16
    assert res.status[0] in (1, 2)
