"""The port's Monte-Carlo steps (models.py) and binary channels against the
JAX package.

The steps' decode-and-count parts get the same numpy noise as the JAX
steps, whose samplers are replaced by the injected noise; the counts must
be equal.  The samplers themselves are held to their statistics (torch's
and JAX's random streams differ): the BSC flip rate within 4.5 sigma of p,
as tests/test_channels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu import models as jmodels
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.codes.graph import build_graph as j_build_graph
from feedback_gnn_tpu.codes.qc import detect_qc_structure as j_detect_qc

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import models, obs
from feedback_gnn_tpu_torch.channels import binary_source, bsc_sample, bsc_sample_ste, depolarizing_probs
from feedback_gnn_tpu_torch.sim import compute_bler, count_block_errors, count_errors, llr2mi

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])


@pytest.fixture(scope="module")
def gb48():
    return jc.create_generalized_bicycle_codes(*GB48), tc.create_generalized_bicycle_codes(*GB48)


@pytest.mark.parametrize("accounting", ["all", "undetected"])
@pytest.mark.parametrize("backend", ["gather", "qc"])
def test_bp2_bsc_counts_match_jax(gb48, monkeypatch, backend, accounting):
    jcode, tcode = gb48
    hx, lx = np.asarray(tcode.hx), np.asarray(tcode.lx)
    p, b = 0.06, 96
    noise = np.random.default_rng(11).random((hx.shape[1], b)) < p
    monkeypatch.setattr(jmodels, "bsc_sample", lambda key, p, shape: jnp.asarray(noise))
    jspec = j_detect_qc(hx, 24) if backend == "qc" else None
    spec = tc.detect_qc_structure(hx, 24) if backend == "qc" else None
    ref = jmodels.bp2_bsc_eval_step(j_build_graph(hx), hx, lx, jax.random.PRNGKey(0), p, b,
                                    num_iter=8, qc_spec=jspec, accounting=accounting)
    before = obs.counter("k2.launches")
    out = models.bp2_bsc_count(tc.build_graph(hx).to("cpu"), torch.as_tensor(hx), lx,
                               torch.as_tensor(noise), p, num_iter=8, qc_spec=spec,
                               accounting=accounting)
    assert obs.counter("k2.launches") == before
    assert (int(out[0]), int(out[1])) == (int(ref[0]), int(ref[1]))
    assert int(out[0]) > 0  # the case exercises failures


@pytest.mark.parametrize("accounting", ["all", "undetected"])
@pytest.mark.parametrize("cn_type,factor", [("minsum", 0.8), ("boxplus-phi", 1.0)])
def test_bp4_plain_counts_match_jax(gb48, monkeypatch, cn_type, factor, accounting):
    jcode, tcode = gb48
    jg = JQuantumGraph.from_code(jcode, stage_mode=True)
    tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
    p, b = 0.08, 96
    px, py, pz = depolarizing_probs(p)
    u = np.random.default_rng(12).random((tg.n, b))
    nx, nz = u < px, (u >= px - py) & (u < px + pz - py)
    monkeypatch.setattr(jmodels, "pauli_iid", lambda *a: (jnp.asarray(nx), jnp.asarray(nz)))
    ref = jmodels.bp4_plain_eval_step(jg, jax.random.PRNGKey(0), p, b, num_iter=8, cn_type=cn_type,
                                      normalization_factor=factor, accounting=accounting)
    out = models.bp4_plain_count(tg, torch.as_tensor(nx), torch.as_tensor(nz), p, num_iter=8,
                                 cn_type=cn_type, normalization_factor=factor, accounting=accounting)
    assert (int(out[0]), int(out[1])) == (int(ref[0]), int(ref[1]))
    assert int(out[0]) > 0


def test_eval_steps_sample_and_count(gb48):
    """The full steps on the CPU: sampling, decoding and counting."""
    _, tcode = gb48
    hx = torch.as_tensor(np.asarray(tcode.hx), dtype=torch.float32)
    spec = tc.detect_qc_structure(np.asarray(tcode.hx), 24)
    g = torch.Generator().manual_seed(3)
    b = 64
    for qc_spec in (None, spec):
        f, lg = models.bp2_bsc_eval_step(tc.build_graph(np.asarray(tcode.hx)).to("cpu"), hx,
                                         np.asarray(tcode.lx), g, 0.05, b, num_iter=8,
                                         qc_spec=qc_spec)
        assert f.dtype == torch.int32 and 0 <= int(lg) and 0 <= int(f) <= b
    tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
    f, lg = models.bp4_plain_eval_step(tg, g, 0.05, b, num_iter=8, accounting="undetected")
    assert 0 <= int(f) <= b and 0 <= int(lg) <= b - int(f)


def test_counts_accountings():
    s_hat = torch.tensor([[0, 1, 0, 0], [0, 0, 0, 1]])
    ls_hat = torch.tensor([[1, 1, 0, 0], [0, 0, 0, 0]])
    assert [int(c) for c in models._counts(s_hat, ls_hat)] == [2, 2]
    assert [int(c) for c in models._counts(s_hat, ls_hat, "undetected")] == [2, 1]
    with pytest.raises(ValueError):
        models._counts(s_hat, ls_hat, "some")


def test_paper_code_qc_spec_agrees():
    """The two ways to get the QC spec of [[882,24]]'s hx give the same spec."""
    code = tc.ghp_882_24()
    qc = tc.qc_pair_from_code(code)
    spec = tc.detect_qc_structure(np.asarray(code.hx), qc.l)
    assert spec == qc.qx and (spec.l, spec.mb, spec.nb, spec.num_groups) == (63, 7, 14, 42)


# ---- channels and metrics ------------------------------------------------------


def test_bsc_flip_rate():
    p, shape = 0.11, (200, 2000)
    e = bsc_sample(torch.Generator().manual_seed(2), p, shape)
    assert e.shape == shape and e.dtype == torch.bool
    total = shape[0] * shape[1]
    assert abs(int(e.sum()) - total * p) < 4.5 * np.sqrt(total * p * (1 - p))


def test_bsc_ste_forward_and_gradient():
    p = torch.tensor(0.2, requires_grad=True)
    e = bsc_sample_ste(torch.Generator().manual_seed(3), p, (200, 500))
    vals = torch.unique(e.detach())
    assert set(vals.tolist()) <= {0.0, 1.0}
    total = e.numel()
    assert abs(float(e.sum()) - total * 0.2) < 4.5 * np.sqrt(total * 0.2 * 0.8)
    e.mean().backward()
    assert float(p.grad) > 0.0


def test_binary_source_rate():
    bits = binary_source(torch.Generator().manual_seed(4), (400, 500))
    assert bits.dtype == torch.float32 and set(torch.unique(bits).tolist()) <= {0.0, 1.0}
    total = bits.numel()
    assert abs(float(bits.sum()) - total / 2) < 4.5 * np.sqrt(total / 4)


def test_metrics_match_jax():
    from feedback_gnn_tpu.sim import metrics as jm

    rng = np.random.default_rng(5)
    b = rng.integers(0, 2, (30, 40))
    b_hat = b ^ (rng.random((30, 40)) < 0.05)
    tb, tbh = torch.as_tensor(b), torch.as_tensor(b_hat)
    assert int(count_errors(tb, tbh)) == int(jm.count_errors(jnp.asarray(b), jnp.asarray(b_hat)))
    assert int(count_block_errors(tb, tbh)) == int(jm.count_block_errors(jnp.asarray(b), jnp.asarray(b_hat)))
    np.testing.assert_allclose(float(compute_bler(tb, tbh)),
                               float(jm.compute_bler(jnp.asarray(b), jnp.asarray(b_hat))), rtol=1e-6)
    llr = (rng.standard_normal((3, 16, 8)) * 8.0).astype(np.float32)
    w = (rng.random((3, 16, 1)) < 0.7).astype(np.float32)
    np.testing.assert_allclose(float(llr2mi(torch.as_tensor(llr), weight=torch.as_tensor(w))),
                               float(jm.llr2mi(jnp.asarray(llr), weight=jnp.asarray(w))), rtol=1e-5)
    s = np.sign(rng.standard_normal((3, 16, 8))).astype(np.float32)
    np.testing.assert_allclose(float(llr2mi(torch.as_tensor(llr), s=torch.as_tensor(s))),
                               float(jm.llr2mi(jnp.asarray(llr), s=jnp.asarray(s))), rtol=1e-5)
