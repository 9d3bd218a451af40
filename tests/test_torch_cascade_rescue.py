"""The rest of the port's cascade against the JAX package's on GB-48
injected noise: the gather backend (``qc=None``), the chained rescue stage
(``rescue_phi``) on both backends, the overflow count across levels, and
``return_full``.

Decisions are compared per sample with the tie-bound allowance of
tests/test_torch_cascade.py (a sample may differ only if a relative change
of 1e-6 to its prior LLRs moves the port's own decision for it).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feedback_gnn_tpu.decoders import cascade as jcas

from feedback_gnn_tpu_torch.decoders import cascade as tcas
from feedback_gnn_tpu_torch.ops import mod2_matmul
from test_torch_cascade import SCHEDULE, gb48, gb48_plain, one_torch_thread  # noqa: F401  (fixtures)

BACKENDS = {"qc": True, "gather": False}


def final_flags(setup, x_hat, z_hat):
    """Samples whose estimate does not reproduce their syndrome."""
    tg = setup.tg
    return ((mod2_matmul(tg.hz, x_hat) != setup.syn_z).any(0)
            | (mod2_matmul(tg.hx, z_hat) != setup.syn_x).any(0))


@pytest.fixture(scope="module")
def gather_plain(gb48):  # noqa: F811
    return gb48.run_jax(qc=False), gb48.run_port(qc=False)


def test_gather_cascade_matches_jax_per_sample(gb48, gather_plain):  # noqa: F811
    ref, out = gather_plain
    assert out[0].dtype == torch.int32 and out[0].shape == ref[0].shape
    gb48.assert_same_or_tie_bound(ref, out, qc=False)
    assert gb48.counts(*out[:2]) == gb48.counts(*ref[:2])
    flagged, logical = gb48.counts(*out[:2])
    assert 0 < flagged < 64 and logical > 0
    assert int(out[2]) == int(ref[2]) == 0


@pytest.mark.parametrize("cfg", [
    dict(compact_fraction=0.875, stage1_prepass=4, round_fraction=0.75),
    dict(compact_fraction=0.5, stage1_prepass=4, round_fraction=0.25),
], ids=["no_overflow", "overflow"])
def test_gather_compaction_matches_jax(gb48, gather_plain, cfg):  # noqa: F811
    """The gather backend rounds capacities to a tile of 8 (not
    qc_batch_tile, left at its default 128 here): the same decisions and
    overflow as JAX, and without overflow the uncompacted counts."""
    out, ref = gb48.run_port(qc=False, **cfg), gb48.run_jax(qc=False, **cfg)
    np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(out[1].numpy(), ref[1].numpy())
    assert int(out[2]) == int(ref[2])
    if cfg["compact_fraction"] == 0.5:
        assert int(out[2]) > 0
    else:
        assert int(out[2]) == 0
        assert gb48.counts(*out[:2]) == gb48.counts(*gather_plain[1][:2])


@pytest.mark.parametrize("rescue", ["tf", "tf,accurate"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_rescue_matches_jax_per_sample(gb48, gb48_plain, gather_plain, backend, rescue):  # noqa: F811
    """Chained rescue stages: per-sample decisions equal to JAX's (the QC
    backend against the interpret-mode kernel), no overflow at a capacity
    that holds the batch (at this p and schedule about half the samples
    stay flagged), and never more flagged samples than without the
    rescue."""
    qc = BACKENDS[backend]
    cfg = dict(rescue_phi=rescue, rescue_fraction=1.0, qc_batch_tile=8)
    ref, out = gb48.run_jax(qc=qc, **cfg), gb48.run_port(qc=qc, **cfg)
    gb48.assert_same_or_tie_bound(ref, out, qc=qc, **cfg)
    assert gb48.counts(*out[:2]) == gb48.counts(*ref[:2])
    assert int(out[2]) == int(ref[2]) == 0
    plain = (gb48_plain if qc else gather_plain)[1]
    before = int(final_flags(gb48, *plain[:2]).sum())
    after = int(final_flags(gb48, *out[:2]).sum())
    assert 0 < before and after <= before


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_overflow_counts_distinct_samples(gb48, backend):  # noqa: F811
    """A sample that overflows level 1 stays flagged and can overflow the
    rescue too: it counts once (the element-wise max of the per-level
    masks), as in JAX."""
    qc = BACKENDS[backend]
    level1 = dict(compact_fraction=0.25, qc_batch_tile=8)
    only_l1 = gb48.run_port(qc=qc, **level1)
    flagged = final_flags(gb48, *only_l1[:2])
    cap = 8  # rescue_fraction 1/64 of 64 samples, rounded to the tile
    rescue_ov = int(flagged.sum()) - cap
    out = gb48.run_port(qc=qc, rescue_phi="tf", rescue_fraction=1 / 64, **level1)
    ref = gb48.run_jax(qc=qc, rescue_phi="tf", rescue_fraction=1 / 64, **level1)
    l1_ov = int(only_l1[2])
    assert l1_ov > 0 and rescue_ov > 0
    assert int(out[2]) == int(ref[2])
    assert max(l1_ov, rescue_ov) <= int(out[2]) < l1_ov + rescue_ov


@pytest.mark.parametrize("rescue,warns", [("expm1", True), ("tf", False)])
def test_rescue_same_formulation_warns(gb48, rescue, warns):  # noqa: F811
    """A rescue formulation equal to the main one (the default, expm1) is a
    guaranteed no-op and says so; another one does not warn."""
    cols = slice(0, 8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gb48.run_port(cols=cols, rescue_phi=rescue, qc_batch_tile=8)
    hits = [w for w in caught if "guaranteed no-op" in str(w.message)]
    assert bool(hits) == warns
    if warns:
        assert issubclass(hits[0].category, UserWarning)


def test_unknown_rescue_formulation_raises(gb48):  # noqa: F811
    with pytest.raises(ValueError, match="rescue phi formulation"):
        gb48.run_port(cols=slice(0, 8), rescue_phi="tanh")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_return_full_matches_jax(gb48, monkeypatch, backend):  # noqa: F811
    """sandwich_eval_step(return_full=True) on the same noise: batch-first
    syndromes and logical syndromes over the true rows, equal to JAX's."""
    qc = BACKENDS[backend]
    n, b = gb48.tg.n, gb48.noise_x.shape[1]
    nx, nz = gb48.noise_x[:n].bool(), gb48.noise_z[:n].bool()
    monkeypatch.setattr(jcas, "pauli_iid", lambda *a: (jnp.asarray(nx.numpy()), jnp.asarray(nz.numpy())))
    monkeypatch.setattr(tcas, "pauli_iid", lambda *a: (nx, nz))
    jcfg = jcas.CascadeConfig(**SCHEDULE)
    ref = jax.jit(lambda key: jcas.sandwich_eval_step(
        gb48.jg, [gb48.jparams], jcfg, key, 0.1, b, return_full=True,
        qc=gb48.jqc if qc else None))(jax.random.PRNGKey(0))
    out = tcas.sandwich_eval_step(gb48.tg, [gb48.tparams], tcas.CascadeConfig(**SCHEDULE),
                                  torch.Generator(), 0.1, b, return_full=True,
                                  qc=gb48.tqc if qc else None)
    tg = gb48.tg
    assert out[0].shape == (b, tg.gz.num_cn + tg.gx.num_cn)
    assert out[1].shape == (b, tg.hx_perp_rows + tg.hz_perp_rows)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert (out[0] != 0).any(1).sum() > 0  # the batch has flagged samples
