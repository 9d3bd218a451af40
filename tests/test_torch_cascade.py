"""The port's sandwich cascade against the JAX package's QC cascade
(Pallas kernel in interpret mode) on injected noise.

Decisions are compared per sample.  A sample may differ only if it is
tie-bound: a relative change of 1e-6 (about eight float32 ulps) to its
prior LLRs changes the port's own decision for it.  On the cases below no
sample differs at all.  Error counts are built from the port's
mod2_matmul for both decodes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.codes.qc import qc_pair_from_code as j_qc_pair
from feedback_gnn_tpu.decoders import cascade as jcas
from feedback_gnn_tpu.decoders.gnn_feedback import init_feedback_gnn as j_init
from feedback_gnn_tpu.decoders.gnn_feedback import load_weights as j_load_weights

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.channels import depolarizing_probs, pauli_iid
from feedback_gnn_tpu_torch.decoders import cascade as tcas
from feedback_gnn_tpu_torch.decoders import params_from_numpy
from feedback_gnn_tpu_torch.entry import WEIGHTS
from feedback_gnn_tpu_torch.ops import mod2_matmul

TIE_REL = 1e-6
GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
SCHEDULE = dict(num_iter1=8, num_iter2=4, num_rounds=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread during each test: the suite runs in
    several worker processes on a few cores, where torch's OpenMP threads
    spin against each other and the many small ops here slow down a
    hundredfold.  The thread count is restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Setup:
    def __init__(self, jcode, tcode, jparams, b, p, seed):
        self.jg = JQuantumGraph.from_code(jcode, stage_mode=True)
        self.jqc = j_qc_pair(jcode)
        self.tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
        self.tqc = tc.qc_pair_from_code(tcode)
        self.jparams = jparams
        self.tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
        n, n_pad = self.tg.n, self.tg.n_pad
        rng = np.random.default_rng(seed)
        px, py, pz = depolarizing_probs(p)
        u = rng.random((n, b))
        pad = ((0, n_pad - n), (0, 0))
        self.noise_x = torch.as_tensor(np.pad((u < px).astype(np.int32), pad))
        self.noise_z = torch.as_tensor(np.pad(((u >= px - py) & (u < px + pz - py)).astype(np.int32), pad))
        self.syn_x = mod2_matmul(self.tg.hx, self.noise_z)
        self.syn_z = mod2_matmul(self.tg.hz, self.noise_x)
        self.llr0 = tcas.prior_llr(0.05, n, b, n_pad=n_pad)

    def run_jax(self, qc=True, **cfg):
        """JAX's decode, on the QC backend (the Pallas kernel in interpret
        mode) or, with ``qc=False``, the gather one."""
        jcfg = jcas.CascadeConfig(**SCHEDULE, **cfg)

        @jax.jit
        def dec(llr, sx, sz):
            return jcas.sandwich_decode(self.jg, [self.jparams], jcfg, llr, sx, sz, sz, sx,
                                        qc=self.jqc if qc else None, with_overflow=True)

        out = dec(*(jnp.asarray(t.numpy()) for t in (self.llr0, self.syn_x, self.syn_z)))
        return tuple(torch.tensor(np.asarray(o)) for o in out)

    def run_port(self, llr0=None, cols=slice(None), qc=True, **cfg):
        llr0 = self.llr0 if llr0 is None else llr0
        tcfg = tcas.CascadeConfig(**SCHEDULE, **cfg)
        sx, sz = self.syn_x[:, cols], self.syn_z[:, cols]
        return tcas.sandwich_decode(self.tg, [self.tparams], tcfg, llr0[..., cols], sx, sz, sz, sx,
                                    qc=self.tqc if qc else None, with_overflow=True)

    def counts(self, x_hat, z_hat):
        xd, zd = self.noise_x ^ x_hat, self.noise_z ^ z_hat
        s = torch.cat([mod2_matmul(self.tg.hz, xd), mod2_matmul(self.tg.hx, zd)])
        ls = torch.cat([mod2_matmul(self.tg.hx_perp, xd), mod2_matmul(self.tg.hz_perp, zd)])
        return int((s != 0).any(0).sum()), int((ls != 0).any(0).sum())

    def assert_same_or_tie_bound(self, ref, out, **cfg):
        """Equal decisions per sample, or the sample is tie-bound (see the
        module docstring; checked on the sample alone, decoded with ``cfg``
        but without compaction, where samples decode independently)."""
        differ = ((ref[0] != out[0]).any(0) | (ref[1] != out[1]).any(0)).nonzero().flatten()
        for s in differ.tolist():
            cols = slice(s, s + 1)
            base = self.run_port(cols=cols, **cfg)
            moved = False
            for f in (1.0 + TIE_REL, 1.0 - TIE_REL):
                x, z, _ = self.run_port(llr0=self.llr0 * f, cols=cols, **cfg)
                moved |= bool((x != base[0]).any() or (z != base[1]).any())
            assert moved, f"sample {s} differs from JAX and is not tie-bound"


@pytest.fixture(scope="module")
def gb48():
    return Setup(jc.create_generalized_bicycle_codes(*GB48), tc.create_generalized_bicycle_codes(*GB48),
                 j_init(jax.random.PRNGKey(0)), b=64, p=0.1, seed=0)


@pytest.fixture(scope="module")
def gb48_plain(gb48):
    """JAX's and the port's uncompacted decodes of the GB-48 batch."""
    return gb48.run_jax(), gb48.run_port()


def test_gb48_matches_jax_per_sample(gb48, gb48_plain):
    ref, out = gb48_plain
    assert out[0].dtype == torch.int32 and out[0].shape == ref[0].shape
    gb48.assert_same_or_tie_bound(ref, out)
    assert gb48.counts(*out[:2]) == gb48.counts(*ref[:2])
    flagged, logical = gb48.counts(*out[:2])
    assert 0 < flagged < 64 and logical > 0  # the batch has decoded and failed samples
    assert int(out[2]) == int(ref[2]) == 0


def test_compaction_without_overflow_keeps_counts(gb48, gb48_plain):
    """Overflow 0: the compacted cascade (prepass + two levels) gives the
    uncompacted counts, and JAX's compacted decisions."""
    _, plain = gb48_plain
    cfg = dict(compact_fraction=0.875, stage1_prepass=4, round_fraction=0.75, qc_batch_tile=8)
    out = gb48.run_port(**cfg)
    assert int(out[2]) == 0
    assert gb48.counts(*out[:2]) == gb48.counts(*plain[:2])
    ref = gb48.run_jax(**cfg)
    np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(out[1].numpy(), ref[1].numpy())


def test_compaction_overflow_matches_jax(gb48):
    """Undersized capacities: the same overflow count and decisions as JAX
    (the capacity is rounded to qc_batch_tile in both)."""
    cfg = dict(compact_fraction=0.5, stage1_prepass=4, round_fraction=0.25, qc_batch_tile=8)
    out, ref = gb48.run_port(**cfg), gb48.run_jax(**cfg)
    assert int(out[2]) == int(ref[2]) > 0
    np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(out[1].numpy(), ref[1].numpy())


def test_eval_step_counts_its_own_noise(gb48):
    """sandwich_eval_step = the generator's noise, decoded and counted."""
    tg, b, p = gb48.tg, 32, 0.1
    cfg = tcas.CascadeConfig(**SCHEDULE)
    f, l, ov = tcas.sandwich_eval_step(tg, [gb48.tparams], cfg, torch.Generator().manual_seed(5), p, b,
                                       qc=gb48.tqc, return_overflow=True)
    nx, nz = pauli_iid(torch.Generator().manual_seed(5), *depolarizing_probs(p), tg.n, b)
    pad = (0, 0, 0, tg.n_pad - tg.n)
    nx, nz = (torch.nn.functional.pad(t.to(torch.int32), pad) for t in (nx, nz))
    sx, sz = mod2_matmul(tg.hx, nz), mod2_matmul(tg.hz, nx)
    x, z = tcas.sandwich_decode(tg, [gb48.tparams], cfg, tcas.prior_llr(0.05, tg.n, b, tg.n_pad),
                                sx, sz, sz, sx, qc=gb48.tqc)
    xd, zd = nx ^ x, nz ^ z
    flagged = (torch.cat([mod2_matmul(tg.hz, xd), mod2_matmul(tg.hx, zd)]) != 0).any(0).sum()
    logical = (torch.cat([mod2_matmul(tg.hx_perp, xd), mod2_matmul(tg.hz_perp, zd)]) != 0).any(0).sum()
    assert (int(f), int(l), int(ov)) == (int(flagged), int(logical), 0)


def test_entry_runs_on_cpu():
    """entry(device="cpu"): the flagship step, sampled counts in range."""
    from feedback_gnn_tpu_torch.entry import entry

    fn, (gen, p) = entry("cpu")
    assert gen.device.type == "cpu" and p == 0.08
    flagged, logical = fn(gen, 0.12)
    assert flagged.dtype == logical.dtype == torch.int64
    assert 0 <= int(flagged) <= 256 and 0 <= int(logical) <= 256


@pytest.mark.slow
def test_882_shipped_weights_match_jax_per_sample(ghp882):
    """[[882,24]] with the shipped weights at reduced iterations (8/4, nG=2,
    B=16).  Slow: JAX's interpret-mode kernel alone takes over 20 s here."""
    s = Setup(ghp882, tc.ghp_882_24(), j_load_weights(WEIGHTS["n882"]), b=16, p=0.12, seed=0)
    ref, out = s.run_jax(), s.run_port()
    s.assert_same_or_tie_bound(ref, out)
    assert s.counts(*out[:2]) == s.counts(*ref[:2])
