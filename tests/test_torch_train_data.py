"""The port's failure mining and data pipeline (channels/pauli.py's
fixed-weight draw, train/data.py) against the JAX package's, on GB-48.

Random streams differ between the packages, so per-sample comparisons
feed the port JAX's draws: the fixed-weight construction gets JAX's
positions and uniforms, each miner's body JAX's noise.  The QC miners run
JAX's Pallas kernel in interpret mode and the port's plain version of K1,
at 12 iterations as tests/test_training.py does.  Flagged sets are
compared sample for sample.  The hard miner's GNN reads the first BP
run's marginals, which saturate (|LLR| ~ 64) where the two packages'
float32 differ by O(1) (ROADMAP C); a sample of that miner may differ only
if the port's GNN and second BP, fed JAX's first-run marginals and
logits, flag it as JAX does (one of 128 in the QC case).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.channels.pauli import pauli_fixed_weight_traced as j_fixed_weight_traced
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.codes.qc import qc_pair_from_code as j_qc_pair
from feedback_gnn_tpu.decoders.gnn_feedback import load_weights as j_load_weights
from feedback_gnn_tpu.train import data as jdata

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.channels import pauli
from feedback_gnn_tpu_torch.config import CODE_REGISTRY
from feedback_gnn_tpu_torch.decoders import feedback_gnn_apply, load_weights
from feedback_gnn_tpu_torch.train import data as tdata

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
ITERS = 12


class Setup:
    def __init__(self):
        self.jcode = jc.create_generalized_bicycle_codes(*GB48)
        tcode = tc.create_generalized_bicycle_codes(*GB48)
        self.jg = JQuantumGraph.from_code(self.jcode, stage_mode=True)
        self.tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
        self.jqc, self.tqc = j_qc_pair(self.jcode), tc.qc_pair_from_code(tcode)
        # the shipped GNN of [[882,24]]: its shapes fit any code; on GB-48
        # the cascade leaves fewer samples flagged than BP only at low weight
        shipped = CODE_REGISTRY["n882"]["weights"]
        self.jparams, self.tparams = j_load_weights(shipped), load_weights(shipped, "cpu")


@pytest.fixture(scope="module")
def setup():
    return Setup()


def _t(a):
    return torch.tensor(np.asarray(a))


# ---- the fixed-weight channel ------------------------------------------------


def _jax_draw(key, n, batch, wt_max):
    """The positions and uniforms pauli_fixed_weight_traced draws from ``key``."""
    kpos, kval = jax.random.split(key)
    pos = jax.vmap(lambda k: jax.random.permutation(k, n)[:wt_max])(jax.random.split(kpos, batch))
    return np.asarray(pos), np.asarray(jax.random.uniform(kval, (batch, wt_max), jnp.float32))


@pytest.mark.parametrize("wt", [0, 5, 12])
def test_fixed_weight_construction_matches_jax(setup, wt):
    n, batch, wt_max = setup.jg.n, 64, 12
    key = jax.random.PRNGKey(7)
    ref = j_fixed_weight_traced(key, jnp.int32(wt), n, batch, wt_max)
    pos, u = _jax_draw(key, n, batch, wt_max)
    out = pauli.fixed_weight_from_draw(_t(pos).to(torch.int64), _t(u), wt, n)
    for o, r in zip(out, ref):
        assert o.dtype == torch.bool and o.shape == (n, batch)
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_fixed_weight_sampling():
    """Support weight exactly wt for every sample, X/Y/Z shares 1/3 each
    (within 5 sigma), the same draw for the same seed, and
    pauli_fixed_weight equal to the traced form at wt_max = wt."""
    n, batch, wt = 96, 4096, 9
    g = torch.Generator().manual_seed(3)
    nx, nz = pauli.pauli_fixed_weight_traced(g, torch.tensor(wt), n, batch, 20)
    assert ((nx | nz).sum(0) == wt).all()
    total = batch * wt
    for share in ((nx & ~nz).sum(), (nx & nz).sum(), (~nx & nz).sum()):
        assert abs(int(share) / total - 1 / 3) < 5 * (2 / 9 / total) ** 0.5
    a = pauli.pauli_fixed_weight(torch.Generator().manual_seed(5), wt, n, 32)
    b = pauli.pauli_fixed_weight_traced(torch.Generator().manual_seed(5), wt, n, 32, wt)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- the miners ----------------------------------------------------------------


def _miners(setup, kind, qc):
    jqc, tqc = (setup.jqc, setup.tqc) if qc else (None, None)
    if kind == "bp":
        return (jdata.make_bp_failure_miner(setup.jg, num_iter=ITERS, wt_max=12, qc=jqc),
                tdata.make_bp_failure_miner(setup.tg, num_iter=ITERS, wt_max=12, qc=tqc))
    return (jdata.make_cascade_failure_miner(setup.jg, setup.jparams, num_iter1=ITERS, num_iter2=ITERS,
                                             wt_max=12, qc=jqc),
            tdata.make_cascade_failure_miner(setup.tg, setup.tparams, num_iter1=ITERS, num_iter2=ITERS,
                                             wt_max=12, qc=tqc))


@pytest.mark.parametrize("qc", [False, True], ids=["gather", "qc"])
@pytest.mark.parametrize("kind,wt", [("bp", 5), ("cascade", 3)])
def test_miner_flags_the_samples_jax_flags(setup, kind, wt, qc):
    jminer, tminer = _miners(setup, kind, qc)
    nx, nz, flagged = jminer(jax.random.PRNGKey(11), jnp.int32(wt), 128)
    onx, onz, oflagged = tminer.body(_t(nx), _t(nz))
    np.testing.assert_array_equal(onx.numpy(), np.asarray(nx))
    np.testing.assert_array_equal(onz.numpy(), np.asarray(nz))
    assert oflagged.dtype == torch.bool
    flagged = np.asarray(flagged)
    differ = np.nonzero(oflagged.numpy() != flagged)[0]
    if kind == "bp":
        assert differ.size == 0, differ
    elif differ.size:
        cols = _t(differ).to(torch.int64)
        again = _hard_flags_from_jax_first_run(setup, qc, _t(nx)[:, cols], _t(nz)[:, cols])
        np.testing.assert_array_equal(again, flagged[differ])
    assert 0 < int(oflagged.sum()) < 128  # some samples fail, some do not


def _hard_flags_from_jax_first_run(setup, qc, nx, nz):
    """The hard miner's flags with JAX's first BP run and the port's GNN
    and second run."""
    jqc, tqc = (setup.jqc, setup.tqc) if qc else (None, None)
    tnx, tnz, syn_x, syn_z, llr0 = tdata._prepare(setup.tg, 0.05, nx, nz)
    res = jdata._make_run_bp(setup.jg, jqc, True)(
        jnp.asarray(llr0.numpy()), jnp.asarray(syn_x.numpy()), jnp.asarray(syn_z.numpy()), ITERS,
        "boxplus-phi")
    h_vn = _t(jnp.stack([res.llrx, res.llry, res.llrz]))
    new_llr = feedback_gnn_apply(setup.tparams, setup.tg, h_vn, _t(res.z_logit), _t(res.x_logit),
                                 syn_x, syn_z)
    res2 = tdata._make_run_bp(setup.tg, tqc, True)(new_llr, syn_x, syn_z, ITERS, "boxplus-phi")
    return tdata._flagged_after(setup.tg, res2.x_hat, res2.z_hat, tnx, tnz).numpy()


@pytest.mark.parametrize("cap", [2, 128])
def test_compacted_miner_matches_jax(setup, cap):
    """The flagged samples packed to the front in their order, cut to cap
    (below and above the flagged count), as uint8 with the kept count."""
    key = jax.random.PRNGKey(5)
    nx, nz, flagged = jdata.make_bp_failure_miner(setup.jg, num_iter=ITERS)(key, 6, 128)
    ref = jdata.make_bp_failure_miner(setup.jg, num_iter=ITERS, compact_cap=cap)(key, 6, 128)
    out = tdata.make_bp_failure_miner(setup.tg, num_iter=ITERS, compact_cap=cap).body(_t(nx), _t(nz))
    assert out[0].dtype == torch.uint8 and out[0].shape == (setup.jg.n, min(cap, 128))
    assert int(out[2]) == int(ref[2]) == min(int(np.asarray(flagged).sum()), cap)
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_miner_call_samples_then_decodes(setup):
    """miner(generator, wt, batch) is body(sample(...)): fixed-weight noise
    of the generator's draw, the flagged samples really fail BP."""
    miner = tdata.make_bp_failure_miner(setup.tg, num_iter=ITERS)
    nx, nz, flagged = miner(torch.Generator().manual_seed(3), 6, 128)
    snx, snz = miner.sample(torch.Generator().manual_seed(3), 6, 128)
    assert torch.equal(nx, snx.to(torch.int32)) and torch.equal(nz, snz.to(torch.int32))
    assert ((nx | nz).sum(0) == 6).all()
    assert 0 < int(flagged.sum()) < 128
    assert miner.device == torch.device("cpu")


def test_mine_failures_replays_each_shard(setup):
    miner = tdata.make_bp_failure_miner(setup.tg, num_iter=ITERS)
    shards = tdata.mine_failures(miner, 4, weights=[4, 6], batches_per_weight=2, batch_size=64)
    assert sorted(shards) == [4, 6]
    for wt, (x, z) in shards.items():
        assert x.dtype == np.uint8 and x.shape == z.shape and x.shape[1] == setup.jg.n
        assert ((x | z).sum(axis=1) == wt).all()
        # each (wt, batch) shard replays alone from its own seed
        g = torch.Generator().manual_seed(tdata.shard_seed(4, wt, 1))
        nx, nz, fl = miner(g, wt, 64)
        tail = int(fl.sum())
        np.testing.assert_array_equal(x[x.shape[0] - tail:], nx.numpy().T[fl.numpy()])
        np.testing.assert_array_equal(z[z.shape[0] - tail:], nz.numpy().T[fl.numpy()])


# ---- the dataset pipeline ----------------------------------------------------


def _dataset(num=37, n=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (num, n), dtype=np.uint8), rng.integers(0, 2, (num, n), dtype=np.uint8))


def test_mix_easy_hard_matches_jax():
    easy, hard = _dataset(40), _dataset(3, seed=1)
    for o, r in zip(tdata.mix_easy_hard(easy, hard, 5), jdata.mix_easy_hard(easy, hard, 5)):
        np.testing.assert_array_equal(o, r)


def test_batch_iterator_matches_jax_on_its_permutation():
    x, z = _dataset()
    key = jax.random.PRNGKey(5)
    perm = np.asarray(jax.random.permutation(key, x.shape[0]))
    ref = list(jdata.batch_iterator(x, z, 4, key))
    out = list(tdata.batch_iterator(x, z, 4, perm=perm))
    assert len(out) == len(ref) == 37 // 4
    for (a, b), (c, d) in zip(out, ref):
        assert a.shape == (10, 4)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d))
    # a generator's epoch visits distinct samples, the remainder dropped
    seen = np.concatenate([a.numpy().T for a, _ in tdata.batch_iterator(
        np.arange(37)[:, None], np.arange(37)[:, None], 4, torch.Generator().manual_seed(1))])
    assert len(set(seen.ravel().tolist())) == 36


def test_batch_iterator_stacked_equivalence():
    """The stacks' concatenation is batch_iterator's sequence for the same
    generator seed (fused and unfused training see the same minibatches)."""
    x, z = _dataset()
    plain = list(tdata.batch_iterator(x, z, 4, torch.Generator().manual_seed(5)))
    stacked = list(tdata.batch_iterator_stacked(x, z, 4, torch.Generator().manual_seed(5), 3))
    assert [s[0].shape[0] for s in stacked] == [3, 3, 3]
    flat = [(nx[j], nz[j]) for nx, nz in stacked for j in range(nx.shape[0])]
    assert len(flat) == len(plain)
    for (a, b), (c, d) in zip(flat, plain):
        assert torch.equal(a, c) and torch.equal(b, d)
