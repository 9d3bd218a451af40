"""The port's GNN_BP4 (decoders/gnn_full.py, models.gnn_bp4_eval_step)
against the JAX package's, on GB-48, with the JAX parameters carried over.

Tolerances: the per-iteration stacks at rtol 1e-4, atol 5e-4 (the check
logits pass through phi, which is clipped at 16.64 and steep near its
lower clip; the largest difference seen is 8.3e-5, in sum mode), the hard
decisions and the counts exactly; the loss at rtol 1e-5 and each gradient
leaf at a relative L2 error of at most 1e-3.

The sum reduction lets the embeddings grow from iteration to iteration,
and from the third iteration on its logits sit at phi's clips: there JAX's
own gradient moves by 1-5 % (and its loss by 1e-4) when its parameters
are scaled by 1 + 1e-6 noise.  Its gradient case runs 2 iterations, where
that movement is 6e-5; the other reductions run 4.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.channels.pauli import depolarizing_probs as j_probs
from feedback_gnn_tpu.channels.pauli import pauli_fixed_weight as j_fixed
from feedback_gnn_tpu.channels.pauli import pauli_iid as j_iid
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders import gnn_full as jg
from feedback_gnn_tpu.io.checkpoint import load_pytree as j_load_pytree
from feedback_gnn_tpu.models import gnn_bp4_eval_step as j_eval_step

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.decoders import gnn_full as tg
from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
from feedback_gnn_tpu_torch.models import gnn_bp4_count
from feedback_gnn_tpu_torch.ops import mod2_matmul as tc_mod2

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
SMALL = dict(num_embed_dims=8, num_msg_dims=8, num_hidden_units=16, num_iter=4)
ATTRS = dict(use_attributes=True, node_attribute_dims=3, msg_attribute_dims=2)
STACK_TOL = dict(rtol=1e-4, atol=5e-4)
GRAD_REL = 1e-3
B = 64  # one batch everywhere: JAX compiles each op once per shape


@pytest.fixture(scope="module")
def gb48():
    """(JAX graph, JAX row sets, port graph on the CPU, port row sets)."""
    jgraph = JQuantumGraph.from_code(jc.create_generalized_bicycle_codes(*GB48), stage_mode=True)
    host = tc.QuantumGraph.from_code(tc.create_generalized_bicycle_codes(*GB48), stage_mode=True)
    return jgraph, jg.make_logit_rowsets(jgraph), host.to("cpu"), tg.make_logit_rowsets(host, "cpu")


def _key_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _jax_flat(tree):
    return {_key_path(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(cfg):
    return jg.GNNBP4Config(**cfg), tg.GNNBP4Config(**cfg)


def _params(gb48, cfg, attributes):
    """JAX parameters (nonzero random attributes when on) and the port's copy."""
    jgraph, _, graph, _ = gb48
    jcfg, tcfg = _configs(cfg)
    jp = jg.init_gnn_bp4(jax.random.PRNGKey(1), jcfg, jgraph)
    if attributes:
        rng = np.random.default_rng(3)
        jp["attributes"] = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                            for k, v in jp["attributes"].items()}
    tp = tg.init_gnn_bp4(torch.Generator().manual_seed(0), tcfg, graph)
    flat, ref = flatten_with_paths(tp), _jax_flat(jp)
    assert sorted(flat) == sorted(ref)
    for k, leaf in flat.items():
        leaf.copy_(torch.from_numpy(ref[k].copy()))
    return jp, tp


def _syndromes(gb48, batch, seed):
    jgraph = gb48[0]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (jgraph.gx.num_cn, batch)).astype(np.int32),
            rng.integers(0, 2, (jgraph.gz.num_cn, batch)).astype(np.int32))


def _apply_both(gb48, jp, tp, cfg, sx, sz):
    jgraph, jrs, graph, trs = gb48
    jcfg, tcfg = _configs(cfg)
    jout = jg.gnn_bp4_apply(jp, jgraph, jrs, jnp.asarray(sx), jnp.asarray(sz), jcfg, collect_logits=True)
    tout = tg.gnn_bp4_apply(tp, graph, trs, torch.from_numpy(sx), torch.from_numpy(sz), tcfg,
                            collect_logits=True)
    return jout, tout


@pytest.mark.parametrize("loss_type", ["boxplus-phi", "sine"])
@pytest.mark.parametrize("attributes", [False, True])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_apply_matches_jax(gb48, reduce_op, attributes, loss_type):
    cfg = dict(SMALL, reduce_op=reduce_op, loss_type=loss_type, **(ATTRS if attributes else {}))
    jp, tp = _params(gb48, cfg, attributes)
    sx, sz = _syndromes(gb48, B, seed=0)
    (jx, jz, jstack), (tx, tz, tstack) = _apply_both(gb48, jp, tp, cfg, sx, sz)
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())
    assert len(jstack) == len(tstack) == cfg["num_iter"]
    for i, (jpair, tpair) in enumerate(zip(jstack, tstack)):
        for a, b in zip(jpair, tpair):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **STACK_TOL, err_msg=f"iteration {i}")


@pytest.mark.parametrize("attributes", [False, True])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_loss_and_gradients_match_jax(gb48, reduce_op, attributes):
    jgraph, jrs, graph, trs = gb48
    cfg = dict(SMALL, reduce_op=reduce_op, **(ATTRS if attributes else {}))
    if reduce_op == "sum":
        cfg["num_iter"] = 2  # see the module docstring
    jcfg, tcfg = _configs(cfg)
    jp, tp = _params(gb48, cfg, attributes)
    u = np.random.default_rng(0).random((jgraph.n, B))
    nx = (u < 0.04).astype(np.float32)
    nz = ((u >= 0.02) & (u < 0.06)).astype(np.float32)
    jloss, jgrad = jax.value_and_grad(jg.gnn_bp4_loss)(jp, jgraph, jrs, jcfg, jnp.asarray(nx), jnp.asarray(nz))
    leaves = flatten_with_paths(tp)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tloss = tg.gnn_bp4_loss(tp, graph, trs, tcfg, torch.from_numpy(nx), torch.from_numpy(nz))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    ref = _jax_flat(jgrad)
    for k, leaf in leaves.items():
        err = np.linalg.norm(leaf.grad.numpy() - ref[k]) / np.linalg.norm(ref[k])
        assert err <= GRAD_REL, (k, err)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("attributes", [False, True])
def test_init_tree_matches_jax(gb48, use_bias, attributes):
    jgraph, _, graph, _ = gb48
    jcfg, tcfg = _configs(dict(use_bias=use_bias, **(ATTRS if attributes else {})))
    ref = _jax_flat(jg.init_gnn_bp4(jax.random.PRNGKey(0), jcfg, jgraph))
    out = flatten_with_paths(tg.init_gnn_bp4(torch.Generator().manual_seed(0), tcfg, graph))
    assert list(out) == list(ref)  # keys in JAX's leaf order
    for k, leaf in out.items():
        assert tuple(leaf.shape) == ref[k].shape and leaf.dtype == torch.float32, k
        if "attributes" in k or k.endswith("bias"):
            np.testing.assert_array_equal(leaf.numpy(), ref[k], err_msg=k)  # zeros, ones
        else:  # glorot-uniform within the same limit
            limit = (6.0 / sum(ref[k].shape)) ** 0.5
            assert float(leaf.abs().max()) <= limit and float(leaf.std()) > 0.3 * limit, k


def test_shipped_gb48_weights_decide_as_jax(gb48):
    """The trained GB-48 weights at full width (20/20/40, 8 iterations)."""
    jgraph, jrs, graph, trs = gb48
    tp, tcfg = tg.load_shipped("gb48", "cpu")
    jcfg = jg.GNNBP4Config(**tcfg._asdict())
    jp = j_load_pytree(os.path.join(REPO, "runs", "gnn_bp4_gb48_weights.npz"),
                       jg.init_gnn_bp4(jax.random.PRNGKey(0), jcfg, jgraph))
    sx, sz = _syndromes(gb48, B, seed=1)
    jx, jz, _ = jg.gnn_bp4_apply(jp, jgraph, jrs, jnp.asarray(sx), jnp.asarray(sz), jcfg)
    tx, tz, _ = tg.gnn_bp4_apply(tp, graph, trs, torch.from_numpy(sx), torch.from_numpy(sz), tcfg)
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())


@pytest.mark.parametrize("wt", [None, 5])
def test_eval_step_counts_match_jax(gb48, wt):
    """JAX's eval step on a key, the port's counting on the noise that key
    draws there (the same sampler call the JAX step makes)."""
    jgraph, jrs, graph, trs = gb48
    cfg = dict(SMALL, reduce_op="mean")
    jcfg, tcfg = _configs(cfg)
    jp, tp = _params(gb48, cfg, False)
    key, p, batch = jax.random.PRNGKey(7), 0.05, B
    if wt is None:
        nx, nz = j_iid(key, *j_probs(p), jgraph.n, batch)
    else:
        nx, nz = j_fixed(key, wt, jgraph.n, batch)
    ref = j_eval_step(jgraph, jrs, jp, jcfg, key, p, batch, wt=wt)
    out = gnn_bp4_count(graph, trs, tp, tcfg, torch.tensor(np.asarray(nx)), torch.tensor(np.asarray(nz)))
    assert tuple(int(v) for v in out) == tuple(int(v) for v in ref)
    assert int(ref[0]) > 0  # the comparison counts something


@pytest.mark.parametrize("name", ["n882", "gb48"])
def test_shipped_weights_are_the_runs_files(name):
    with open(os.path.join(tg.SHIPPED_DIR, f"gnn_bp4_{name}.npz"), "rb") as f, \
            open(os.path.join(REPO, "runs", f"gnn_bp4_{name}_weights.npz"), "rb") as g:
        assert f.read() == g.read()
    with open(os.path.join(tg.SHIPPED_DIR, f"gnn_bp4_{name}.json")) as f, \
            open(os.path.join(REPO, "runs", f"gnn_bp4_{name}.json")) as g:
        assert json.load(f) == json.load(g)["cfg"]
    params, cfg = tg.load_shipped(name, "cpu")
    assert cfg == tg.GNNBP4Config(num_embed_dims=20, num_msg_dims=20, num_hidden_units=40, num_iter=8)
    assert "bias" not in params["vn_embed_mlp"][0] and "bias" in params["llr_inv_embed"]


def test_load_rejects_other_configuration(tmp_path):
    path = os.path.join(tg.SHIPPED_DIR, "gnn_bp4_gb48.npz")
    with pytest.raises(ValueError, match="does not hold GNN_BP4 parameters"):
        tg.load_gnn_bp4_weights(path, tg.GNNBP4Config(use_bias=True), "cpu")
    with pytest.raises(ValueError, match="does not hold GNN_BP4 parameters"):
        tg.load_gnn_bp4_weights(path, tg.GNNBP4Config(num_hidden_units=32), "cpu")


def test_axis_name_and_sine_loss_raise(gb48):
    """The sine loss has no perp-row logits for the BCE.  (The edge axis
    runs: tests/test_torch_parallel.py holds it against the unsharded
    decoder.)"""
    _, _, graph, trs = gb48
    cfg = tg.GNNBP4Config(**SMALL)
    params = tg.init_gnn_bp4(torch.Generator().manual_seed(0), cfg, graph)
    noise = torch.zeros((graph.n, 4))
    with pytest.raises(ValueError, match="boxplus-phi"):
        tg.gnn_bp4_loss(params, graph, trs, cfg._replace(loss_type="sine"), noise, noise)


@pytest.mark.slow
def test_shipped_n882_weights_decide_as_jax():
    """The trained [[882,24]] weights at full width on B=64 syndromes of
    i.i.d. noise: the hard decisions equal JAX's.  The logits are not
    compared: from the second iteration on most check logits are large,
    where phi's float32 staircase turns ulps into larger differences."""
    jgraph = JQuantumGraph.from_code(jc.ghp_882_24(), stage_mode=True)
    host = tc.QuantumGraph.from_code(tc.ghp_882_24(), stage_mode=True)
    graph, trs = host.to("cpu"), tg.make_logit_rowsets(host, "cpu")
    tp, tcfg = tg.load_shipped("n882", "cpu")
    jcfg = jg.GNNBP4Config(**tcfg._asdict())
    jp = j_load_pytree(os.path.join(REPO, "runs", "gnn_bp4_n882_weights.npz"),
                       jg.init_gnn_bp4(jax.random.PRNGKey(0), jcfg, jgraph))
    u = np.random.default_rng(0).random((graph.n, B))
    nx = np.pad((u < 0.02).astype(np.int32), ((0, graph.n_pad - graph.n), (0, 0)))
    nz = np.pad(((u >= 0.01) & (u < 0.03)).astype(np.int32), ((0, graph.n_pad - graph.n), (0, 0)))
    sx = tc_mod2(graph.hx, torch.from_numpy(nz)).numpy()
    sz = tc_mod2(graph.hz, torch.from_numpy(nx)).numpy()
    jx, jz, _ = jg.gnn_bp4_apply(jp, jgraph, jg.make_logit_rowsets(jgraph), jnp.asarray(sx), jnp.asarray(sz), jcfg)
    tx, tz, _ = tg.gnn_bp4_apply(tp, graph, trs, torch.from_numpy(sx), torch.from_numpy(sz), tcfg)
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())
    assert int(sx.sum()) > 0


@pytest.mark.slow
@pytest.mark.parametrize("p,logical", [(0.03, 836), (0.05, 3578)])
def test_shipped_gb48_counts_on_jax_noise(gb48, p, logical):
    """runs/gnn_bp4_gb48.json's trained counts: scripts/train_gnn_bp4.py
    evaluated each p over 20 batches of 2048 from the keys
    fold_in(fold_in(PRNGKey(0), 5000 + b), int(p * 1e4)).  The JAX package
    repeats the count from those keys on the CPU, and the port, given the
    noise each key draws, counts the same."""
    jgraph, jrs, graph, trs = gb48
    tp, tcfg = tg.load_shipped("gb48", "cpu")
    jcfg = jg.GNNBP4Config(**tcfg._asdict())
    jp = j_load_pytree(os.path.join(REPO, "runs", "gnn_bp4_gb48_weights.npz"),
                       jg.init_gnn_bp4(jax.random.PRNGKey(0), jcfg, jgraph))
    step = jax.jit(lambda k: j_eval_step(jgraph, jrs, jp, jcfg, k, jnp.float32(p), 2048))
    sample = jax.jit(lambda k: j_iid(k, *j_probs(jnp.float32(p)), jgraph.n, 2048))
    ref = out = 0
    for b in range(20):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 5000 + b), int(p * 1e4))
        ref += int(step(k)[1])
        nx, nz = sample(k)
        out += int(gnn_bp4_count(graph, trs, tp, tcfg, torch.tensor(np.asarray(nx)), torch.tensor(np.asarray(nz)))[1])
    assert ref == logical and out == logical
