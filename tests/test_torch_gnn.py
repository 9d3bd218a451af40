"""The port's feedback GNN against the JAX package's.

Tolerance rtol 1e-4, atol 1e-5 against JAX: the same float32 arithmetic,
summed in another order (tensordot and reductions reassociate).  Against
the TF golden the JAX suite's own 1e-4/1e-4 (tests/test_gnn_parity.py)."""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders.gnn_feedback import feedback_gnn_apply as j_apply
from feedback_gnn_tpu.decoders.gnn_feedback import init_feedback_gnn as j_init
from feedback_gnn_tpu.decoders.gnn_feedback import load_weights as j_load_weights

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.decoders.gnn_feedback import (
    feedback_gnn_apply,
    init_feedback_gnn,
    load_weights,
    params_from_numpy,
)
from feedback_gnn_tpu_torch.entry import WEIGHTS

TOL = dict(rtol=1e-4, atol=1e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "gnn_gb48_random.npz")


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_inputs(jcode, b, seed):
    rng = np.random.default_rng(seed)
    mx, mz = jcode.hx.shape[0], jcode.hz.shape[0]
    return (
        (rng.standard_normal((3, jcode.N, b)) * 3.0).astype(np.float32),
        (rng.standard_normal((mx, b)) * 2.0).astype(np.float32),
        (rng.standard_normal((mz, b)) * 2.0).astype(np.float32),
        rng.integers(0, 2, (mx, b)).astype(np.float32),
        rng.integers(0, 2, (mz, b)).astype(np.float32),
    )


def _compare(jcode, tcode, jparams, tparams, b=8, seed=0):
    jg = JQuantumGraph.from_code(jcode, stage_mode=True)
    tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
    args = _random_inputs(jcode, b, seed)
    ref = np.asarray(j_apply(jparams, jg, *(jnp.asarray(a) for a in args)))
    out = feedback_gnn_apply(tparams, tg, *(torch.as_tensor(a) for a in args)).numpy()
    assert out.shape == ref.shape == (3, jg.n_pad, b)
    n = jg.n
    np.testing.assert_allclose(out[:, :n], ref[:, :n], **TOL)


def test_shipped_882_weights_match_jax(ghp882):
    path = WEIGHTS["n882"]
    jparams = j_load_weights(path)
    tparams = params_from_numpy(_to_numpy(jparams))
    loaded = load_weights(path)
    for a, b in zip(jax.tree_util.tree_leaves(_to_numpy(jparams)),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), loaded))):
        np.testing.assert_array_equal(a, b)
    _compare(ghp882, tc.ghp_882_24(), jparams, tparams, b=8)


def test_general_path_three_layers_matches_jax():
    args = (24, [0, 2, 8, 15], [0, 2, 12, 17])
    jparams = j_init(jax.random.PRNGKey(3), num_mlp_layers=3)
    assert len(jparams["msg_mlp_x"]) == 3
    _compare(jc.create_generalized_bicycle_codes(*args), tc.create_generalized_bicycle_codes(*args),
             jparams, params_from_numpy(_to_numpy(jparams)))


def test_init_feedback_gnn_shapes():
    p = init_feedback_gnn(torch.Generator().manual_seed(0))
    jp = j_init(jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    jshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), jp)
    assert shapes == jshapes
    assert float(p["llr_inv_embed"]["kernel"].abs().sum()) == 0.0
    lim = (6.0 / (4 + 40)) ** 0.5
    assert float(p["msg_mlp_x"][0]["kernel"].abs().max()) <= lim


def test_matches_tf_golden():
    d = np.load(GOLDEN)
    code = tc.CSSCode(d["hx"].astype(int), d["hz"].astype(int))
    graph = tc.QuantumGraph.from_code(code).to("cpu")
    w = [d[f"w{i}"] for i in range(12)]
    params = params_from_numpy({
        "llr_inv_embed": {"kernel": w[0], "bias": w[1]},
        "msg_mlp_x": [{"kernel": w[2], "bias": w[3]}, {"kernel": w[4], "bias": w[5]}],
        "msg_mlp_z": [{"kernel": w[6], "bias": w[7]}, {"kernel": w[8], "bias": w[9]}],
        "embed_mlp": [{"kernel": w[10], "bias": w[11]}],
    })
    h_vn = torch.as_tensor(d["h_vn"]).permute(2, 1, 0)  # [bs, n, 3] -> [3, n, B]
    out = feedback_gnn_apply(params, graph, h_vn, *(torch.as_tensor(d[k]) for k in
                                                    ("logit_hx", "logit_hz", "syndrome_x", "syndrome_z")))
    ref = d["out"].transpose(2, 1, 0)
    np.testing.assert_allclose(out.numpy()[:, :graph.n], ref, rtol=1e-4, atol=1e-4)
