"""Feedback GNN: one learned message-passing step between BP runs.

The port of ``feedback_gnn_tpu/decoders/gnn_feedback.py``: maps the previous
BP run's marginals, check logits and syndromes to a fresh per-qubit LLR
initialisation for the next BP run.

  h_cn   = check_logit * (1 - 2*syndrome)                  per CN
  feat_e = concat(h_cn[cn(e)], h_vn[:, vn(e)])             per edge  [4]
  msg_e  = MLP_x/z(feat_e)                                 per edge  [msg_dims]
  m_v    = mean_e->v msg_e                                 per VN    [msg_dims]
  h_vn'  = Dense3(MLP_embed(concat(m_x, m_z, h_vn)))       per VN    [3]

Parameters are a plain dict of tensors in the JAX package's layout:
``{"llr_inv_embed": {"kernel", "bias"}, "msg_mlp_x": [layer, ...],
"msg_mlp_z": [...], "embed_mlp": [...]}`` with Keras ``[in, out]`` kernels.
Layout is batch-last: h_vn is [3, n, B], logits are [num_cn, B].
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.dense import dense_bl

__all__ = ["init_feedback_gnn", "feedback_gnn_apply", "load_weights", "params_from_numpy"]


def params_from_numpy(tree, device=None):
    """The port's parameters from a parameter tree of arrays (nested dicts
    and lists, e.g. the JAX package's pytree converted with ``np.asarray``):
    the same structure with float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def _init_dense(generator, fan_in, fan_out, zeros=False):
    """Keras Dense defaults: glorot-uniform kernel, ones bias."""
    dev = generator.device
    if zeros:
        kernel = torch.zeros((fan_in, fan_out), device=dev)
    else:
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        u = torch.rand((fan_in, fan_out), generator=generator, device=dev)
        kernel = u * (2.0 * limit) - limit
    return {"kernel": kernel, "bias": torch.ones((fan_out,), device=dev)}


def init_feedback_gnn(generator: torch.Generator, num_msg_dims: int = 20,
                      num_hidden_units: int = 40, num_mlp_layers: int = 2):
    """Fresh parameters of the reference architecture on the generator's
    device (llr_inv_embed has a zero kernel and ones bias)."""
    hidden = [num_hidden_units] * (num_mlp_layers - 1)

    def mlp(fan_in, units):
        layers, prev = [], fan_in
        for u in units:
            layers.append(_init_dense(generator, prev, u))
            prev = u
        return layers

    return {
        "llr_inv_embed": _init_dense(generator, num_hidden_units, 3, zeros=True),
        # edge MLPs, input = 1 (cn logit) + 3 (h_vn)
        "msg_mlp_x": mlp(4, hidden + [num_msg_dims]),
        "msg_mlp_z": mlp(4, hidden + [num_msg_dims]),
        # embed MLP, input = 2*msg_dims + 3
        "embed_mlp": mlp(2 * num_msg_dims + 3, hidden),
    }


def load_weights(path: str, device=None):
    """Feedback-GNN parameters from an ``.npz`` checkpoint in the JAX
    package's format (``feedback_gnn_tpu/weights/*.npz``)."""
    with np.load(path, allow_pickle=False) as data:
        def g(k):
            return data[k]

        tree = {
            "llr_inv_embed": {"kernel": g("llr_inv_embed/kernel"), "bias": g("llr_inv_embed/bias")},
            "msg_mlp_x": [{"kernel": g(f"msg_mlp_x/{i}/kernel"), "bias": g(f"msg_mlp_x/{i}/bias")}
                          for i in range(2)],
            "msg_mlp_z": [{"kernel": g(f"msg_mlp_z/{i}/kernel"), "bias": g(f"msg_mlp_z/{i}/bias")}
                          for i in range(2)],
            "embed_mlp": [{"kernel": g("embed_mlp/0/kernel"), "bias": g("embed_mlp/0/bias")}],
        }
    return params_from_numpy(tree, device)


def _mlp_tanh(x, layers):
    """Hidden layers tanh, last layer linear."""
    for i, layer in enumerate(layers):
        act = torch.tanh if i < len(layers) - 1 else None
        x = dense_bl(x, layer["kernel"], layer.get("bias"), act)
    return x


def _mlp_all_tanh(x, layers):
    """The embed MLP keeps the activation on every layer."""
    for layer in layers:
        x = dense_bl(x, layer["kernel"], layer.get("bias"), torch.tanh)
    return x


def _vn_mean(messages, graph: TannerGraph):
    """Masked mean of per-edge (slot-major) messages at each VN:
    [F, dv, n_pad, B] -> [F, n_pad, B]."""
    s = (messages * graph.vn_mask[None, :, :, None]).sum(dim=1)
    return s / graph.vn_deg.clamp_min(1.0)[None, :, None]


def _edge_messages(mlp, h_vn, h_cn_e, g: TannerGraph):
    """Per-VN mean of the edge MLP over the VN's edges.

    Fast path (the reference's 2-layer MLP: tanh hidden, linear out): layer
    0 splits into a per-VN matmul plus a rank-1 per-edge term, and the
    linear layer 1 commutes with the masked mean, so no per-edge matmul and
    no [msg_dims, dv, n, B] intermediate is formed.  Pad VNs get m = b1
    here (the general path gives 0); pad rows of the output are garbage
    either way."""
    if len(mlp) == 2:
        w0, b0 = mlp[0]["kernel"], mlp[0].get("bias")
        u = torch.tensordot(w0[1:], h_vn, dims=([0], [0]))  # [H, n_pad, B]
        if b0 is not None:
            u = u + b0[:, None, None]
        w_cn = w0[0][:, None, None]  # [H, 1, 1]
        acc = None
        for d in range(g.max_vn_deg):
            t = torch.tanh(u + w_cn * h_cn_e[d][None]) * g.vn_mask[d][None, :, None]
            acc = t if acc is None else acc + t
        t = acc / g.vn_deg.clamp_min(1.0)[None, :, None]
        return dense_bl(t, mlp[1]["kernel"], mlp[1].get("bias"))
    # general path: materialise per-edge features
    dv = g.max_vn_deg
    feat = torch.cat([h_cn_e[None], h_vn[:, None].expand((3, dv) + h_vn.shape[1:])], dim=0)
    return _vn_mean(_mlp_tanh(feat, mlp), g)


def feedback_gnn_apply(params, graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z):
    """One feedback-GNN step.

    Args:
      h_vn: [3, n, B] or [3, n_pad, B] stacked (llrx, llry, llrz) marginals.
      logit_hx / logit_hz: [mx, B] / [mz, B] per-check logits (padded rows
        accepted).
      syndrome_x / syndrome_z: [mx, B] / [mz, B] in {0,1}.

    Returns the new LLR init [3, n_pad, B] in (x, y, z) order; its pad rows
    are generally nonzero (MLP biases).
    """
    gx, gz = graph.gx, graph.gz

    def padc(x, rows):
        return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))

    syn_x_pm = 1.0 - 2.0 * padc(syndrome_x.to(torch.float32), gx.c_pad)
    syn_z_pm = 1.0 - 2.0 * padc(syndrome_z.to(torch.float32), gz.c_pad)
    h_cn_x = padc(logit_hx, gx.c_pad) * syn_x_pm  # [c_pad_x, B]
    h_cn_z = padc(logit_hz, gz.c_pad) * syn_z_pm
    h_vn = torch.nn.functional.pad(h_vn, (0, 0, 0, gx.n_pad - h_vn.shape[1]))

    # per-vn-slot CN features [dv, n_pad, B]; the pad sentinel (num_cn)
    # indexes a zero pad row of h_cn
    m_x = _edge_messages(params["msg_mlp_x"], h_vn, h_cn_x[gx.edge_cn_byslot], gx)
    m_z = _edge_messages(params["msg_mlp_z"], h_vn, h_cn_z[gz.edge_cn_byslot], gz)

    embed_in = torch.cat([m_x, m_z, h_vn], dim=0)  # [2*msg+3, n_pad, B]
    h = _mlp_all_tanh(embed_in, params["embed_mlp"])
    emb = params["llr_inv_embed"]
    return dense_bl(h, emb["kernel"], emb.get("bias"))  # [3, n_pad, B]
