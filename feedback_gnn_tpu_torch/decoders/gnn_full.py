"""Fully-learned GNN Tanner-graph decoder (GNN_BP4), the port of
``feedback_gnn_tpu/decoders/gnn_full.py``.

A message-passing network over the two Tanner graphs that takes only the
syndromes and keeps learned CN/VN embeddings; no BP.  Per iteration:

  h_vn   <- update_vn(h_cn_x, h_cn_z, h_vn): per-slot message MLPs,
            syndrome-signed messages, reduced at each VN, then the VN
            embedding MLP;
  logits <- llr_inv_embed(h_vn) -> binary LLRs -> boxplus over the rows
            of [hz; lz] and [hx; lx];
  h_cn   <- update_cn(h_vn, h_cn, check logit x syndrome sign).

Layout: batch-last; embeddings are [d_e, nodes, B] with the feature axis
leading (dense layers contract the leading axis, ops/dense.py).  The graph
is a ``QuantumGraph`` of tensors, the row sets those of
``make_logit_rowsets``.  Plain PyTorch, as the JAX package's decoder is
plain XLA.  The JAX package's ``axis_name`` (a reduction across an
edge-sharded mesh) belongs to multi-device runs and raises here.

``load_gnn_bp4_weights`` reads a parameter file that the JAX package's
``save_pytree`` wrote; ``load_shipped`` the trained weights of
``weights/gnn_bp4_*.npz`` with their configuration.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..codes.graph import build_rowset
from ..io.checkpoint import flatten_with_paths, load_pytree
from ..ops.dense import dense_bl, init_dense, init_mlp
from .bp4 import hard_decision, quaternary_to_binary_llrs
from .cn_update import boxplus_rows

__all__ = [
    "GNNBP4Config", "init_gnn_bp4", "gnn_bp4_apply", "gnn_bp4_loss", "make_logit_rowsets",
    "load_gnn_bp4_weights", "load_shipped", "SHIPPED_DIR",
]

# trained weights shipped with the port, each with its configuration
SHIPPED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights")


class GNNBP4Config(NamedTuple):
    num_embed_dims: int = 20
    num_msg_dims: int = 20
    num_hidden_units: int = 40
    num_mlp_layers: int = 2
    num_iter: int = 8
    activation: str = "relu"
    use_bias: bool = False
    reduce_op: str = "mean"  # sum | mean | max | min
    # trainable zero-init node/edge attributes: edge attributes are
    # concatenated onto the per-edge features before the message MLP, node
    # attributes onto the reduced messages before the embedding MLP
    use_attributes: bool = False
    node_attribute_dims: int = 0
    msg_attribute_dims: int = 0
    # what the per-iteration stack holds: "boxplus-phi" -> (x_perp_logit,
    # z_perp_logit) check/logical logits; "sine" -> (p_x, p_z) per-qubit
    # error probabilities (``_cal_prob``)
    loss_type: str = "boxplus-phi"


def _act(name):
    return {"relu": torch.relu, "tanh": torch.tanh}[name]


def _mlp(x, layers, act):
    for i, layer in enumerate(layers):
        x = dense_bl(x, layer["kernel"], layer.get("bias"), act if i < len(layers) - 1 else None)
    return x


def init_gnn_bp4(generator: torch.Generator, cfg: GNNBP4Config, graph=None):
    """Glorot-uniform kernels drawn from ``generator`` on its device, in the
    JAX package's tree layout; ``graph`` (a ``QuantumGraph``) gives the
    attributes' shapes when ``cfg.use_attributes``."""
    h, m, e = cfg.num_hidden_units, cfg.num_msg_dims, cfg.num_embed_dims
    hidden = [h] * (cfg.num_mlp_layers - 1)
    na = cfg.node_attribute_dims if cfg.use_attributes else 0
    ma = cfg.msg_attribute_dims if cfg.use_attributes else 0
    feat = 2 * e + ma  # concat(from, to[, edge attr]) per edge

    def mlp(fan_in, out):
        return init_mlp(generator, fan_in, hidden + [out], use_bias=cfg.use_bias)

    params = {
        # CN update: the X and Z sides have their own message and embedding MLPs
        "cn_msg_mlp_x": mlp(feat, m),
        "cn_msg_mlp_z": mlp(feat, m),
        "cn_embed_mlp_x": mlp(m + na + e + 1, e),
        "cn_embed_mlp_z": mlp(m + na + e + 1, e),
        # VN update
        "vn_msg_mlp_x": mlp(feat, m),
        "vn_msg_mlp_z": mlp(feat, m),
        # one node attribute, concatenated onto m_z only
        "vn_embed_mlp": mlp(2 * m + na + e, e),
        # embedding -> (llrx, llry, llrz)
        "llr_inv_embed": init_dense(generator, e, 3, use_bias=True),
    }
    if cfg.use_attributes:
        if graph is None:
            raise ValueError("use_attributes needs the graph (the attributes' shapes)")
        gx, gz = graph.gx, graph.gz

        def z(*shape):
            return torch.zeros(shape, device=generator.device)

        params["attributes"] = {
            # CN update: edge attributes in the CN-slot layout, node attributes per side
            "cn_msg_x": z(ma, gx.max_cn_deg, gx.c_pad),
            "cn_msg_z": z(ma, gz.max_cn_deg, gz.c_pad),
            "cn_node_x": z(na, gx.c_pad),
            "cn_node_z": z(na, gz.c_pad),
            # VN update: edge attributes in the VN-slot layout, one shared VN node attribute
            "vn_msg_x": z(ma, gx.max_vn_deg, gx.n_pad),
            "vn_msg_z": z(ma, gz.max_vn_deg, gz.n_pad),
            "vn_node": z(na, gx.n_pad),
        }
    return params


def _vn_slot_features(h_cn, h_vn, graph):
    """Per-VN-slot features: concat(h_cn[cn(slot)], h_vn) -> [2e, dv, n_pad, B]."""
    h_cn_e = h_cn[:, graph.edge_cn_byslot]  # [e, dv, n_pad, B]
    return torch.cat([h_cn_e, h_vn[:, None].expand_as(h_cn_e)], dim=0)


def _cn_slot_features(h_vn, h_cn, graph):
    """Per-CN-slot features: concat(h_vn[vn(slot)], h_cn) -> [2e, dc, c_pad, B]."""
    h_vn_e = h_vn[:, graph.edge_vn_byslot]  # [e, dc, c_pad, B]
    return torch.cat([h_vn_e, h_cn[:, None].expand_as(h_vn_e)], dim=0)


def _reduce_slots(messages, mask, deg, reduce_op: str):
    """Aggregate per-slot messages [m, d, N_pad, B] at the nodes -> [m, N_pad, B].

    max/min split the gradient evenly among tied slots (``amax``/``amin``,
    as JAX's reductions do) and give 0 at degree-0 nodes; mean divides by
    max(deg, 1)."""
    if reduce_op in ("max", "min"):
        big = 3.4e38
        valid = (mask > 0)[None, :, :, None]
        if reduce_op == "max":
            red = torch.where(valid, messages, -big).amax(dim=1)
        else:
            red = torch.where(valid, messages, big).amin(dim=1)
        # degree-0 (padding) nodes: no incoming messages -> 0
        return torch.where((deg > 0)[None, :, None], red, 0.0)
    s = (messages * mask[None, :, :, None]).sum(dim=1)
    if reduce_op == "sum":
        return s
    if reduce_op == "mean":
        return s / deg.clamp(min=1.0)[None, :, None]
    raise ValueError(reduce_op)


def _inv_embed(params, h_vn):
    layer = params["llr_inv_embed"]
    return dense_bl(h_vn, layer["kernel"], layer.get("bias"))  # [3, n_pad, B]


def _cal_logit(params, lrowsets, h_vn):
    """llr_inv_embed -> binary LLRs -> boxplus over the [hz; lz] / [hx; lx]
    rows.  Returns (hx_logit, hz_logit, x_perp_logit, z_perp_logit,
    (llrx, llry, llrz))."""
    emb = _inv_embed(params, h_vn)
    llrx, llry, llrz = emb[0], emb[1], emb[2]
    llr_x, llr_z = quaternary_to_binary_llrs(llrx, llry, llrz)
    rows_hx, rows_hz, rows_lx, rows_lz = lrowsets
    hz_logit = boxplus_rows(llr_x, rows_hz)  # X-error checks
    lz_logit = boxplus_rows(llr_x, rows_lz)
    hx_logit = boxplus_rows(llr_z, rows_hx)  # Z-error checks
    lx_logit = boxplus_rows(llr_z, rows_lx)
    x_perp_logit = torch.cat([hz_logit, lz_logit], dim=0)
    z_perp_logit = torch.cat([hx_logit, lx_logit], dim=0)
    return hx_logit, hz_logit, x_perp_logit, z_perp_logit, (llrx, llry, llrz)


def _cal_prob(params, h_vn):
    """Per-qubit error probabilities p'_X, p'_Z from the embeddings (the
    "sine" observable): sigmoid of the negated binary LLRs."""
    emb = _inv_embed(params, h_vn)
    llr_x, llr_z = quaternary_to_binary_llrs(emb[0], emb[1], emb[2])
    return torch.sigmoid(-llr_x), torch.sigmoid(-llr_z)


def make_logit_rowsets(graph, device=None):
    """RowSets for ``_cal_logit``: the hx, hz, lx, lz rows, as tensors on
    ``device``.  ``graph`` is a host ``QuantumGraph``; its padded matrices
    are sliced to the true rows and the pad entries point at the zero pad
    row ``graph.n``."""
    mats = ((graph.hx, graph.gx.num_cn), (graph.hz, graph.gz.num_cn), (graph.lx, graph.lx_rows),
            (graph.lz, graph.lz_rows))
    sets = tuple(build_rowset(np.asarray(m)[:rows], vn_sentinel=graph.n) for m, rows in mats)
    return sets if device is None else tuple(r.to(device) for r in sets)


def gnn_bp4_apply(params, graph, lrowsets, syndrome_x, syndrome_z, cfg: GNNBP4Config,
                  collect_logits: bool = False, axis_name=None):
    """Decode from the syndromes alone.

    syndrome_x / syndrome_z: [mx or c_pad, B] / [mz or c_pad, B] in {0, 1}.
    Returns (x_hat, z_hat, stack): int32 [n_pad, B] decisions, and with
    ``collect_logits`` the per-iteration (x_perp, z_perp) logits (or
    (p_x, p_z) with ``loss_type="sine"``), else None.
    """
    if axis_name is not None:
        raise NotImplementedError("edge-sharded GNN_BP4 (axis_name) is not ported yet: ROADMAP A7")
    act = _act(cfg.activation)
    gx, gz = graph.gx, graph.gz
    b = syndrome_x.shape[-1]
    e = cfg.num_embed_dims
    dev = syndrome_x.device

    def padc(x, rows):
        return torch.nn.functional.pad(x.to(torch.float32), (0, 0, 0, rows - x.shape[0]))

    syn_x_pm = 1.0 - 2.0 * padc(syndrome_x, gx.c_pad)  # pad rows +1
    syn_z_pm = 1.0 - 2.0 * padc(syndrome_z, gz.c_pad)

    h_vn = torch.ones((e, gx.n_pad, b), device=dev)
    h_cn_x = torch.zeros((e, gx.c_pad, b), device=dev)
    h_cn_z = torch.zeros((e, gz.c_pad, b), device=dev)

    attrs = params.get("attributes") if cfg.use_attributes else None

    def cat_attr(feat, name):
        # attributes are shared across the batch
        if attrs is None:
            return feat
        a = attrs[name]
        return torch.cat([feat, a[..., None].expand(a.shape + (feat.shape[-1],))], dim=0)

    def update_cn(h_vn, h_cn_x, h_cn_z, hx_logit, hz_logit):
        # "from VN to CN": from = the VN endpoint, to = the CN endpoint
        out = []
        for side, g, h_cn, logit in (("x", gx, h_cn_x, hx_logit), ("z", gz, h_cn_z, hz_logit)):
            msg = _mlp(cat_attr(_cn_slot_features(h_vn, h_cn, g), f"cn_msg_{side}"),
                       params[f"cn_msg_mlp_{side}"], act)  # [m, dc, c_pad, B]
            red = cat_attr(_reduce_slots(msg, g.cn_mask, g.cn_deg, cfg.reduce_op), f"cn_node_{side}")
            del msg
            out.append(_mlp(torch.cat([red, h_cn, logit[None]], dim=0), params[f"cn_embed_mlp_{side}"],
                            act))
        return out

    def update_vn(h_cn_x, h_cn_z, h_vn):
        red = []
        for side, g, h_cn, syn_pm in (("x", gx, h_cn_x, syn_x_pm), ("z", gz, h_cn_z, syn_z_pm)):
            msg = _mlp(cat_attr(_vn_slot_features(h_cn, h_vn, g), f"vn_msg_{side}"),
                       params[f"vn_msg_mlp_{side}"], act)  # [m, dv, n_pad, B]
            msg = msg * syn_pm[g.edge_cn_byslot][None]  # syndrome-signed messages
            red.append(_reduce_slots(msg, g.vn_mask, g.vn_deg, cfg.reduce_op))
            del msg
        # one VN node attribute, concatenated onto m_z only
        red[1] = cat_attr(red[1], "vn_node")
        return _mlp(torch.cat([red[0], red[1], h_vn], dim=0), params["vn_embed_mlp"], act)

    # initial CN update with zero logits
    h_cn_x, h_cn_z = update_cn(h_vn, h_cn_x, h_cn_z, torch.zeros_like(syn_x_pm),
                               torch.zeros_like(syn_z_pm))

    stack = [] if collect_logits else None
    llrs = None
    for i in range(cfg.num_iter):
        h_vn = update_vn(h_cn_x, h_cn_z, h_vn)
        hx_logit, hz_logit, x_perp, z_perp, llrs = _cal_logit(params, lrowsets, h_vn)
        if collect_logits:
            stack.append(_cal_prob(params, h_vn) if cfg.loss_type == "sine" else (x_perp, z_perp))
        if i == cfg.num_iter - 1:
            break
        h_cn_x, h_cn_z = update_cn(h_vn, h_cn_x, h_cn_z, hx_logit * syn_x_pm, hz_logit * syn_z_pm)

    x_hat, z_hat = hard_decision(*llrs)
    return x_hat, z_hat, stack


def gnn_bp4_loss(params, graph, lrowsets, cfg: GNNBP4Config, noise_x, noise_z, loss_from: int = 0):
    """Deep-supervision BCE over the per-iteration perp logits.

    Labels: the x_perp rows are [hz; lz], so the hz block must reproduce
    1 - syndrome_z and the lz block 1 - (lz @ noise_x mod 2); the same for
    z_perp.  noise_x / noise_z: [n, B] {0, 1}."""
    from ..ops.gf2mat import mod2_matmul
    from ..train.loss import bce_with_logits

    # with loss_type='sine' the stack holds [n_pad, B] probabilities, not
    # perp-row logits: the BCE below would not fit
    if cfg.loss_type != "boxplus-phi":
        raise ValueError(f"gnn_bp4_loss needs loss_type='boxplus-phi' (per-iteration perp logits); "
                         f"got {cfg.loss_type!r}")

    n_pad = graph.n_pad
    noise_x = torch.nn.functional.pad(noise_x.to(torch.int32), (0, 0, 0, n_pad - noise_x.shape[0]))
    noise_z = torch.nn.functional.pad(noise_z.to(torch.int32), (0, 0, 0, n_pad - noise_z.shape[0]))
    syndrome_x = mod2_matmul(graph.hx, noise_z)  # [cx_pad, B]
    syndrome_z = mod2_matmul(graph.hz, noise_x)
    rows_hx, rows_hz, rows_lx, rows_lz = lrowsets
    # logical syndromes, padded to the row sets' aligned row counts
    lsz = mod2_matmul(graph.lz[: rows_lz.r_pad], noise_x)
    lsx = mod2_matmul(graph.lx[: rows_lx.r_pad], noise_z)

    gt_x = 1.0 - torch.cat([syndrome_z[: rows_hz.r_pad], lsz], dim=0).to(torch.float32)
    gt_z = 1.0 - torch.cat([syndrome_x[: rows_hx.r_pad], lsx], dim=0).to(torch.float32)
    rv_x = torch.cat([rows_hz.row_valid, rows_lz.row_valid])
    rv_z = torch.cat([rows_hx.row_valid, rows_lx.row_valid])

    _, _, stack = gnn_bp4_apply(params, graph, lrowsets, syndrome_x, syndrome_z, cfg, collect_logits=True)
    loss = 0.0
    for x_perp, z_perp in stack[loss_from:]:
        loss = loss + bce_with_logits(gt_x, x_perp, rv_x) + bce_with_logits(gt_z, z_perp, rv_z)
    return loss


def load_gnn_bp4_weights(path: str, cfg: GNNBP4Config, device=None, graph=None):
    """Parameters from a file the JAX package's ``save_pytree`` (or this
    package's) wrote, e.g. keys ``cn_msg_mlp_x/0/kernel``,
    ``llr_inv_embed/bias``, in ``init_gnn_bp4``'s tree on ``device``
    (default: the card).  Raises ValueError when the file's leaves or their
    shapes are not those of ``cfg``."""
    from .. import resolve_device

    device = resolve_device(device)
    like = init_gnn_bp4(torch.Generator().manual_seed(0), cfg, graph)
    want = {k: tuple(v.shape) for k, v in flatten_with_paths(like).items()}
    with np.load(path, allow_pickle=False) as data:
        have = {k: tuple(data[k].shape) for k in data.files}
    if have != want:
        raise ValueError(f"{path} does not hold GNN_BP4 parameters of {cfg}: "
                         f"file {sorted(have.items())}, expected {sorted(want.items())}")
    return load_pytree(path, like, device)


def load_shipped(name: str, device=None):
    """(params, cfg) of the shipped trained weights ``weights/gnn_bp4_<name>.npz``
    (``name``: "n882" or "gb48"), the configuration from the JSON beside them."""
    stem = os.path.join(SHIPPED_DIR, f"gnn_bp4_{name}")
    with open(stem + ".json") as f:
        cfg = GNNBP4Config(**json.load(f))
    return load_gnn_bp4_weights(stem + ".npz", cfg, device), cfg
