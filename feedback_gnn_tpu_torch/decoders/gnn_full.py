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
plain XLA.  ``axis`` (a process group, or None) runs the decoder on one
edge shard of the graph (parallel/shard.py; its row sets from
``make_logit_rowsets`` of the shard): the VN reductions are completed over
the group, so h_vn and the decisions are replicated while the CN
embeddings and logits stay shard-local; what is replicated is marked with
``pvary`` where it enters shard-local work.  The max/min reductions across
shards are forward-only, as JAX's ``pmax``/``pmin`` are.

On a card each CN update (both sides) and each VN update is one launch of
a hand-written kernel (``csrc/gnn_bp4.cu``: one thread a (node, sample)
pair, every edge feature, hidden activation and message in registers)
where ``takes_kernel`` says so: no gradient to carry, no edge shard, and a
configuration and graph the library has an instance for
(``kernel_instance``: two-layer ReLU MLPs without biases, a mean or sum,
widths in ``KERNEL_WIDTHS``, node degrees within ``KERNEL_SLOTS``).  Every
other call, the CPU's among them, takes the plain version
(``_update_cn_plain``, ``_update_vn_plain``), which is also the kernels'
oracle; a card call that takes the kernel path with tensors or parameters
the kernel cannot read (devices, dtypes, shapes) raises ``ValueError``.

Spans (``obs``): ``gnn_bp4.cn`` a CN update, ``gnn_bp4.vn`` a VN update,
each with the attribute ``iteration`` (the CN update that feeds VN update
i is iteration i), and ``gnn_bp4.logits`` each ``_cal_logit``; counters
``gnn_bp4.decodes``, keyed by (batch, iterations), a decode on the card,
and ``gnn_bp4.launches``, keyed by (path ``"kernel"`` or ``"plain"``,
update ``"cn"`` or ``"vn"``, batch), an update on the card.

``load_gnn_bp4_weights`` reads a parameter file that the JAX package's
``save_pytree`` wrote; ``load_with_config`` such a file with the
configuration in the JSON beside it, ``load_shipped`` the trained weights
of ``weights/gnn_bp4_*.npz``.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..codes.graph import build_rowset
from ..io.checkpoint import flatten_with_paths, load_pytree
from ..ops.dense import dense_bl, init_dense, init_mlp
from ..parallel.collectives import pmax, pmin, psum, pvary, pvary_tree
from .bp4 import hard_decision, quaternary_to_binary_llrs
from .cn_update import boxplus_rows
from .gnn_feedback import _carries_gradient

__all__ = [
    "GNNBP4Config", "init_gnn_bp4", "gnn_bp4_apply", "gnn_bp4_loss", "make_logit_rowsets",
    "load_gnn_bp4_weights", "load_with_config", "load_shipped", "SHIPPED_DIR",
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


def _reduce_slots(messages, mask, deg, reduce_op: str, axis=None):
    """Aggregate per-slot messages [m, d, N_pad, B] at the nodes -> [m, N_pad, B],
    completed over the edge group ``axis`` (the VN side of an edge shard).

    max/min split the gradient evenly among tied slots (``amax``/``amin``,
    as JAX's reductions do) and give 0 at degree-0 nodes; mean divides by
    max(deg, 1)."""
    if reduce_op in ("max", "min"):
        big = 3.4e38
        valid = (mask > 0)[None, :, :, None]
        if reduce_op == "max":
            red = pmax(torch.where(valid, messages, -big).amax(dim=1), axis)
        else:
            red = pmin(torch.where(valid, messages, big).amin(dim=1), axis)
        # degree-0 (padding) nodes: no incoming messages -> 0
        return torch.where((psum(deg, axis) > 0)[None, :, None], red, 0.0)
    s = psum((messages * mask[None, :, :, None]).sum(dim=1), axis)
    if reduce_op == "sum":
        return s
    if reduce_op == "mean":
        return s / deg.clamp(min=1.0)[None, :, None]
    raise ValueError(reduce_op)


def _cat_attr(params, cfg, feat, name):
    """``feat`` with the attribute ``name`` concatenated onto its leading
    axis (attributes are shared across the batch), or ``feat`` itself
    without ``cfg.use_attributes``."""
    attrs = params.get("attributes") if cfg.use_attributes else None
    if attrs is None:
        return feat
    a = attrs[name]
    return torch.cat([feat, a[..., None].expand(a.shape + (feat.shape[-1],))], dim=0)


def _update_cn_plain(params, graph, cfg, h_vn, h_cn_x, h_cn_z, hx_logit, hz_logit, axis=None):
    """``_update_cn`` in plain PyTorch on any device: the update of CPU
    tensors, edge shards, gradients and configurations without a kernel
    instance, and the kernel's oracle."""
    act = _act(cfg.activation)
    out = []
    for side, g, h_cn, logit in (("x", graph.gx, h_cn_x, hx_logit), ("z", graph.gz, h_cn_z, hz_logit)):
        # "from VN to CN": from = the VN endpoint, to = the CN endpoint
        feat = _cat_attr(params, cfg, _cn_slot_features(pvary(h_vn, axis), h_cn, g), f"cn_msg_{side}")
        msg = _mlp(feat, params[f"cn_msg_mlp_{side}"], act)  # [m, dc, c_pad, B]
        del feat
        red = _cat_attr(params, cfg, _reduce_slots(msg, g.cn_mask, g.cn_deg, cfg.reduce_op), f"cn_node_{side}")
        del msg
        out.append(_mlp(torch.cat([red, h_cn, logit[None]], dim=0), params[f"cn_embed_mlp_{side}"], act))
    return out


def _update_vn_plain(params, graph, cfg, h_cn_x, h_cn_z, h_vn, syn_x_pm, syn_z_pm, axis=None):
    """``_update_vn`` in plain PyTorch on any device (as ``_update_cn_plain``)."""
    act = _act(cfg.activation)
    red = []
    for side, g, h_cn, syn_pm in (("x", graph.gx, h_cn_x, syn_x_pm), ("z", graph.gz, h_cn_z, syn_z_pm)):
        feat = _cat_attr(params, cfg, _vn_slot_features(h_cn, pvary(h_vn, axis), g), f"vn_msg_{side}")
        msg = _mlp(feat, params[f"vn_msg_mlp_{side}"], act)  # [m, dv, n_pad, B]
        del feat
        msg = msg * syn_pm[g.edge_cn_byslot][None]  # syndrome-signed messages
        red.append(_reduce_slots(msg, g.vn_mask, g.vn_deg, cfg.reduce_op, axis))
        del msg
    # one VN node attribute, concatenated onto m_z only
    red[1] = _cat_attr(params, cfg, red[1], "vn_node")
    return _mlp(torch.cat([red[0], red[1], h_vn], dim=0), params["vn_embed_mlp"], act)


# The kernels' instances (csrc/gnn_bp4.cu, BP4_CN_INSTANCES and
# BP4_VN_INSTANCES): the widths (embed, message, hidden), and per (CN slots,
# VN slots) the slots a pass of the message MLP holds in registers in the
# CN update and in the VN update.
KERNEL_WIDTHS = ((20, 20, 40),)
KERNEL_SLOTS = {(6, 3): (2, 3), (8, 4): (4, 4)}


def kernel_instance(cfg, graph):
    """((e, m, h), (CN slots, VN slots)) of the kernels for ``cfg`` on
    ``graph``, the fewest slots that hold both sides' node degrees; None
    where the library has none: attributes, MLPs of another depth, another
    activation, biases, a max or min reduction, widths not in
    ``KERNEL_WIDTHS`` or degrees above every instance's slots."""
    widths = (cfg.num_embed_dims, cfg.num_msg_dims, cfg.num_hidden_units)
    if (cfg.use_attributes or cfg.num_mlp_layers != 2 or cfg.activation != "relu" or cfg.use_bias
            or cfg.reduce_op not in ("mean", "sum") or widths not in KERNEL_WIDTHS):
        return None
    dc = max(graph.gx.max_cn_deg, graph.gz.max_cn_deg)
    dv = max(graph.gx.max_vn_deg, graph.gz.max_vn_deg)
    fits = sorted(s for s in KERNEL_SLOTS if s[0] >= dc and s[1] >= dv)
    return (widths, fits[0]) if fits else None


def takes_kernel(cfg, graph, on_card: bool, carries_gradient: bool, axis=None) -> bool:
    """Whether a CN or VN update runs its kernel: a call on the card with
    no gradient to carry (``gnn_feedback._carries_gradient``), no edge
    shard and a ``kernel_instance``.  A pure function of what the call
    observes."""
    return on_card and not carries_gradient and axis is None and kernel_instance(cfg, graph) is not None


def _packed(params, mlps, device):
    """The weights of the two-layer MLPs ``mlps`` ((name, (fan_in, hidden,
    fan_out)), ...) in turn as one float32 vector on ``device``, each
    layer's kernel in its [in, out] layout, row-major: the order
    csrc/gnn_bp4.cu reads them.  Raises ValueError where a layer is not a
    bias-free float32 kernel of that shape on ``device``."""
    parts = []
    for name, (fan_in, hidden, fan_out) in mlps:
        layers = params.get(name)
        if not isinstance(layers, (list, tuple)) or len(layers) != 2:
            raise ValueError(f"{name}: the kernel takes two dense layers")
        for layer, shape in zip(layers, ((fan_in, hidden), (hidden, fan_out))):
            kernel = layer.get("kernel") if isinstance(layer, dict) else None
            if isinstance(layer, dict) and layer.get("bias") is not None:
                raise ValueError(f"{name}: a layer with a bias; the kernel takes bias-free layers")
            if (not isinstance(kernel, torch.Tensor) or tuple(kernel.shape) != shape
                    or kernel.dtype != torch.float32 or kernel.device != device):
                raise ValueError(f"{name}: a kernel of shape {getattr(kernel, 'shape', None)}, dtype "
                                 f"{getattr(kernel, 'dtype', None)} on {getattr(kernel, 'device', None)}; the "
                                 f"kernel takes float32 {shape} on {device}")
            parts.append(kernel.detach().contiguous().reshape(-1))
    return torch.cat(parts)


def _check_call(graph, tensors, shapes, tables):
    """Raise ValueError unless ``tensors`` are float32 of ``shapes`` on one
    device with the graph's ``tables`` (int64 node ids, float32 masks and
    degrees), one VN pad and a batch.  Returns the device."""
    device = tensors[0].device
    if any(t.device != device for t in tensors + tables):
        raise ValueError(f"embeddings and graph on several devices: "
                         f"{sorted({str(t.device) for t in tensors + tables})}")
    for t, shape in zip(tensors, shapes):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"a {t.dtype} input of shape {tuple(t.shape)}: the kernel takes float32 {shape}")
    if any(t.dtype != d for t, d in zip(tables, (torch.int64, torch.float32, torch.float32) * 2)):
        raise ValueError("graph tables not in graph.py's dtypes (int64 node ids, float32 masks and degrees)")
    if graph.gx.n_pad != graph.gz.n_pad or shapes[0][-1] == 0:
        raise ValueError(f"VN pads {graph.gx.n_pad}, {graph.gz.n_pad} and batch {shapes[0][-1]}: the kernel takes "
                         "one VN pad and a batch")
    return device


def _kernel_call(update, params, graph, cfg, tensors):
    """What both launchers share: the instance, the call's checks
    (``_check_call``), the packed weights of the update's MLPs and its inputs
    made contiguous.  ``tensors`` are (h_vn, h_cn_x, h_cn_z, and per side a
    [c_pad, B] row: the check logits of a CN update or the syndrome signs of
    a VN update).  Returns (device, widths, (slots a node, slots a pass),
    packed weights, tensors)."""
    (e, m, h), slots = kernel_instance(cfg, graph)
    gx, gz = graph.gx, graph.gz
    b = tensors[0].shape[-1]
    shapes = [(e, gx.n_pad, b), (e, gx.c_pad, b), (e, gz.c_pad, b), (gx.c_pad, b), (gz.c_pad, b)]
    msg = (2 * e, h, m)
    if update == "cn":
        tables = [t for g in (gx, gz) for t in (g.edge_vn_byslot, g.cn_mask, g.cn_deg)]
        mlps = [(f"cn_{kind}_mlp_{side}", dims) for side in "xz"
                for kind, dims in (("msg", msg), ("embed", (m + e + 1, h, e)))]
    else:
        tables = [t for g in (gx, gz) for t in (g.edge_cn_byslot, g.vn_mask, g.vn_deg)]
        mlps = [("vn_msg_mlp_x", msg), ("vn_msg_mlp_z", msg), ("vn_embed_mlp", (2 * m + e, h, e))]
    dev = _check_call(graph, tensors, shapes, tables)
    which = 0 if update == "cn" else 1
    return (dev, (e, m, h), (slots[which], KERNEL_SLOTS[slots][which]), _packed(params, mlps, dev),
            [t.contiguous() for t in tensors])


def _launch(name, dev, *args):
    """The library's launcher ``name`` with ``args`` and the current stream of ``dev``."""
    from .._build import load_kernels

    lib = load_kernels()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        detail = "no such instance" if err == -2 else lib.fgt_cuda_error_string(err).decode()
        raise RuntimeError(f"GNN_BP4 kernel launch {name} failed: {detail}")


def _launch_cn(params, graph, cfg, h_vn, h_cn_x, h_cn_z, hx_logit, hz_logit):
    """Both sides' CN updates as one kernel launch on the current stream."""
    dev, widths, slots, packed, (h_vn, h_cn_x, h_cn_z, hx_logit, hz_logit) = _kernel_call(
        "cn", params, graph, cfg, [h_vn, h_cn_x, h_cn_z, hx_logit, hz_logit])
    gx, gz, b = graph.gx, graph.gz, h_vn.shape[-1]
    out = [torch.empty((widths[0], g.c_pad, b), dtype=torch.float32, device=dev) for g in (gx, gz)]
    sides = [arg for g, h_cn, logit, o in ((gx, h_cn_x, hx_logit, out[0]), (gz, h_cn_z, hz_logit, out[1]))
             for arg in (h_cn.data_ptr(), logit.data_ptr(), o.data_ptr(), g.edge_vn_byslot.data_ptr(),
                         g.cn_mask.data_ptr(), g.cn_deg.data_ptr(), g.c_pad, g.max_cn_deg)]
    _launch("fgt_gnn_bp4_cn_launch", dev, h_vn.data_ptr(), gx.n_pad, *sides, packed.data_ptr(), b,
            int(cfg.reduce_op == "mean"), *widths, *slots)
    return out


def _launch_vn(params, graph, cfg, h_cn_x, h_cn_z, h_vn, syn_x_pm, syn_z_pm):
    """The VN update as one kernel launch on the current stream."""
    dev, widths, slots, packed, (h_vn, h_cn_x, h_cn_z, syn_x_pm, syn_z_pm) = _kernel_call(
        "vn", params, graph, cfg, [h_vn, h_cn_x, h_cn_z, syn_x_pm, syn_z_pm])
    gx, gz, b = graph.gx, graph.gz, h_vn.shape[-1]
    out = torch.empty((widths[0], gx.n_pad, b), dtype=torch.float32, device=dev)
    sides = [arg for g, h_cn, sign in ((gx, h_cn_x, syn_x_pm), (gz, h_cn_z, syn_z_pm))
             for arg in (h_cn.data_ptr(), sign.data_ptr(), g.edge_cn_byslot.data_ptr(), g.vn_mask.data_ptr(),
                         g.vn_deg.data_ptr(), g.c_pad, g.max_vn_deg)]
    _launch("fgt_gnn_bp4_vn_launch", dev, h_vn.data_ptr(), gx.n_pad, out.data_ptr(), *sides, packed.data_ptr(), b,
            int(cfg.reduce_op == "mean"), *widths, *slots)
    return out


def _update_cn(params, graph, cfg, h_vn, h_cn_x, h_cn_z, hx_logit, hz_logit, axis=None):
    """The CN update of both sides: [h_cn_x, h_cn_z] from the VN and CN
    embeddings and each side's check logit times its syndrome sign.  One
    kernel launch where ``takes_kernel`` says so."""
    inputs = (h_vn, h_cn_x, h_cn_z, hx_logit, hz_logit)
    on_card = h_vn.device.type == "cuda"
    kernel = takes_kernel(cfg, graph, on_card, _carries_gradient(params, inputs), axis)
    out = _launch_cn(params, graph, cfg, *inputs) if kernel else _update_cn_plain(params, graph, cfg, *inputs, axis)
    if on_card:
        obs.count("gnn_bp4.launches", key=("kernel" if kernel else "plain", "cn", h_vn.shape[-1]))
    return out


def _update_vn(params, graph, cfg, h_cn_x, h_cn_z, h_vn, syn_x_pm, syn_z_pm, axis=None):
    """The VN update: the new h_vn from both sides' syndrome-signed
    messages, reduced at each VN, and the VN embeddings.  One kernel launch
    where ``takes_kernel`` says so."""
    inputs = (h_cn_x, h_cn_z, h_vn, syn_x_pm, syn_z_pm)
    on_card = h_vn.device.type == "cuda"
    kernel = takes_kernel(cfg, graph, on_card, _carries_gradient(params, inputs), axis)
    out = _launch_vn(params, graph, cfg, *inputs) if kernel else _update_vn_plain(params, graph, cfg, *inputs, axis)
    if on_card:
        obs.count("gnn_bp4.launches", key=("kernel" if kernel else "plain", "vn", h_vn.shape[-1]))
    return out


def _syndrome_pm(syndrome, rows):
    """+1 where a syndrome bit is 0, -1 where it is 1: [rows, B] float32,
    the rows past the syndrome's +1."""
    x = syndrome.to(torch.float32)
    return 1.0 - 2.0 * torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))


def _inv_embed(params, h_vn):
    layer = params["llr_inv_embed"]
    return dense_bl(h_vn, layer["kernel"], layer.get("bias"))  # [3, n_pad, B]


def _cal_logit(params, lrowsets, h_vn, axis=None):
    """llr_inv_embed -> binary LLRs -> boxplus over the [hz; lz] / [hx; lx]
    rows.  Returns (hx_logit, hz_logit, x_perp_logit, z_perp_logit,
    (llrx, llry, llrz))."""
    emb = _inv_embed(params, h_vn)
    llrx, llry, llrz = emb[0], emb[1], emb[2]
    llr_x, llr_z = quaternary_to_binary_llrs(llrx, llry, llrz)
    if axis is not None:  # replicated LLRs into the shard's rows
        llr_x, llr_z = pvary(torch.stack([llr_x, llr_z]), axis).unbind(0)
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
                  collect_logits: bool = False, axis=None):
    """Decode from the syndromes alone.

    syndrome_x / syndrome_z: [mx or c_pad, B] / [mz or c_pad, B] in {0, 1}.
    Returns (x_hat, z_hat, stack): int32 [n_pad, B] decisions, and with
    ``collect_logits`` the per-iteration (x_perp, z_perp) logits (or
    (p_x, p_z) with ``loss_type="sine"``), else None.  ``axis`` is the edge
    group when ``graph`` is an edge shard (the logits are the shard's rows).
    """
    if axis is not None and cfg.use_attributes:
        raise ValueError("use_attributes with an edge axis: the attributes are laid out on "
                         "the unsharded graph")
    # the message and CN-embedding MLPs see only shard-local features
    local = {k: pvary_tree(v, axis) for k, v in params.items() if k.startswith("cn_") or
             k.startswith("vn_msg")}
    params = {**params, **local}
    gx, gz = graph.gx, graph.gz
    b = syndrome_x.shape[-1]
    e = cfg.num_embed_dims
    dev = syndrome_x.device

    if syndrome_x.is_cuda:
        obs.count("gnn_bp4.decodes", key=(b, cfg.num_iter))

    syn_x_pm = _syndrome_pm(syndrome_x, gx.c_pad)
    syn_z_pm = _syndrome_pm(syndrome_z, gz.c_pad)

    h_vn = torch.ones((e, gx.n_pad, b), device=dev)
    h_cn_x = torch.zeros((e, gx.c_pad, b), device=dev)
    h_cn_z = torch.zeros((e, gz.c_pad, b), device=dev)

    # initial CN update with zero logits
    with obs.span("gnn_bp4.cn", iteration=0):
        h_cn_x, h_cn_z = _update_cn(params, graph, cfg, h_vn, h_cn_x, h_cn_z, torch.zeros_like(syn_x_pm),
                                    torch.zeros_like(syn_z_pm), axis)

    stack = [] if collect_logits else None
    llrs = None
    for i in range(cfg.num_iter):
        with obs.span("gnn_bp4.vn", iteration=i):
            h_vn = _update_vn(params, graph, cfg, h_cn_x, h_cn_z, h_vn, syn_x_pm, syn_z_pm, axis)
        with obs.span("gnn_bp4.logits", iteration=i):
            hx_logit, hz_logit, x_perp, z_perp, llrs = _cal_logit(params, lrowsets, h_vn, axis)
        if collect_logits:
            stack.append(_cal_prob(params, h_vn) if cfg.loss_type == "sine" else (x_perp, z_perp))
        if i == cfg.num_iter - 1:
            break
        with obs.span("gnn_bp4.cn", iteration=i + 1):
            h_cn_x, h_cn_z = _update_cn(params, graph, cfg, h_vn, h_cn_x, h_cn_z, hx_logit * syn_x_pm,
                                        hz_logit * syn_z_pm, axis)

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


def load_with_config(path: str, device=None):
    """(params, cfg) of the weights file ``path`` (``<stem>.npz``), the
    configuration from ``<stem>.json`` beside it."""
    with open(os.path.splitext(path)[0] + ".json") as f:
        cfg = GNNBP4Config(**json.load(f))
    return load_gnn_bp4_weights(path, cfg, device), cfg


def load_shipped(name: str, device=None):
    """(params, cfg) of the shipped trained weights ``weights/gnn_bp4_<name>.npz``
    (``name``: "n882" or "gb48"), the configuration from the JSON beside them."""
    return load_with_config(os.path.join(SHIPPED_DIR, f"gnn_bp4_{name}.npz"), device)
