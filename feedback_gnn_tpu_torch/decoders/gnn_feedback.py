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

``axis`` (a process group, or None) runs the step on one edge shard of the
graph: logits and syndromes are the shard's rows, h_vn is replicated, and
each VN mean over edges is summed over the group.  What is replicated (the
per-VN part of the edge MLP, its parameters) is marked with ``pvary``
where it meets the shard's edges, so autograd sums its cotangents over the
group.

On a card the step is one hand-written kernel (``csrc/gnn_feedback.cu``:
one thread a (VN, sample) pair, every hidden activation in registers).
Two calls keep the plain PyTorch version below there: an edge shard
(``axis``) and a gradient to carry (grad mode on and an input or parameter
that requires grad).  Any other CUDA call the kernel cannot take (another
dtype or shape, parameters other than the 2-layer edge MLPs and 1-layer
embed of a width in ``FUSED_WIDTHS``, a VN degree above ``FUSED_SLOTS``)
raises ``ValueError``.  CPU tensors take the plain version, which is also
the kernel's oracle.  The counter ``gnn.launches`` (``obs``) counts each
call on the card, keyed by path (``"fused"`` or ``"plain"``) and batch.
"""

from __future__ import annotations

import ctypes
import functools
import pickle

import numpy as np
import torch

from .. import obs
from ..codes.graph import TannerGraph
from ..io.checkpoint import flatten_with_paths
from ..ops.dense import dense_bl, init_dense, init_mlp, mlp_bl
from ..parallel.collectives import psum, pvary, pvary_tree

__all__ = [
    "init_feedback_gnn", "feedback_gnn_apply", "feedback_gnn_apply_plain", "load_weights",
    "load_reference_weights", "save_reference_weights", "params_from_numpy",
]


def params_from_numpy(tree, device=None):
    """The port's parameters from a parameter tree of arrays (nested dicts
    and lists, e.g. the JAX package's pytree converted with ``np.asarray``):
    the same structure with float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def init_feedback_gnn(generator: torch.Generator, num_msg_dims: int = 20,
                      num_hidden_units: int = 40, num_mlp_layers: int = 2):
    """Fresh parameters of the reference architecture on the generator's
    device (llr_inv_embed has a zero kernel and ones bias)."""
    hidden = [num_hidden_units] * (num_mlp_layers - 1)
    return {
        "llr_inv_embed": init_dense(generator, num_hidden_units, 3, kernel_init="zeros"),
        # edge MLPs, input = 1 (cn logit) + 3 (h_vn)
        "msg_mlp_x": init_mlp(generator, 4, hidden + [num_msg_dims]),
        "msg_mlp_z": init_mlp(generator, 4, hidden + [num_msg_dims]),
        # embed MLP, input = 2*msg_dims + 3
        "embed_mlp": init_mlp(generator, 2 * num_msg_dims + 3, hidden),
    }


def load_reference_weights(path: str, device=None):
    """Parameters from a reference weight pickle: the 12-array Keras
    ``get_weights()`` list [llr_inv_embed K, b, msg_mlp_x l0 K, b, l1 K, b,
    msg_mlp_z l0 K, b, l1 K, b, embed_mlp l0 K, b]."""
    with open(path, "rb") as f:
        w = [np.asarray(a, np.float32) for a in pickle.load(f)]
    if len(w) != 12:
        raise ValueError(f"{path}: expected 12 arrays, got {len(w)}")
    layers = [{"kernel": w[i], "bias": w[i + 1]} for i in range(0, 12, 2)]
    tree = {"llr_inv_embed": layers[0], "msg_mlp_x": layers[1:3], "msg_mlp_z": layers[3:5],
            "embed_mlp": layers[5:]}
    return params_from_numpy(tree, device)


def save_reference_weights(params, path: str):
    """Export parameters to the reference pickle format (float32 numpy
    arrays in the Keras order)."""
    layers = [params["llr_inv_embed"], *params["msg_mlp_x"], *params["msg_mlp_z"], *params["embed_mlp"]]
    w = [np.asarray(torch.as_tensor(layer[k]).detach().cpu(), np.float32)
         for layer in layers for k in ("kernel", "bias")]
    with open(path, "wb") as f:
        pickle.dump(w, f)


def load_weights(path: str, device=None):
    """Feedback-GNN parameters from either format: an ``.npz`` checkpoint in
    the JAX package's key layout (``feedback_gnn_tpu/weights/*.npz``,
    io/checkpoint.py) or a reference 12-array pickle."""
    if not path.endswith(".npz"):
        return load_reference_weights(path, device)
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
    return mlp_bl(x, layers, [torch.tanh] * (len(layers) - 1) + [None])


def _mlp_all_tanh(x, layers):
    """The embed MLP keeps the activation on every layer."""
    return mlp_bl(x, layers, [torch.tanh] * len(layers))


def _vn_mean(messages, graph: TannerGraph, axis=None):
    """Masked mean of per-edge (slot-major) messages at each VN:
    [F, dv, n_pad, B] -> [F, n_pad, B].  The division is by the true
    (global) degree, so the partial sums of edge shards add up."""
    s = psum((messages * graph.vn_mask[None, :, :, None]).sum(dim=1), axis)
    return s / graph.vn_deg.clamp_min(1.0)[None, :, None]


def _edge_messages(mlp, h_vn, h_cn_e, g: TannerGraph, axis=None):
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
        u, w_cn = pvary(u, axis), pvary(w0[0][:, None, None], axis)  # [H, 1, 1]
        acc = None
        for d in range(g.max_vn_deg):
            t = torch.tanh(u + w_cn * h_cn_e[d][None]) * g.vn_mask[d][None, :, None]
            acc = t if acc is None else acc + t
        t = psum(acc / g.vn_deg.clamp_min(1.0)[None, :, None], axis)
        return dense_bl(t, mlp[1]["kernel"], mlp[1].get("bias"))
    # general path: materialise per-edge features
    dv = g.max_vn_deg
    h_vn = pvary(h_vn, axis)
    feat = torch.cat([h_cn_e[None], h_vn[:, None].expand((3, dv) + h_vn.shape[1:])], dim=0)
    return _vn_mean(_mlp_tanh(feat, pvary_tree(mlp, axis)), g, axis)


# (hidden units, message dims) of the fused kernel's instances, and the VN
# degrees (slots) each is built for; csrc/gnn_feedback.cu, GNN_INSTANCES
FUSED_WIDTHS = ((40, 20),)
FUSED_SLOTS = (3, 8)
_LAYERS = ("msg_mlp_x", "msg_mlp_z", "embed_mlp", "llr_inv_embed")


def _carries_gradient(params, tensors):
    """Grad mode on and an input or a parameter that requires grad."""
    if not torch.is_grad_enabled():
        return False
    return any(t.requires_grad for t in tensors) or any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in flatten_with_paths(params).values())


def _fused_layers(params):
    """(hidden, msg_dims, the 12 tensors in the kernel's order: w0x, w0z,
    b0x, b0z, w1x, w1z, b1x, b1z, we, be, wo, bo, a missing bias None).
    Raises ValueError unless ``params`` are the 2-layer edge MLPs and
    1-layer embed of a fused instance."""
    try:
        ex, ez, emb, out = (params[k] for k in _LAYERS)
        if len(ex) != 2 or len(ez) != 2 or len(emb) != 1:
            raise ValueError(f"MLP depths {len(ex)}, {len(ez)}, {len(emb)}: the kernel takes 2, 2 and 1")
        (ex0, ex1), (ez0, ez1), (em,) = ex, ez, emb
        layers = [ex0["kernel"], ez0["kernel"], ex0.get("bias"), ez0.get("bias"), ex1["kernel"], ez1["kernel"],
                  ex1.get("bias"), ez1.get("bias"), em["kernel"], em.get("bias"), out["kernel"], out.get("bias")]
        h, m = layers[0].shape[-1], layers[4].shape[-1]
    except (KeyError, TypeError, AttributeError, IndexError) as err:
        raise ValueError(f"parameters not in the feedback GNN's layout ({err!r})") from None
    if (h, m) not in FUSED_WIDTHS:
        raise ValueError(f"widths (hidden, msg_dims) = {(h, m)}: the kernel has {FUSED_WIDTHS}")
    shapes = [(4, h), (4, h), (h,), (h,), (h, m), (h, m), (m,), (m,), (2 * m + 3, h), (h,), (h, 3), (3,)]
    for t, shape in zip(layers, shapes):
        if t is None and len(shape) == 1:
            continue
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"a parameter of shape {getattr(t, 'shape', None)} and dtype "
                             f"{getattr(t, 'dtype', None)}: the kernel takes float32 {shape}")
    return h, m, layers


def _fused_instance(params, graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z):
    """The fused kernel's instance (hidden, msg_dims, slots) for this call
    and its 12 parameter tensors (``_fused_layers``).  Raises ValueError
    where the kernel cannot take the call.  The device type, the edge
    shard and the gradient are the caller's to check."""
    h, m, layers = _fused_layers(params)
    gx, gz = graph.gx, graph.gz
    tensors = [h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z]
    tables = [t for g in (gx, gz) for t in (g.edge_cn_byslot, g.vn_mask, g.vn_deg)]
    devices = {t.device for t in tensors + tables + [t for t in layers if t is not None]}
    if len(devices) != 1:
        raise ValueError(f"inputs, parameters and graph on several devices: {sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in tensors[:3]):
        raise ValueError(f"marginals and check logits of dtypes {[t.dtype for t in tensors[:3]]}: "
                         "the kernel takes float32")
    if any(t.dtype != torch.int32 for t in tensors[3:]):
        raise ValueError(f"syndromes of dtypes {[t.dtype for t in tensors[3:]]}: the kernel reads int32, "
                         "mod2_matmul's")
    for g in (gx, gz):
        if (g.edge_cn_byslot.dtype, g.vn_mask.dtype, g.vn_deg.dtype) != (torch.int64, torch.float32, torch.float32):
            raise ValueError("graph tables not in graph.py's dtypes (int64 CN ids, float32 masks and degrees)")
    b = h_vn.shape[-1]
    if h_vn.dim() != 3 or h_vn.shape[0] != 3 or not 0 < h_vn.shape[1] <= gx.n_pad or b == 0:
        raise ValueError(f"marginals of shape {tuple(h_vn.shape)}: the kernel takes [3, n <= {gx.n_pad}, B > 0]")
    if gx.n_pad != gz.n_pad or gx.n_pad > 65535:
        raise ValueError(f"VN pads {gx.n_pad}, {gz.n_pad}: the kernel takes one, at most 65535")
    for g, logit, syn in ((gx, logit_hx, syndrome_x), (gz, logit_hz, syndrome_z)):
        for t in (logit, syn):
            if t.dim() != 2 or t.shape[0] > g.c_pad or t.shape[1] != b:
                raise ValueError(f"check rows of shape {tuple(t.shape)}: the kernel takes [m <= {g.c_pad}, {b}]")
    dv = max(gx.max_vn_deg, gz.max_vn_deg)
    slots = [s for s in FUSED_SLOTS if s >= dv]
    if not slots:
        raise ValueError(f"VN degree {dv}: the kernel has instances up to {max(FUSED_SLOTS)}")
    return (h, m, slots[0]), layers


@functools.lru_cache(maxsize=None)
def _packed_floats(hidden, msg, slots):
    from .._build import load_kernels

    return load_kernels().fgt_gnn_feedback_packed_floats(hidden, msg, slots)


def _launch_fused(params, graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z):
    """The step as one kernel (csrc/gnn_feedback.cu) on the current
    stream: [3, n_pad, B].  Raises ValueError where it cannot take the call."""
    from .._build import load_kernels

    instance, layers = _fused_instance(params, graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z)
    lib = load_kernels()
    gx, gz = graph.gx, graph.gz
    dev, b = h_vn.device, h_vn.shape[-1]
    h_vn = h_vn.contiguous()
    sides = []
    keep = [h_vn]  # contiguous copies, alive until the launch is enqueued
    for g, logit, syn in ((gx, logit_hx, syndrome_x), (gz, logit_hz, syndrome_z)):
        logit, syn = logit.contiguous(), syn.contiguous()
        keep += [logit, syn]
        sides += [logit.data_ptr(), logit.shape[0], syn.data_ptr(), syn.shape[0], g.edge_cn_byslot.data_ptr(),
                  g.vn_mask.data_ptr(), g.vn_deg.data_ptr(), g.max_vn_deg]
    # kernels are read through their strides (the shipped ones are column-major), biases contiguous
    layers = [t if t is None or t.dim() == 2 else t.contiguous() for t in layers]
    keep += [t for t in layers if t is not None]
    weights = (ctypes.c_void_p * 12)(*(None if t is None else t.data_ptr() for t in layers))
    strides = (ctypes.c_int * 12)(*(st for t in layers if t is not None and t.dim() == 2 for st in t.stride()))
    packed = torch.empty(_packed_floats(*instance), dtype=torch.float32, device=dev)
    out = torch.empty((3, gx.n_pad, b), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fgt_gnn_feedback_launch(h_vn.data_ptr(), h_vn.shape[1], *sides, weights, strides, packed.data_ptr(),
                                          out.data_ptr(), gx.n_pad, b, *instance, stream)
    if err != 0:
        raise RuntimeError(f"feedback-GNN kernel launch failed: {lib.fgt_cuda_error_string(err).decode()}")
    obs.count("gnn.launches", key=("fused", b))
    return out


def feedback_gnn_apply(params, graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z, axis=None):
    """One feedback-GNN step.

    Args:
      h_vn: [3, n, B] or [3, n_pad, B] stacked (llrx, llry, llrz) marginals.
      logit_hx / logit_hz: [mx, B] / [mz, B] per-check logits (padded rows
        accepted).
      syndrome_x / syndrome_z: [mx, B] / [mz, B] in {0,1}.
      axis: the edge group when ``graph`` is an edge shard, else None.

    Returns the new LLR init [3, n_pad, B] in (x, y, z) order; its pad rows
    are generally nonzero (MLP biases).  On a card, the fused kernel unless
    the call has an edge shard or a gradient to carry (the module
    docstring); it raises ValueError for another call the kernel cannot take.
    """
    if h_vn.is_cuda:
        inputs = (h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z)
        if axis is None and not _carries_gradient(params, inputs):
            return _launch_fused(params, graph, *inputs)
        obs.count("gnn.launches", key=("plain", h_vn.shape[-1]))
    return feedback_gnn_apply_plain(params, graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z, axis)


def feedback_gnn_apply_plain(params, graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z, axis=None):
    """``feedback_gnn_apply`` in plain PyTorch on any device: the step of
    CPU tensors, edge shards and gradients, and the fused kernel's oracle.
    Counts nothing."""
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
    m_x = _edge_messages(params["msg_mlp_x"], h_vn, h_cn_x[gx.edge_cn_byslot], gx, axis)
    m_z = _edge_messages(params["msg_mlp_z"], h_vn, h_cn_z[gz.edge_cn_byslot], gz, axis)

    embed_in = torch.cat([m_x, m_z, h_vn], dim=0)  # [2*msg+3, n_pad, B]
    h = _mlp_all_tanh(embed_in, params["embed_mlp"])
    emb = params["llr_inv_embed"]
    return dense_bl(h, emb["kernel"], emb.get("bias"))  # [3, n_pad, B]
