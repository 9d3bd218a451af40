"""The feedback GNN, slot-major quaternary BP, check logits, decisions and
the deep-supervision loss, plain PyTorch: the reference for the cascade's
GNN stage and for the training step.

Frozen copies of the published decoder's definitions (arXiv:2310.17758 and
the reference implementation's conventions):

* phi(x) = log((e^x + 1)/(e^x - 1)) = softplus(x) - log(expm1(x)), input
  and output clipped to [8.5e-8, 16.635532]; a clip passes half of the
  gradient at a bound (as ``jnp.clip``), softplus has slope 1/2 at 0, and
  the sign of a CN output carries no gradient;
* check logits: boxplus over the rows of hz (x) and hx (z) of binary LLRs
  from the quaternary marginals; decisions argmin over (0, x, z, y);
* GNN: per-edge MLP on (check feature, VN marginals), mean at each VN,
  embed MLP, linear map to three LLRs (the layer widths come from the
  weights);
* loss: sum over BP iterations loss_from+1..num_iter of the mean binary
  cross-entropy between flipped syndrome labels and the check logits.

Tensors are batch-last; per-node state is padded to the layouts of
``codes.tanner`` with zero pad rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .codes import RowSet, Tanner

__all__ = ["Graph", "graph_on", "phi", "hard_decision", "check_logits", "gnn_apply", "bp4",
           "loss_terms", "load_gnn"]

PHI_CLIP_MIN = 8.5e-8
PHI_CLIP_MAX = 16.635532


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        scale = torch.ones_like(x)
        for bound, outside in zip(ctx.bounds, (x.__lt__, x.__gt__)):
            if bound is not None:
                scale = torch.where(outside(bound), 0.0, torch.where(x == bound, 0.5, scale))
        return grad * scale, None, None


def clip(x, lo=None, hi=None):
    if torch.is_grad_enabled() and x.requires_grad:
        return _Clip.apply(x, lo, hi)
    return x.clamp(lo, hi)


def softplus(x):
    return torch.log1p(torch.exp(-x.abs())) + clip(x, 0.0)


def phi(x):
    x = clip(x, PHI_CLIP_MIN, PHI_CLIP_MAX)
    return clip(softplus(x) - torch.log(torch.expm1(x)), PHI_CLIP_MIN, PHI_CLIP_MAX)


def _sign(x):
    return torch.where(x < 0, -1.0, 1.0)


class Graph:
    """Both Tanner layouts, the logit row sets and the dense matrices of a
    code as tensors on one device."""

    def __init__(self, gx: Tanner, gz: Tanner, rows_x: RowSet, rows_z: RowSet, device):
        def t(a):
            return torch.as_tensor(np.asarray(a), device=device)

        self.n, self.n_pad = gx.num_vn, gx.n_pad
        self.sides = {}
        for name, g in (("x", gx), ("z", gz)):
            self.sides[name] = dict(
                num_cn=g.num_cn, c_pad=g.c_pad, dv=g.dv, dc=g.dc, cn_gather=t(g.cn_gather),
                vn_gather=t(g.vn_gather), vn_mask=t(g.vn_mask), cn_mask=t(g.cn_mask),
                vn_deg=t(g.vn_deg), edge_cn_byslot=t(g.edge_cn_byslot))
        self.rows = {}
        for name, r in (("x", rows_x), ("z", rows_z)):
            self.rows[name] = dict(vn_idx=t(r.vn_idx), mask=t(r.mask), row_valid=t(r.row_valid))


def graph_on(code, device) -> Graph:
    """The reference layouts of a ``codes.Code``: logits over hz rows (x)
    and hx rows (z), as the cascade's stage mode defines them."""
    from .codes import rowset, tanner

    return Graph(tanner(code.hx), tanner(code.hz), rowset(code.hz), rowset(code.hx), device)


def _pad(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def hard_decision(llrx, llry, llrz):
    """argmin over (0, llrx, llrz, llry), first minimum on ties: (x, z) bits."""
    d = torch.argmin(torch.stack([torch.zeros_like(llrx), llrx, llrz, llry]), dim=0).to(torch.int32)
    return d & 1, d >> 1


def _lse2(a, b):
    mx = torch.maximum(a, b)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


def _boxplus_rows(vals, rows):
    v = vals[rows["vn_idx"]]
    m = rows["mask"][:, :, None]
    sign_node = torch.prod(torch.where(m > 0, _sign(v), 1.0), dim=0)
    p = phi(v.abs()) * m
    return sign_node * phi(torch.sum(p, dim=0))


def check_logits(llrx, llry, llrz, g: Graph):
    """(x logits over hz rows, z logits over hx rows), [r_pad, B] each, from
    padded marginals."""
    llr_z = softplus(-llrx) - _lse2(-llrz, -llry)
    llr_x = softplus(-llrz) - _lse2(-llrx, -llry)
    return _boxplus_rows(llr_x, g.rows["x"]), _boxplus_rows(llr_z, g.rows["z"])


def _dense(x, layer):
    y = torch.tensordot(layer["kernel"], x, dims=([0], [0]))
    return y + layer["bias"].reshape((-1,) + (1,) * (y.ndim - 1))


def _edge_mean(mlp, h_vn, h_cn_e, side):
    """Mean over each VN's edges of a 2-layer edge MLP (tanh hidden, linear
    out); layer 0 splits into a per-VN part and the check feature's part."""
    if len(mlp) != 2:
        raise ValueError("the reference GNN has 2-layer edge MLPs")
    w0 = mlp[0]["kernel"]
    u = torch.tensordot(w0[1:], h_vn, dims=([0], [0])) + mlp[0]["bias"][:, None, None]
    w_cn = w0[0][:, None, None]
    acc = None
    for d in range(side["dv"]):
        t = torch.tanh(u + w_cn * h_cn_e[d][None]) * side["vn_mask"][d][None, :, None]
        acc = t if acc is None else acc + t
    return _dense(acc / side["vn_deg"].clamp_min(1.0)[None, :, None], mlp[1])


def gnn_apply(params, g: Graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z):
    """New channel LLRs [3, n_pad, B] from marginals [3, n(_pad), B], the
    per-Hx-row and per-Hz-row check logits and the syndromes."""
    sx, sz = g.sides["x"], g.sides["z"]
    syn_x = 1.0 - 2.0 * _pad(syndrome_x.to(torch.float32), sx["c_pad"])
    syn_z = 1.0 - 2.0 * _pad(syndrome_z.to(torch.float32), sz["c_pad"])
    h_cn_x = _pad(logit_hx, sx["c_pad"]) * syn_x
    h_cn_z = _pad(logit_hz, sz["c_pad"]) * syn_z
    h_vn = _pad(h_vn, g.n_pad)
    m_x = _edge_mean(params["msg_mlp_x"], h_vn, h_cn_x[sx["edge_cn_byslot"]], sx)
    m_z = _edge_mean(params["msg_mlp_z"], h_vn, h_cn_z[sz["edge_cn_byslot"]], sz)
    h = torch.cat([m_x, m_z, h_vn], dim=0)
    for layer in params["embed_mlp"]:
        h = torch.tanh(_dense(h, layer))
    return _dense(h, params["llr_inv_embed"])


def _cn_phi(msg_cn, syn_pm, mask):
    m = mask[:, :, None]
    sign_val = torch.where(m > 0, _sign(msg_cn), 1.0)
    sign_out = sign_val * (torch.prod(sign_val, dim=0) * syn_pm)[None]
    p = phi(msg_cn.abs()) * m
    ext = torch.sum(p, dim=0)[None] - p
    return sign_out.detach() * phi(ext) * m


def bp4(g: Graph, llr_ch, syndrome_x, syndrome_z, num_iter: int, factor: float = 1.0,
        collect_logits: bool = False):
    """Boxplus-phi BP4 on the slot-major layout: (llrx, llry, llrz) [n_pad,
    B] and, with ``collect_logits``, the check logits of every iteration and
    the final ones, (xs, zs) [num_iter + 1, r_pad, B] each."""
    sx, sz = g.sides["x"], g.sides["z"]
    b, dev = llr_ch.shape[-1], llr_ch.device
    llr_ch = _pad(llr_ch.to(torch.float32), g.n_pad)
    syn_x = 1.0 - 2.0 * _pad(syndrome_x.to(torch.float32), sx["c_pad"])
    syn_z = 1.0 - 2.0 * _pad(syndrome_z.to(torch.float32), sz["c_pad"])
    msg_x = torch.zeros((sx["dv"], g.n_pad, b), dtype=torch.float32, device=dev)
    msg_z = torch.zeros((sz["dv"], g.n_pad, b), dtype=torch.float32, device=dev)

    def marg(mx, mz):
        s_z, s_x = mz.sum(dim=0), mx.sum(dim=0)
        return s_z + llr_ch[0], s_x + s_z + llr_ch[1], s_x + llr_ch[2]

    def to_cn(msg, side):
        flat = msg.reshape(side["dv"] * g.n_pad, -1)
        return flat[side["cn_gather"]].reshape(side["dc"], side["c_pad"], -1)

    def to_vn(msg, side):
        flat = msg.reshape(side["dc"] * side["c_pad"], -1)
        return flat[side["vn_gather"]].reshape(side["dv"], g.n_pad, -1)

    xs, zs = [], []
    for _ in range(num_iter):
        llrx, llry, llrz = marg(msg_x, msg_z)
        ex = lambda v, s: v[None].expand((s["dv"],) + tuple(v.shape))  # noqa: E731
        new_x = ex(softplus(-llrx), sx) - _lse2(-(ex(llrz, sx) - msg_x), -(ex(llry, sx) - msg_x))
        new_z = ex(softplus(-llrz), sz) - _lse2(-(ex(llrx, sz) - msg_z), -(ex(llry, sz) - msg_z))
        if collect_logits:
            x_logit, z_logit = check_logits(llrx, llry, llrz, g)
            xs.append(x_logit)
            zs.append(z_logit)
        msg_x = to_vn(_cn_phi(to_cn(new_x, sx), syn_x, sx["cn_mask"]) * factor, sx)
        msg_z = to_vn(_cn_phi(to_cn(new_z, sz), syn_z, sz["cn_mask"]) * factor, sz)
    llrx, llry, llrz = marg(msg_x, msg_z)
    if not collect_logits:
        return (llrx, llry, llrz), None
    x_logit, z_logit = check_logits(llrx, llry, llrz, g)
    return (llrx, llry, llrz), (torch.stack(xs + [x_logit]), torch.stack(zs + [z_logit]))


def _bce(labels, logits, row_valid):
    elem = clip(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return (elem * row_valid[:, None]).sum() / (row_valid.sum() * elem.shape[1])


def loss_terms(logit_stack, syndrome_x, syndrome_z, g: Graph, num_iter: int, loss_from: int):
    """The deep-supervision loss: x logits predict 1 - (hz syndrome), z
    logits 1 - (hx syndrome), iterations loss_from+1 .. num_iter."""
    xs, zs = logit_stack
    gt_x = 1.0 - _pad(syndrome_z.to(torch.float32), xs.shape[1])
    gt_z = 1.0 - _pad(syndrome_x.to(torch.float32), zs.shape[1])
    loss = 0.0
    for i in range(loss_from + 1, num_iter + 1):
        loss = (loss + _bce(gt_x, xs[i], g.rows["x"]["row_valid"])
                + _bce(gt_z, zs[i], g.rows["z"]["row_valid"]))
    return loss


def load_gnn(path: str, device):
    """GNN parameters from an ``.npz`` of the published layout
    (``llr_inv_embed/kernel``, ``msg_mlp_x/0/kernel``, ...)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: np.asarray(data[k], np.float32) for k in data.files}
    tree = {}
    for key, a in arrays.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.tensor(a, device=device)
    return {
        "llr_inv_embed": tree["llr_inv_embed"],
        **{k: [tree[k][str(i)] for i in range(len(tree[k]))]
           for k in ("msg_mlp_x", "msg_mlp_z", "embed_mlp")},
    }
