"""GNN_BP4, the fully-learned GNN decoder, plain PyTorch: the reference for
the program's GNN_BP4 step.

The decoder is ``GNN_BP4`` of the TF original (``sionna/fec/ldpc/gnn.py``
of gongaa/Feedback-GNN, the code of arXiv:2310.17758), which builds on the
GNN decoder of Cammerer et al., arXiv:2207.14742.  It is written here from
its definition over the edge lists of hx and hz, independent of the
program's padded slot layout:

* state: an embedding of ``num_embed_dims`` per VN (ones at the start) and
  per CN of each side (zeros at the start);
* messages: a per-edge MLP (``num_mlp_layers`` dense layers, the hidden
  ones of ``num_hidden_units`` with the activation, the last linear, no
  bias) on the concatenated endpoint embeddings, the sending node's first;
  a VN update's messages from side s are signed by +1 / -1 for the
  syndrome bit 0 / 1 of their CN;
* aggregation: the mean over a node's edges (``index_add_`` over the edge
  list, divided by the node's degree);
* VN update: embed MLP on [mean of the x messages, mean of the z messages,
  the VN's embedding]; CN update of side s: embed MLP on [mean of the
  messages, the CN's embedding, the side's check logit times its syndrome
  sign] (zero logits in the first CN update);
* logits: ``llr_inv_embed`` (20 -> 3, with a bias) maps each VN embedding to
  (llrx, llry, llrz); the binary LLRs llr_x = log((pI + pZ)/(pX + pY)) and
  llr_z = log((pI + pX)/(pZ + pY)); boxplus (gnn_bp.py's phi and clips)
  over the rows of [hz; lz] on llr_x and of [hx; lx] on llr_z;
* schedule: one CN update, then ``num_iter`` times {VN update, logits,
  CN update from the hx and hz logits}, the last CN update left out since
  nothing reads it; decisions by the argmin over (0, llrx, llrz, llry) of
  the last LLRs (first minimum on ties).

``check_batch`` holds one Monte-Carlo batch of the program to this
reference: the noise and the syndromes, every update of the decode from the
program's own states before it, the decisions and the counts (see there).

The logical rows lx and lz are those of the published construction (the
``compute_lz`` of the TF original's code module, after Panteleev &
Kalachev's ``bposd``): for lz, the rows of the stack [a row basis of hz;
the kernel basis of hx] that are pivots of its transpose's echelon form and
lie in the kernel block; the kernel basis is the lower rows of the
transform that brings hx^T to echelon form, and a row basis of h is the
rows at the pivot columns of h^T's echelon form, both by elimination
without column swaps that swaps up the first row below holding a one.

Departures from gnn.py: its ``call`` unpacks five values from ``cal_logit``,
which returns four (gnn.py:408); the loop here takes the hx and hz logits
and the perp logits as the JAX package and the program do.  Everything is
float32 with TF32 off.  The network is applied per sample, so a batch may
be decoded in blocks of samples.
"""

from __future__ import annotations

import numpy as np
import torch

from .cascade import _mod2, _Tally, sample_channel
from .codes import rowset
from .gnn_bp import _boxplus_rows, _lse2, hard_decision, softplus

__all__ = ["echelon", "logicals", "Net", "load_net", "decode", "check_batch", "BLOCK"]

BLOCK = 1024  # samples per block of the reference's updates


def echelon(mat):
    """(rank, transform, pivot columns) of the echelon form of a binary
    matrix by elimination without column swaps: at each column, where the
    pivot row holds a zero, the first row below holding a one swaps up; its
    one is then cleared from every row below."""
    m = np.asarray(mat, np.uint8).copy() & 1
    rows, cols = m.shape
    t = np.eye(rows, dtype=np.uint8)
    r, pivots = 0, []
    for c in range(cols):
        if not m[r, c]:
            below = np.flatnonzero(m[r:, c])
            if below.size:
                s = r + below[0]
                m[[r, s]], t[[r, s]] = m[[s, r]], t[[s, r]]
        if m[r, c]:
            sel = np.flatnonzero(m[r + 1:, c]) + r + 1
            m[sel] ^= m[r]
            t[sel] ^= t[r]
            r += 1
            pivots.append(c)
        if r >= rows:
            break
    return r, t, pivots


def logicals(hx, hz):
    """(lx, lz) of the published construction (module docstring)."""

    def kernel_and_basis(h):
        rank, t, piv = echelon(np.asarray(h).T)
        return t[rank:], np.asarray(h)[piv]

    ker_hx, basis_hx = kernel_and_basis(hx)
    ker_hz, basis_hz = kernel_and_basis(hz)

    def ops(ker, basis):
        stack = np.vstack([basis, ker]).astype(np.uint8)
        piv = set(echelon(stack.T)[2])
        return stack[[i for i in range(len(basis), len(stack)) if i in piv]].astype(np.int64)

    return ops(ker_hz, basis_hx), ops(ker_hx, basis_hz)


class Net:
    """The code's edge lists, logit rows and degrees, and the network's
    layers, as tensors on one device."""

    def __init__(self, code, layers, widths, device):
        self.widths = dict(widths)
        self.layers = layers
        self.n = code.n
        self.device = device
        lx, lz = logicals(code.hx, code.hz)
        self.lx, self.lz = lx, lz
        self.sides = {}
        for side, h in (("x", code.hx), ("z", code.hz)):
            cn, vn = np.nonzero(np.asarray(h))
            t = lambda a, dt=torch.int64: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
            self.sides[side] = dict(
                m=h.shape[0], cn=t(cn), vn=t(vn),
                deg_cn=t(np.bincount(cn, minlength=h.shape[0]), torch.float32).clamp_min(1.0),
                deg_vn=t(np.bincount(vn, minlength=code.n), torch.float32).clamp_min(1.0))
        # the logits of llr_x over [hz; lz], of llr_z over [hx; lx]
        self.rows = {}
        for name, stack in (("x", np.vstack([code.hz, lz])), ("z", np.vstack([code.hx, lx]))):
            rs = rowset(stack)
            self.rows[name] = dict(num=rs.num_rows, vn_idx=torch.as_tensor(rs.vn_idx, device=device),
                                   mask=torch.as_tensor(rs.mask, device=device))


def load_net(code, path, widths, device) -> Net:
    """The network of an ``.npz`` of the published layout
    (``vn_msg_mlp_x/0/kernel``, ``llr_inv_embed/bias``, ...) on the code,
    its shapes held to the configuration's ``widths``."""
    if widths.get("reduce_op", "mean") != "mean" or widths.get("use_bias", False):
        raise ValueError(f"the reference is the mean-aggregating GNN_BP4 without MLP biases, not {dict(widths)}")
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: torch.tensor(np.asarray(data[k], np.float32), device=device) for k in data.files}
    e, msg, hid = int(widths["num_embed_dims"]), int(widths["num_msg_dims"]), int(widths["num_hidden_units"])
    depth = int(widths["num_mlp_layers"])
    fan_in = {"cn_msg_mlp_x": 2 * e, "cn_msg_mlp_z": 2 * e, "vn_msg_mlp_x": 2 * e, "vn_msg_mlp_z": 2 * e,
              "cn_embed_mlp_x": msg + e + 1, "cn_embed_mlp_z": msg + e + 1, "vn_embed_mlp": 2 * msg + e}
    fan_out = {k: msg if "_msg_" in k else e for k in fan_in}
    layers = {}
    for name, fi in fan_in.items():
        dims = [fi] + [hid] * (depth - 1) + [fan_out[name]]
        layers[name] = []
        for i in range(depth):
            w = arrays.pop(f"{name}/{i}/kernel")
            if tuple(w.shape) != (dims[i], dims[i + 1]):
                raise ValueError(f"{name}/{i}/kernel is {tuple(w.shape)}, the widths give {(dims[i], dims[i + 1])}")
            layers[name].append((w, None))
    w, b = arrays.pop("llr_inv_embed/kernel"), arrays.pop("llr_inv_embed/bias")
    if tuple(w.shape) != (e, 3) or tuple(b.shape) != (3,):
        raise ValueError(f"llr_inv_embed is {tuple(w.shape)} + {tuple(b.shape)}, the widths give ({e}, 3) + (3,)")
    layers["llr_inv_embed"] = [(w, b)]
    if arrays:
        raise ValueError(f"{path} holds parameters the network has no place for: {sorted(arrays)}")
    return Net(code, layers, widths, device)


def _act(name):
    return {"relu": torch.relu, "tanh": torch.tanh}[name]


def _mlp(x, layers, act):
    """Dense layers on the last axis, the activation after each but the last."""
    for i, (w, b) in enumerate(layers):
        x = x @ w
        if b is not None:
            x = x + b
        if i < len(layers) - 1:
            x = act(x)
    return x


def _mean_at(msg, index, count, deg):
    """Per node the mean of the messages [S, E, d] of its edges."""
    out = torch.zeros((msg.shape[0], count, msg.shape[2]), dtype=msg.dtype, device=msg.device)
    return out.index_add_(1, index, msg) / deg[None, :, None]


def _vn_update(net, h_vn, h_cn, sign, act):
    red = []
    for side in ("x", "z"):
        s = net.sides[side]
        feat = torch.cat([h_cn[side][:, s["cn"]], h_vn[:, s["vn"]]], dim=-1)  # from the CN, to the VN
        msg = _mlp(feat, net.layers[f"vn_msg_mlp_{side}"], act) * sign[side][:, s["cn"], None]
        red.append(_mean_at(msg, s["vn"], net.n, s["deg_vn"]))
    return _mlp(torch.cat([red[0], red[1], h_vn], dim=-1), net.layers["vn_embed_mlp"], act)


def _cn_update(net, h_vn, h_cn, logit, act):
    out = {}
    for side in ("x", "z"):
        s = net.sides[side]
        feat = torch.cat([h_vn[:, s["vn"]], h_cn[side][:, s["cn"]]], dim=-1)  # from the VN, to the CN
        msg = _mlp(feat, net.layers[f"cn_msg_mlp_{side}"], act)
        red = _mean_at(msg, s["cn"], s["m"], s["deg_cn"])
        out[side] = _mlp(torch.cat([red, h_cn[side], logit[side][..., None]], dim=-1),
                         net.layers[f"cn_embed_mlp_{side}"], act)
    return out


def _logits(net, h_vn):
    """(llrx, llry, llrz) [S, n] and the perp logits {x: [hz; lz] rows, z:
    [hx; lx] rows}, each [rows, S]."""
    emb = _mlp(h_vn, net.layers["llr_inv_embed"], None)
    llrx, llry, llrz = emb[..., 0], emb[..., 1], emb[..., 2]
    llr_z = softplus(-llrx) - _lse2(-llrz, -llry)
    llr_x = softplus(-llrz) - _lse2(-llrx, -llry)
    perp = {}
    for side, v in (("x", llr_x), ("z", llr_z)):
        padded = torch.cat([v.T, torch.zeros_like(v[:, :1]).T], dim=0)  # the pad row n is zero
        perp[side] = _boxplus_rows(padded, net.rows[side])[:net.rows[side]["num"]]
    return (llrx, llry, llrz), perp


def decode(net: Net, syndrome_x, syndrome_z):
    """Decode samples from their syndromes [mx, S], [mz, S] (0/1).  Returns
    (perp, llrs, (x_hat, z_hat)): per iteration (x_perp [mz + kz, S],
    z_perp [mx + kx, S]); the last (llrx, llry, llrz) [n, S]; int32
    decisions [n, S]."""
    act = _act(net.widths["activation"])
    e = int(net.widths["num_embed_dims"])
    sign = {"x": 1.0 - 2.0 * syndrome_x.T.to(torch.float32), "z": 1.0 - 2.0 * syndrome_z.T.to(torch.float32)}
    s_count = sign["x"].shape[0]
    dev = sign["x"].device
    h_vn = torch.ones((s_count, net.n, e), device=dev)
    h_cn = {side: torch.zeros((s_count, net.sides[side]["m"], e), device=dev) for side in ("x", "z")}
    h_cn = _cn_update(net, h_vn, h_cn, {side: torch.zeros_like(sign[side]) for side in ("x", "z")}, act)
    perp = []
    iters = int(net.widths["num_iter"])
    for i in range(iters):
        h_vn = _vn_update(net, h_vn, h_cn, sign, act)
        llrs, rows = _logits(net, h_vn)
        perp.append((rows["x"], rows["z"]))
        if i < iters - 1:
            mx, mz = net.sides["x"]["m"], net.sides["z"]["m"]
            # the hx logits are the first mx rows of z_perp, the hz logits the first mz of x_perp
            h_cn = _cn_update(net, h_vn, h_cn, {"x": rows["z"][:mx].T * sign["x"],
                                                "z": rows["x"][:mz].T * sign["z"]}, act)
    llrs = tuple(v.T for v in llrs)
    return perp, llrs, hard_decision(*llrs)


def _sample_major(h, rows):
    """A program state [d, rows_pad, S] as the reference's [S, rows, d]."""
    return h[:, :rows].permute(2, 1, 0)


def check_batch(net: Net, code, p: float, batch: int, seed_word: int, capture: dict):
    """Readings of one captured batch: {"mismatches", "llr_gap", "notes"}.

    ``capture``: "noise" (noise_x, noise_z) [n, B] and "syndromes" (x, z)
    [rows, B] as the program sampled and computed them (rows past the
    code's are padding and must be 0); "llrs" the last (llrx, llry, llrz)
    [n, B] and "decisions" (x_hat, z_hat) [n, B]; "counts" (flagged,
    logical) as the step returned them; and on the samples ``cols`` (a
    subset of the batch), every state the decode computed: "cn" per CN
    update (h_cn_x [e, mx, S], h_cn_z), "vn" per VN update h_vn [e, n, S],
    "perp" per logits (x_perp [mz + kz, S], z_perp [mx + kx, S]).

    The decode is held to the reference step by step, each update computed
    from the program's own states before it (a float32 network run for
    eight iterations turns last-bit differences of summation order into
    gaps of order 1 by the end, so the end-to-end logits of two correct
    float32 programs are not comparable; each step's are):

    * ``llr_gap``: the widest |program - reference| / max(|reference|, 1)
      over each CN update's and VN update's embeddings, each iteration's
      perp logits L as tanh(L/2) and the last LLRs, on ``cols``.  The
      logits are compared in the boxplus's own domain, tanh(L/2): phi's
      expm1 form computes a reliable row's |L| of 10 to 16.6 from phi(|v|)
      of its LLRs, each the difference of two float32 numbers near |v|, so
      its last bits, which two float32 programs round apart, move such an
      L by up to 1.5 while tanh(L/2) moves by a few 1e-6;
    * ``mismatches``: noise and syndrome bits, a count of updates other
      than the configuration's, decisions other than the argmin of the
      program's own last LLRs, and the counts against a recount from the
      program's own decisions (a sample is flagged where its residual
      meets a check, a logical error where it is not orthogonal to the
      kernel of the other side's checks)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products throughout
    torch.backends.cudnn.allow_tf32 = False
    t = _Tally()
    widest = [0.0, None]

    def gap(what, prog, ref):
        t.gap(what, prog, ref)
        if t.llr_gap > widest[0]:
            widest[:] = [t.llr_gap, what]

    dev = net.device
    n, mx, mz = code.n, net.sides["x"]["m"], net.sides["z"]["m"]
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    hx, hz, kx, kz = f(code.hx), f(code.hz), f(code.ker_hx), f(code.ker_hz)
    nx, nz = sample_channel(n, batch, p, seed_word, dev)
    pnx, pnz = (v.to(torch.bool) for v in capture["noise"])
    t.exact("noise x", pnx, nx)
    t.exact("noise z", pnz, nz)
    syn_x, syn_z = _mod2(hx, nz), _mod2(hz, nx)
    for name, prog, want in (("x", capture["syndromes"][0], syn_x), ("z", capture["syndromes"][1], syn_z)):
        prog = prog.to(torch.int32)
        t.exact(f"syndrome {name}", prog[:len(want)], want)
        t.exact(f"syndrome {name} padding", prog[len(want):], torch.zeros_like(prog[len(want):]))

    # every update from the program's own states, on the captured samples
    iters = int(net.widths["num_iter"])
    cn, vn, perp = capture["cn"], capture["vn"], capture["perp"]
    if (len(cn), len(vn), len(perp)) != (iters, iters, iters):
        t.mismatches += 1
        t.notes.append(f"{len(cn)} CN updates, {len(vn)} VN updates, {len(perp)} logits: expected {iters} each")
    else:
        act = _act(net.widths["activation"])
        cols = capture["cols"]
        for s in range(0, len(cols), BLOCK):
            blk = slice(s, s + BLOCK)
            c = cols[blk]
            sign = {"x": 1.0 - 2.0 * syn_x[:, c].T.to(torch.float32), "z": 1.0 - 2.0 * syn_z[:, c].T.to(torch.float32)}
            h_cn = [{"x": _sample_major(x[..., blk], mx), "z": _sample_major(z[..., blk], mz)} for x, z in cn]
            h_vn = [_sample_major(v[..., blk], n) for v in vn]
            e = h_vn[0].shape[-1]
            ones = torch.ones((len(c), n, e), device=dev)
            zeros = {side: torch.zeros((len(c), net.sides[side]["m"], e), device=dev) for side in ("x", "z")}
            want = _cn_update(net, ones, zeros, {side: torch.zeros_like(sign[side]) for side in ("x", "z")}, act)
            for i in range(iters):
                for side in ("x", "z"):
                    gap(f"CN update {i} h_cn_{side}", h_cn[i][side], want[side])
                gap(f"VN update {i} h_vn", h_vn[i], _vn_update(net, ones if i == 0 else h_vn[i - 1], h_cn[i],
                                                                  sign, act))
                llrs, rows = _logits(net, h_vn[i])
                for side, prog in zip("xz", perp[i]):
                    gap(f"logits {i} {side}_perp, tanh(L/2)", torch.tanh(0.5 * prog[..., blk].to(torch.float32)),
                          torch.tanh(0.5 * rows[side]))
                if i < iters - 1:
                    # the next CN update takes the program's hx and hz logits, times the syndrome signs
                    logit = {"x": perp[i][1][:mx, blk].T * sign["x"], "z": perp[i][0][:mz, blk].T * sign["z"]}
                    want = _cn_update(net, h_vn[i], h_cn[i], logit, act)
            for name, prog, ref in zip(("llrx", "llry", "llrz"), capture["llrs"], llrs):
                gap(f"last {name}", prog[:, c].to(torch.float32), ref.T)

    # the decisions and counts, from the program's own LLRs and decisions, on the whole batch
    px, pz = (v.to(torch.int32) for v in capture["decisions"])
    rx, rz = hard_decision(*(v.to(torch.float32) for v in capture["llrs"]))
    t.exact("decisions x", px, rx)
    t.exact("decisions z", pz, rz)
    dx, dz = pnx.to(torch.int32) ^ px, pnz.to(torch.int32) ^ pz
    flagged = (_mod2(hz, dx) != 0).any(dim=0) | (_mod2(hx, dz) != 0).any(dim=0)
    logical = (_mod2(kx, dx) != 0).any(dim=0) | (_mod2(kz, dz) != 0).any(dim=0)
    want = torch.stack([flagged.sum(), logical.sum()]).to(torch.int64)
    counts = torch.stack([torch.as_tensor(c, device=dev).reshape(()) for c in capture["counts"][:2]])
    t.exact("counts (flagged, logical)", counts.to(torch.int64), want)
    if widest[1] is not None:
        t.notes.append(f"widest gap {widest[0]:.3g} at {widest[1]}")
    return {"mismatches": t.mismatches, "llr_gap": t.llr_gap, "notes": t.notes}
