"""Quaternary syndrome BP (BP4) on the edge lists of hx and hz, plain
PyTorch: the reference for the program's gather BP4 decode
(``cli/osd_eval.py --mode bp4``).

The decoder is the TF original's ``QLDPCBPDecoder`` in its flooding BP4
form, as the JAX package's gather decoder has it.  It is written here from
its definition on the true edges of each check matrix, apart from the
program's padded slot layout:

* messages: ``msg_x[e]`` on each edge of hx (a belief about the Z
  component of the error at the edge's qubit), ``msg_z[e]`` on each edge of
  hz (about the X component); zero at the start;
* marginals: s_x[v], s_z[v] the sums of a qubit's hx and hz messages
  (``index_add_`` over the edges); llrx = s_z + L_x, llry = s_x + s_z +
  L_y, llrz = s_x + L_z, with the channel LLRs L = log(3 (1 - p) / p)
  each;
* VN update, Y-coupled in log space: msg_x'[e] = softplus(-llrx) -
  lse(-(llrz - msg_x[e]), -(llry - msg_x[e])) at the edge's qubit, and
  msg_z'[e] = softplus(-llrz) - lse(-(llrx - msg_z[e]), -(llry - msg_z[e]));
* CN update, boxplus-phi with the syndrome sign: at check c the phi-sum
  S_c of phi(|m|) over its edges (``index_add_``), out[e] = sign_e
  phi(S_c - phi(|m_e|)), sign_e = -1 to the number of negative inputs
  among the other edges plus the syndrome bit (sign(0) = +1); phi(x) =
  softplus(x) - log(expm1(x)), input and output clipped to [8.5e-8,
  16.635532] (gnn_bp.py);
* flooding: ``num_iter`` times {VN update, CN update of both sides}, then
  the marginals of the last messages; decisions by the argmin over (0,
  llrx, llrz, llry), first minimum on ties.

Float32 throughout, TF32 off.  Every operation is per sample, so a batch
may be split into blocks of samples.

The program keeps messages slot-major, [slots, nodes, B], with zero pad
slots; ``Side`` reads its tensors by the published layout's convention
(codes.py: edges in VN-major order, a VN's slots in increasing CN order, a
CN's slots in increasing VN order, node counts padded to ``_aligned``).

``check_batch`` holds one Monte-Carlo batch of the program to this
reference stage by stage (see there): BP on a sample that has not
converged is chaotic, so the decode is not compared end to end.
"""

from __future__ import annotations

import numpy as np
import torch

from .cascade import _mod2, _Tally, sample_channel
from .codes import _aligned
from .gnn_bp import _lse2, hard_decision, phi, softplus

__all__ = ["Side", "sides_of", "prior", "marginals", "vn_update", "cn_update", "check_vn", "check_cn",
           "check_batch", "BLOCK"]

BLOCK = 256  # captured samples per block of the check


class Side:
    """The true edges of one check matrix on a device: ``cn``, ``vn`` [E]
    in VN-major order, and each edge's slot in the program's VN frame
    [dv, n_pad] (``vslot``) and CN frame [dc, c_pad] (``cslot``)."""

    def __init__(self, h: np.ndarray, device):
        h = np.asarray(h)
        self.num_cn, self.num_vn = h.shape
        cn, vn = np.nonzero(h)
        order = np.lexsort((cn, vn))
        cn, vn = cn[order], vn[order]
        vslot, cslot = np.zeros(len(cn), np.int64), np.zeros(len(cn), np.int64)
        vfill, cfill = np.zeros(self.num_vn, np.int64), np.zeros(self.num_cn, np.int64)
        for e in range(len(cn)):
            vslot[e], cslot[e] = vfill[vn[e]], cfill[cn[e]]
            vfill[vn[e]] += 1
            cfill[cn[e]] += 1
        self.num_edges = len(cn)
        self.dv, self.dc = int(vfill.max()), int(cfill.max())
        self.n_pad, self.c_pad = _aligned(self.num_vn), _aligned(self.num_cn)
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.cn, self.vn, self.vslot, self.cslot = t(cn), t(vn), t(vslot), t(cslot)
        self.vn_pad = torch.ones((self.dv, self.n_pad), dtype=torch.bool, device=device)
        self.vn_pad[self.vslot, self.vn] = False
        self.cn_pad = torch.ones((self.dc, self.c_pad), dtype=torch.bool, device=device)
        self.cn_pad[self.cslot, self.cn] = False

    def from_vn_frame(self, t):
        """[E, S] of a program tensor [dv, n_pad, S] in the VN frame."""
        return t[self.vslot, self.vn]

    def from_cn_frame(self, t):
        """[E, S] of a program tensor [dc, c_pad, S] in the CN frame."""
        return t[self.cslot, self.cn]

    def pads_set(self, t, frame):
        """Count of nonzero pad slots of a program tensor in the ``vn`` or
        ``cn`` frame (a 0-d tensor; no host sync)."""
        pad = self.vn_pad if frame == "vn" else self.cn_pad
        return ((t != 0) & pad[..., None]).sum()  # a mask, not a boolean index, which would sync


def sides_of(code, device) -> dict:
    """{"x": Side(hx), "z": Side(hz)} of a ``codes.Code``."""
    return {"x": Side(code.hx, device), "z": Side(code.hz, device)}


def prior(p: float, n: int, s: int, device):
    """Channel LLRs [3, n, s]: log(3 (1 - p) / p) for x, y and z."""
    val = torch.log(torch.tensor(3.0 * (1.0 - p) / p, dtype=torch.float32, device=device))
    return val.expand(3, n, s).clone()


def _sums(msg, side):
    out = torch.zeros((side.num_vn, msg.shape[-1]), dtype=torch.float32, device=msg.device)
    return out.index_add_(0, side.vn, msg)


def marginals(msg_x, msg_z, llr, sides):
    """(llrx, llry, llrz) [n, S] from edge messages [E, S] of each side and
    channel LLRs [3, n, S]."""
    s_x, s_z = _sums(msg_x, sides["x"]), _sums(msg_z, sides["z"])
    return s_z + llr[0], s_x + s_z + llr[1], s_x + llr[2]


def vn_update(llrx, llry, llrz, msg_x, msg_z, sides):
    """The extrinsic messages {"x", "z"} [E, S] of the marginals [n, S] and
    the messages into the update."""
    vx, vz = sides["x"].vn, sides["z"].vn
    new_x = softplus(-llrx)[vx] - _lse2(-(llrz[vx] - msg_x), -(llry[vx] - msg_x))
    new_z = softplus(-llrz)[vz] - _lse2(-(llrx[vz] - msg_z), -(llry[vz] - msg_z))
    return {"x": new_x, "z": new_z}


def cn_update(msg, syn_pm, side):
    """Boxplus-phi CN outputs [E, S] of the messages into the checks [E, S]
    and the syndrome signs +-1 [m, S]."""
    s = msg.shape[-1]
    p = phi(msg.abs())
    total = torch.zeros((side.num_cn, s), dtype=torch.float32, device=msg.device).index_add_(0, side.cn, p)
    neg = (msg < 0).to(torch.int32)
    count = torch.zeros((side.num_cn, s), dtype=torch.int32, device=msg.device).index_add_(0, side.cn, neg)
    sign = torch.where((count[side.cn] - neg) % 2 == 1, -1.0, 1.0) * syn_pm[side.cn]
    return sign * phi(total[side.cn] - p)


class _Widest(_Tally):
    """The tally, and where its widest gap was read."""

    def __init__(self):
        super().__init__()
        self.at = None

    def gap(self, what, prog, ref, keep=None):
        before = self.llr_gap
        super().gap(what, prog, ref, keep)
        if self.llr_gap > before:
            self.at = what

    def widen(self, what, g):
        """Take the widest of gaps ``g`` computed elsewhere."""
        if g.numel() and float(g.max()) > self.llr_gap:
            self.llr_gap, self.at = float(g.max()), what


def check_vn(t: "_Widest", what, sides, llr, msg_in, marg, msg_out):
    """A VN update of the program, stage by stage: its marginals (``marg``,
    (llrx, llry, llrz) [n, S]) against the sums of the messages into it
    (``msg_in``, {"x", "z"} [E, S]) and the channel LLRs [3, n, S]; its
    extrinsic messages (``msg_out``) against those of its own marginals.

    A marginal sums up to 261 messages of up to 16.6 each; two sound
    float32 sums in other orders differ by a few ulps of their partial
    sums, which is a relative gap of 1e-4 and more where the terms cancel
    to a small marginal (3e-5 on the CPU at iteration 1).  So a marginal's
    gap is taken relative to the larger of |reference|, 1 and the sum of
    the magnitudes it adds (|L| and every |message|): the scale of a
    float32 sum's rounding.  A message counted once too often or left out
    moves it by 1/261 of that scale or more.  The extrinsics, from the
    program's own marginals, repeat its elementwise arithmetic."""
    ref = marginals(msg_in["x"], msg_in["z"], llr, sides)
    mag = marginals(msg_in["x"].abs(), msg_in["z"].abs(), llr.abs(), sides)
    for name, prog, want, scale in zip(("llrx", "llry", "llrz"), marg, ref, mag):
        w = scale.clamp_min(1.0)
        t.gap(f"{what} {name}", prog / w, want / w)
    ref = vn_update(*marg, msg_in["x"], msg_in["z"], sides)
    for k in sides:
        t.gap(f"{what} msg_{k}", msg_out[k], ref[k])


def check_cn(t: "_Widest", what, side, msg_in, syn_pm, msg_out):
    """A CN update of the program: its outputs' signs exactly, and their
    magnitudes against this reference's outputs from the same messages into
    it [E, S] and syndrome signs [m, S], each output in the better
    conditioned of its two forms: the smaller of the gaps of |m| and of
    phi(|m|), each relative to max(|reference|, 1).

    An output is m = phi(x) of its extrinsic phi-sum x = S - phi(|m_e|),
    and phi(|m|) = x (phi is its own inverse).  Two sound float32 sums of
    another order give x an ulp of S apart: where x is small (a reliable
    output of 10 to 16.6) that moves m by up to 0.4, while x moves by 1e-6;
    where x is large (an output below 1e-3), phi's expm1 form computes m
    to about 1 % (its float32 staircase: an ulp of x moves m by one step),
    which moves phi(|m|) by 1e-3 relative, while m moves by 1e-6.  A
    bfloat16 carry moves both forms by about 2e-3 to 4e-3 near |m| = 1."""
    ref = cn_update(msg_in, syn_pm, side)
    t.exact(f"{what} signs", msg_out < 0, ref < 0)
    t.widen(f"{what} |m| or phi(|m|)", torch.minimum(_rel(msg_out.abs(), ref.abs()),
                                                     _rel(phi(msg_out.abs()), phi(ref.abs()))))


def _rel(prog, ref):
    g = (prog - ref).abs() / ref.abs().clamp_min(1.0)
    return torch.where(torch.isnan(g), torch.inf, g)


def check_batch(sides, code, p: float, batch: int, seed_word: int, capture: dict, num_iter: int):
    """Readings of one captured batch: {"mismatches", "llr_gap", "notes"}.

    ``capture``: "noise" (noise_x, noise_z) [n, B] and "syndromes" (x, z)
    [c_pad, B] as the program sampled and computed them, "llr" the decode's
    input [3, n_pad, B], "final" its last marginals (llrx, llry, llrz) and
    "decisions" (x_hat, z_hat) [n_pad, B], "counts" (flagged, logical) as
    the step returned them, "updates" the decode's (VN updates, CN
    updates of hx, CN updates of hz); on the samples "cols" of the batch, "iters" {iteration:
    {"vn_in": {"x", "z"} [E, S] or None, "marg": (llrx, llry, llrz) [n, S],
    "vn_out": {"x", "z"}, "cn_out": {"x", "z"}}}, and "exact" [(what, count)]
    of what the capture compared as it ran (nonzero pad slots, a CN update's
    input other than the VN update's output, a VN update's input other than
    the last CN update's output).

    * ``mismatches``: noise and syndrome bits, input LLRs other than the
      prior, a count of updates other than ``num_iter`` each, the capture's
      counts, CN output signs, decisions other than the argmin of the
      program's own last marginals, and the counts against a recount from
      its own decisions (a sample is flagged where its residual meets a
      check, a logical error where it is not orthogonal to the kernel of
      the other side's checks);
    * ``llr_gap``: the widest |program - reference| / max(|reference|, 1)
      over each captured VN update (check_vn: the marginals relative to
      the magnitudes they sum) and CN update (check_cn: |m| or phi(|m|)), each
      from the program's own input to it, and the last marginals (as
      check_vn's) from the program's own last messages, on ``cols``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products throughout
    torch.backends.cudnn.allow_tf32 = False
    t = _Widest()
    dev = sides["x"].cn.device
    n = code.n
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    hx, hz, kx, kz = f(code.hx), f(code.hz), f(code.ker_hx), f(code.ker_hz)
    nx, nz = sample_channel(n, batch, p, seed_word, dev)
    pnx, pnz = (v.to(torch.bool) for v in capture["noise"])
    t.exact("noise x", pnx, nx)
    t.exact("noise z", pnz, nz)
    syn = {"x": _mod2(hx, nz), "z": _mod2(hz, nx)}
    for k in "xz":
        prog, want = capture["syndromes"]["xz".index(k)].to(torch.int32), syn[k]
        t.exact(f"syndrome {k}", prog[:len(want)], want)
        t.exact(f"syndrome {k} padding", prog[len(want):], torch.zeros_like(prog[len(want):]))
    llr = capture["llr"].to(torch.float32)
    t.exact("input LLRs", llr[:, :n], prior(p, n, batch, dev))
    t.exact("input LLRs padding", llr[:, n:], torch.zeros_like(llr[:, n:]))
    for what, count in capture["exact"]:
        if int(count):
            t.mismatches += int(count)
            t.notes.append(f"{what}: {int(count)} differ")

    cols = capture["cols"]
    if tuple(capture["updates"]) != (num_iter,) * 3:
        t.mismatches += 1
        t.notes.append("{} VN updates, {} and {} CN updates of hx and hz: expected {} each".format(
            *capture["updates"], num_iter))
    else:
        its = capture["iters"]
        for s in range(0, len(cols), BLOCK):
            blk = slice(s, s + BLOCK)
            c_b = cols[blk]
            l_c = llr[:, :n, c_b]
            syn_pm = {k: 1.0 - 2.0 * syn[k][:, c_b].to(torch.float32) for k in "xz"}
            sl = lambda d: {k: v[..., blk] for k, v in d.items()}  # noqa: E731
            for i in sorted(its):
                c = its[i]
                msg_in = sl(c["vn_in"]) if c["vn_in"] is not None else (
                    sl(its[i - 1]["cn_out"]) if i > 0 else {k: torch.zeros_like(v[..., blk])
                                                            for k, v in c["vn_out"].items()})
                vn_out, cn_out = sl(c["vn_out"]), sl(c["cn_out"])
                check_vn(t, f"VN update {i}", sides, l_c, msg_in, tuple(v[..., blk] for v in c["marg"]), vn_out)
                for k in "xz":
                    check_cn(t, f"CN update {i} side {k}", sides[k], vn_out[k], syn_pm[k], cn_out[k])
            last = sl(its[num_iter - 1]["cn_out"])
            ref = marginals(last["x"], last["z"], l_c, sides)
            mag = marginals(last["x"].abs(), last["z"].abs(), l_c.abs(), sides)
            for name, prog, want, scale in zip(("llrx", "llry", "llrz"), capture["final"], ref, mag):
                w = scale.clamp_min(1.0)
                t.gap(f"last {name}", prog[:n, c_b].to(torch.float32) / w, want / w)

    # the decisions and counts, from the program's own marginals and decisions, on the whole batch
    px, pz = (v[:n].to(torch.int32) for v in capture["decisions"])
    rx, rz = hard_decision(*(v[:n].to(torch.float32) for v in capture["final"]))
    t.exact("decisions x", px, rx)
    t.exact("decisions z", pz, rz)
    dx, dz = pnx.to(torch.int32) ^ px, pnz.to(torch.int32) ^ pz
    flagged = (_mod2(hz, dx) != 0).any(dim=0) | (_mod2(hx, dz) != 0).any(dim=0)
    logical = (_mod2(kx, dx) != 0).any(dim=0) | (_mod2(kz, dz) != 0).any(dim=0)
    want = torch.stack([flagged.sum(), logical.sum()]).to(torch.int64)
    counts = torch.stack([torch.as_tensor(c, device=dev).reshape(()) for c in capture["counts"][:2]])
    t.exact("counts (flagged, logical)", counts.to(torch.int64), want)
    if t.at is not None:
        t.notes.append(f"widest gap {t.llr_gap:.3g} at {t.at}")
    return {"mismatches": t.mismatches, "llr_gap": t.llr_gap, "notes": t.notes}
