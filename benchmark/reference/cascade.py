"""The check of one Monte-Carlo batch of the sandwich cascade: the channel,
the syndromes, every BP4 decode, every feedback-GNN step, the compaction
and the counts that the program produced, against this reference.

BP on a sample that does not converge is chaotic: a last-bit difference at
one iteration can move its marginals by O(1) some tens of iterations later.
So the check follows the program stage by stage.  It samples the channel
and computes the syndromes and the first decode's input itself, and holds
each later stage's input to what the reference's rules make of the
program's previous output; each decode and each GNN step is recomputed from
its input and compared with the program's output:

* ``mismatches``: exact quantities that differ (noise bits, syndrome bits,
  input LLRs, sub-batch membership, decode shapes, the three counts);
* ``llr_gap``: the widest relative gap |program - reference| / max(|ref|,
  1) over the GNN's output LLRs, and over the marginals of each decode on
  the samples whose reference decision meets the syndrome (a converged
  sample sits at a stable fixed point, where rounding does not grow).

The cascade (arXiv:2310.17758, with the port's compaction): a BP4 decode of
``stage1_prepass`` (else ``num_iter1``) iterations on the whole batch; the
samples whose decision leaves a syndrome unmet go first (a stable order)
into a sub-batch of capacity ceil(fraction B) rounded up to ``tile``, which
is decoded again with ``num_iter1`` iterations from the channel LLRs; the
ones still unmet go into a second sub-batch of ``round_fraction``, where
``num_rounds`` rounds of {GNN on the last marginals and check logits, BP4 of
``num_iter2`` iterations, adopted by the samples still unmet before the
round} run.  A sample that did not fit a sub-batch counts as an overflow.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import k1
from .gnn_bp import check_logits, gnn_apply, hard_decision

__all__ = ["batch_seed", "sample_channel", "check_batch"]

BLOCK = 4096  # samples per block of the reference decode


def batch_seed(seed: int, iteration: int) -> int:
    """The generator seed of batch ``iteration`` of a sweep seeded ``seed``
    (process 0, point 0), as the Monte-Carlo loop derives it."""
    return int(np.random.SeedSequence([seed, 0, 0, iteration]).generate_state(1, np.uint64)[0])


def sample_channel(n, batch, p, seed_word, device):
    """Depolarizing noise of strength p from one uniform draw a qubit:
    X where u < 2p/3, Z where 2p/3 - p/3 <= u < 2p/3 + 2p/3 - p/3 (Y where
    both).  Bool (noise_x, noise_z) [n, batch]."""
    g = torch.Generator(device=device).manual_seed(seed_word)
    u = torch.rand((n, batch), generator=g, device=device)
    px, py, pz = 2.0 * p / 3.0, p / 3.0, 2.0 * p / 3.0
    return u < px, (u >= (px - py)) & (u < (px + pz - py))


def _mod2(h, v):
    return torch.matmul(h, v.to(torch.float32)).to(torch.int32) & 1


def _capacity(fraction, b, tile):
    return min(b, -(-int(math.ceil(fraction * b)) // tile) * tile)


def _flagged_first(flags, cap):
    order = torch.argsort(torch.logical_not(flags).to(torch.int8), stable=True)
    idx = order[:cap]
    return idx, flags[idx]


class _Tally:
    def __init__(self):
        self.mismatches = 0
        self.llr_gap = 0.0
        self.notes = []

    def exact(self, what, a, b):
        if tuple(a.shape) != tuple(b.shape):
            self.mismatches += 1
            self.notes.append(f"{what}: shape {tuple(a.shape)} != {tuple(b.shape)}")
            return False
        bad = int((a != b).sum())
        if bad:
            self.mismatches += bad
            self.notes.append(f"{what}: {bad} differ")
        return bad == 0

    def gap(self, what, prog, ref, keep=None):
        if tuple(prog.shape) != tuple(ref.shape):
            self.mismatches += 1
            self.notes.append(f"{what}: shape {tuple(prog.shape)} != {tuple(ref.shape)}")
            return
        g = (prog - ref).abs() / ref.abs().clamp_min(1.0)
        g = torch.where(torch.isnan(g), torch.inf, g)
        if keep is not None:
            g = g[..., keep]
        if g.numel():
            self.llr_gap = max(self.llr_gap, float(g.max()))


class _Ref:
    """The code's matrices as float32 tensors on the reference's device."""

    def __init__(self, code, graph, params, device):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.code, self.graph, self.params = code, graph, params
        self.hx, self.hz = f(code.hx), f(code.hz)
        self.kx, self.kz = f(code.ker_hx), f(code.ker_hz)

    def unmet(self, x_hat, z_hat, syn_x, syn_z):
        """[B] bool: the decision leaves a syndrome bit unmet."""
        return ((_mod2(self.hz, x_hat) != syn_z).any(dim=0)
                | (_mod2(self.hx, z_hat) != syn_x).any(dim=0))


def _decode_stage(t, ref, what, launch, iters, cfg, syn_x, syn_z):
    """Check one decode: its iterations and syndromes, then its marginals
    against the reference decode of the program's input."""
    t.exact(f"{what} iterations", torch.tensor(launch["iters"]), torch.tensor(iters))
    t.exact(f"{what} syndrome x", launch["sx"].to(torch.int32), syn_x)
    t.exact(f"{what} syndrome z", launch["sz"].to(torch.int32), syn_z)
    code = ref.code
    outs = [[], [], []]
    for s in range(0, launch["llr"].shape[-1], BLOCK):
        blk = slice(s, s + BLOCK)
        o = k1.marginals(code.qx, code.qz, launch["llr"][..., blk], syn_x[:, blk], syn_z[:, blk],
                         iters, cfg["cn_type"], cfg.get("factor", 1.0), cfg.get("phi_impl"))
        for acc, v in zip(outs, o):
            acc.append(v)
    r = [torch.cat(v, dim=-1) for v in outs]
    rx, rz = hard_decision(*r)
    converged = ~ref.unmet(rx, rz, syn_x, syn_z)
    for name, p, q in zip("xyz", launch["out"], r):
        t.gap(f"{what} llr{name}", p, q, converged)
    return launch["out"]


def check_batch(ref: _Ref, cfg: dict, p: float, batch: int, seed_word: int, capture: dict):
    """Readings of one captured batch: {"mismatches", "llr_gap", "notes"}.

    ``capture``: "noise" (noise_x, noise_z) as the program sampled them,
    "launches" (each a dict of "llr" [3, n, b], "sx", "sz", "out" (llrx,
    llry, llrz) [n, b] and "iters", in launch order) and "counts" (flagged,
    logical, overflow) as the program's step returned them."""
    t = _Tally()
    dev = ref.hx.device
    code = ref.code
    n = code.n
    nx, nz = sample_channel(n, batch, p, seed_word, dev)
    pnx, pnz = capture["noise"]
    t.exact("noise x", pnx.to(torch.bool), nx)
    t.exact("noise z", pnz.to(torch.bool), nz)
    syn_x, syn_z = _mod2(ref.hx, nz), _mod2(ref.hz, nx)
    launches = list(capture["launches"])
    prepass = cfg.get("stage1_prepass")
    rounds = int(cfg["num_rounds"])
    expect = 1 + (1 if prepass else 0) + rounds
    if len(launches) != expect:
        t.mismatches += 1
        t.notes.append(f"{len(launches)} decodes, expected {expect}")
        return _result(t)
    llr0 = torch.log(torch.tensor(3.0 * (1.0 - cfg["p0"]) / cfg["p0"], dtype=torch.float32,
                                  device=dev)).expand(3, n, batch)
    tile = int(cfg["tile"])
    b = batch

    # stage 1: the prepass (or the full schedule) on the whole batch
    first = launches.pop(0)
    if not t.exact("decode 1 input", first["llr"].to(torch.float32), llr0):
        return _result(t)
    iters1 = min(prepass, cfg["num_iter1"]) if prepass else cfg["num_iter1"]
    out = _decode_stage(t, ref, "decode 1", first, iters1, cfg, syn_x, syn_z)
    x_hat, z_hat = hard_decision(*out)
    compact = cfg.get("compact_fraction")
    ov = torch.zeros(b, dtype=torch.bool, device=dev)
    if not compact:
        sel = torch.arange(b, device=dev)
        valid = torch.ones(b, dtype=torch.bool, device=dev)
        res, x_s, z_s = out, x_hat, z_hat
    else:
        cap = _capacity(compact, b, tile)
        flags0 = ref.unmet(x_hat, z_hat, syn_x, syn_z)
        sel, valid = _flagged_first(flags0, cap)
        covered = torch.zeros(b, dtype=torch.bool, device=dev).index_copy(0, sel, valid)
        ov = flags0 & ~covered
        if prepass and prepass < cfg["num_iter1"]:
            lvl1 = launches.pop(0)
            if not t.exact("decode 2 input", lvl1["llr"].to(torch.float32), llr0[:, :, sel]):
                return _result(t)
            res = _decode_stage(t, ref, "decode 2", lvl1, cfg["num_iter1"], cfg, syn_x[:, sel],
                                syn_z[:, sel])
            rx, rz = hard_decision(*res)
            x_s = torch.where(valid[None], rx, x_hat[:, sel])
            z_s = torch.where(valid[None], rz, z_hat[:, sel])
        else:
            res = [v[:, sel] for v in out]
            x_s, z_s = x_hat[:, sel], z_hat[:, sel]

    sx1, sz1 = syn_x[:, sel], syn_z[:, sel]
    rf = cfg.get("round_fraction")
    if compact and rf is not None:
        cap2 = min(len(sel), _capacity(rf, b, tile))
        flags1 = ref.unmet(x_s, z_s, sx1, sz1) & valid
        sel2, valid2 = _flagged_first(flags1, cap2)
        covered2 = torch.zeros(len(sel), dtype=torch.bool, device=dev).index_copy(0, sel2, valid2)
        ov = ov.index_copy(0, sel, ov[sel] | (flags1 & ~covered2))
    else:
        sel2 = torch.arange(len(sel), device=dev)
        valid2 = valid

    # the GNN rounds on the second sub-batch
    prev = [v[:, sel2] for v in res]
    xr, zr = x_s[:, sel2], z_s[:, sel2]
    sx2, sz2 = sx1[:, sel2], sz1[:, sel2]
    errors = valid2
    pad = ref.graph.n_pad - n
    for r in range(rounds):
        errors = errors & ref.unmet(xr, zr, sx2, sz2)
        padded = [torch.nn.functional.pad(v, (0, 0, 0, pad)) for v in prev]
        x_logit, z_logit = check_logits(*padded, ref.graph)
        new_llr = gnn_apply(ref.params, ref.graph, torch.stack(padded), z_logit, x_logit, sx2, sz2)
        launch = launches.pop(0)
        t.gap(f"GNN {r + 1} output", launch["llr"].to(torch.float32), new_llr[:, :n])
        prev = _decode_stage(t, ref, f"round {r + 1} decode", launch, cfg["num_iter2"], cfg, sx2, sz2)
        nx_r, nz_r = hard_decision(*prev)
        xr = torch.where(errors[None], nx_r, xr)
        zr = torch.where(errors[None], nz_r, zr)

    x_s = x_s.index_copy(1, sel2, xr)
    z_s = z_s.index_copy(1, sel2, zr)
    x_hat = x_hat.index_copy(1, sel, x_s)
    z_hat = z_hat.index_copy(1, sel, z_s)
    dx, dz = (nx.to(torch.int32) ^ x_hat), (nz.to(torch.int32) ^ z_hat)
    flagged = (_mod2(ref.hz, dx) != 0).any(dim=0) | (_mod2(ref.hx, dz) != 0).any(dim=0)
    logical = (_mod2(ref.kx, dx) != 0).any(dim=0) | (_mod2(ref.kz, dz) != 0).any(dim=0)
    want = torch.stack([flagged.sum(), logical.sum(), ov.sum()]).to(torch.int64)
    got = torch.stack([torch.as_tensor(c, device=dev).reshape(()) for c in capture["counts"]])
    t.exact("counts (flagged, logical, overflow)", got.to(torch.int64), want)
    return _result(t)


def _result(t: _Tally):
    return {"mismatches": t.mismatches, "llr_gap": t.llr_gap, "notes": t.notes}


def make_ref(code, graph, params, device):
    return _Ref(code, graph, params, device)
