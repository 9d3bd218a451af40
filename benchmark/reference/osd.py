"""The check of one Monte-Carlo batch of BP4 min-sum + OSD-0: the channel,
the syndromes, the BP4 decode, the flagged set, the OSD sub-batch, both
OSD-0 solutions and the counts that the program produced, against this
reference.

The decoder (Panteleev & Kalachev, arXiv:1904.02703; the TF original's
``bp_osd.py``): quaternary BP on the depolarizing prior log(3(1 - p)/p),
then, for every sample whose hard decision (argmin over (0, x, z, y))
leaves a syndrome bit unmet, OSD-0 on each side from the binary
reliabilities of the BP marginals, llr_z = log((pI + pX)/(pZ + pY)) and
llr_x = log((pI + pZ)/(pX + pY)):

* a full-rank basis of each check matrix: its rows that are independent of
  the rows above them, and the syndrome bits of those rows;
* the columns sorted by reliability, ascending and stable (the least
  reliable, most likely flipped, first; ties keep their column order);
* Gauss-Jordan elimination row by row: each row's pivot is its leftmost
  one once the earlier pivots are cleared from it, and that column is
  cleared from every other row;
* the solution: the syndrome column's bit of each row at its pivot column,
  zero elsewhere, scattered back through the sort.

The flagged samples go first, in their order (a stable sort), into a
sub-batch of the configured capacity; a flagged sample past it keeps its BP
decision and counts as an overflow.  The rows of the elimination are
bit-packed, 64 columns a word, written apart from the program's table of
bytes.

BP on a sample that does not converge is chaotic, so the decode is held to
the reference only where the reference's decision meets the syndrome
(``llr_gap``, as reference/cascade.py).  Everything after it is recomputed
from the program's own marginals and must be equal: the flagged set, the
sub-batch, both elimination inputs and solutions, and the counts
(``mismatches``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import k1
from .cascade import BLOCK, _flagged_first, _mod2, _Tally, sample_channel
from .gnn_bp import _lse2, hard_decision

__all__ = ["make_ref", "pivot_rows", "binary_llrs", "osd0", "check_batch"]

OSD_BLOCK = 256  # samples per block of the reference elimination
WORD = 64
OP_WORD = 32  # the word of the elimination's counted operations (osd_counts.py)
_POW2 = {}


def pivot_rows(h) -> np.ndarray:
    """The rows of ``h`` that are not in the span of the rows above them, in
    order: the greedy full-rank basis of its row space."""
    h = np.asarray(h, np.int64) & 1
    red = np.zeros((0, h.shape[1]), np.int64)  # reduced echelon rows of the basis so far
    leads, keep = [], []
    for i, row in enumerate(h):
        r = (row + row[leads] @ red) % 2 if leads else row.copy()
        nz = np.flatnonzero(r)
        if nz.size == 0:
            continue
        c = int(nz[0])
        red = np.where(red[:, c:c + 1] == 1, red ^ r, red)  # clear the new lead from the others
        red = np.vstack([red, r])
        leads.append(c)
        keep.append(i)
    return np.asarray(keep, np.int64)


def binary_llrs(llrx, llry, llrz):
    """(llr_x, llr_z) of the quaternary marginals: log((pI + pZ)/(pX + pY))
    and log((pI + pX)/(pZ + pY))."""
    return k1.softplus(-llrz) - _lse2(-llrx, -llry), k1.softplus(-llrx) - _lse2(-llrz, -llry)


def _pow2(device):
    if device not in _POW2:
        _POW2[device] = torch.tensor([1 << k for k in range(WORD - 1)] + [-(1 << (WORD - 1))],
                                     dtype=torch.int64, device=device)
    return _POW2[device]


def _pack(bits):
    """[..., c] 0/1 -> [..., ceil(c / 64)] int64, column j at bit j % 64 of
    word j // 64."""
    c = bits.shape[-1]
    words = -(-c // WORD)
    padded = torch.nn.functional.pad(bits.to(torch.int64), (0, words * WORD - c))
    return (padded.reshape(bits.shape[:-1] + (words, WORD)) * _pow2(bits.device)).sum(dim=-1)


def _osd0_block(llr, basis_t, syndrome):
    b, n = llr.shape
    rank = basis_t.shape[1]
    order = torch.argsort(llr, dim=-1, stable=True)  # [b, n]
    table = torch.cat([basis_t[order].transpose(1, 2), syndrome.T[:, :, None].to(torch.uint8)], dim=2)
    tab = _pack(table)  # [b, rank, words]
    del table
    rows = torch.arange(b, device=llr.device)
    pow2 = _pow2(llr.device)
    pivots = torch.empty((b, rank), dtype=torch.int64, device=llr.device)
    ops = torch.zeros(b, dtype=torch.int64, device=llr.device)
    words32 = -(-(n + 1) // OP_WORD)
    for row in range(rank):
        cur = tab[:, row, :]  # [b, words]
        w = torch.argmax((cur != 0).to(torch.int8), dim=1)  # the first word holding a one
        word = cur[rows, w]
        bit = torch.argmax(((word & -word)[:, None] == pow2[None, :]).to(torch.int8), dim=1)
        pivots[:, row] = w * WORD + bit
        col = (tab[rows, :, w] >> bit[:, None]) & 1  # [b, rank]: the pivot column
        col[:, row] = 0
        # forward elimination's least form: a bit test of each row below, and a masked XOR of
        # each that holds a one in the pivot column, from the pivot's 32-bit word to the
        # syndrome's (the pivot row is zero left of its pivot)
        ops += col[:, row + 1:].sum(dim=1) * (words32 - pivots[:, row] // OP_WORD) + (rank - 1 - row)
        tab ^= (-col)[:, :, None] & cur[:, None, :]
    sol = (tab[:, :, n // WORD] >> (n % WORD)) & 1  # [b, rank]: the syndrome column
    out = torch.zeros((b, n), dtype=torch.int32, device=llr.device)
    return out.scatter_(1, order.gather(1, pivots), sol.to(torch.int32)), ops


def osd0(llr, basis, syndrome, block=OSD_BLOCK):
    """OSD-0 solutions [B, n] int32 of reliabilities ``llr`` [B, n], a
    full-rank basis [rank, n] and its syndrome bits [rank, B], in blocks
    of ``block`` samples; and each sample's 32-bit integer operations [B]
    int64 in the elimination's least form, forward elimination on rows of
    32-bit words (its pivots are Gauss-Jordan's: row r once cleared of the
    earlier pivots is the same row either way).  At each pivot: one bit
    test of each row below, and one masked XOR (a LOP3) of each word from
    the pivot's to the syndrome's of each row below that holds a one in the
    pivot column.  Not counted: the pivot's search along its row, and the
    rows above each pivot that Gauss-Jordan clears too, which serve only
    the syndrome column, whose back-substitution is rank² / 2 bit
    operations."""
    basis_t = torch.as_tensor(np.asarray(basis, np.uint8).T.copy(), device=llr.device)  # [n, rank]
    outs = [_osd0_block(llr[s:s + block], basis_t, syndrome[:, s:s + block])
            for s in range(0, llr.shape[0], block)]
    if not outs:
        return (torch.zeros(llr.shape, dtype=torch.int32, device=llr.device),
                torch.zeros(llr.shape[0], dtype=torch.int64, device=llr.device))
    return torch.cat([o for o, _ in outs], dim=0), torch.cat([x for _, x in outs])


class _Ref:
    """The code's matrices on the reference's device and its bases."""

    def __init__(self, code, device):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.code = code
        self.hx, self.hz = f(code.hx), f(code.hz)
        self.kx, self.kz = f(code.ker_hx), f(code.ker_hz)
        self.piv_x, self.piv_z = pivot_rows(code.hx), pivot_rows(code.hz)
        self.basis_x, self.basis_z = np.asarray(code.hx)[self.piv_x], np.asarray(code.hz)[self.piv_z]

    def unmet(self, x_hat, z_hat, syn_x, syn_z):
        return ((_mod2(self.hz, x_hat) != syn_z).any(dim=0)
                | (_mod2(self.hx, z_hat) != syn_x).any(dim=0))


def make_ref(code, device):
    return _Ref(code, device)


def check_batch(ref: _Ref, cfg: dict, p: float, batch: int, cap: int, seed_word: int, capture: dict):
    """Readings of one captured batch: {"mismatches", "llr_gap", "notes"},
    and "osd_decoded" and "osd_ops", the samples of the sub-batch that OSD
    decoded and their integer operations on both sides (``osd0``).

    ``cfg``: the decoder's ``num_iter``, ``cn_type`` and ``factor``.
    ``capture``: "noise" (noise_x, noise_z) as the program sampled them;
    "launches", its BP decodes (each "llr" [3, n, B], "sx", "sz", "out"
    (llrx, llry, llrz) [n, B], "iters"); "flagged_first", the flags, indices
    and validity of its OSD sub-batch; "osd", its eliminations in call
    order, the z side (hx's basis) first, each "llr" [cap, n], "syndrome"
    [rank, cap] and "out" [cap, n]; "counts" (flagged, logical, overflow)
    as its step returned them."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products throughout
    t = _Tally()
    t.osd_ops = 0
    dev = ref.hx.device
    code = ref.code
    n = code.n
    nx, nz = sample_channel(n, batch, p, seed_word, dev)
    pnx, pnz = capture["noise"]
    t.exact("noise x", pnx.to(torch.bool), nx)
    t.exact("noise z", pnz.to(torch.bool), nz)
    syn_x, syn_z = _mod2(ref.hx, nz), _mod2(ref.hz, nx)
    launches = capture["launches"]
    if len(launches) != 1 or len(capture.get("osd", ())) != 2 or "flagged_first" not in capture:
        t.mismatches += 1
        t.notes.append(f"{len(launches)} BP decodes, {len(capture.get('osd', ()))} eliminations, sub-batch "
                       f"{'seen' if 'flagged_first' in capture else 'not seen'}: expected 1, 2, seen")
        return _result(t)
    launch = launches[0]
    llr0 = torch.log(torch.tensor(3.0 * (1.0 - p) / p, dtype=torch.float32, device=dev)).expand(3, n, batch)
    if not t.exact("decode input", launch["llr"].to(torch.float32), llr0):
        return _result(t)
    t.exact("decode iterations", torch.tensor(launch["iters"]), torch.tensor(int(cfg["num_iter"])))
    t.exact("decode syndrome x", launch["sx"].to(torch.int32), syn_x)
    t.exact("decode syndrome z", launch["sz"].to(torch.int32), syn_z)

    # the decode, held to the reference where the reference's decision converges
    outs = [[], [], []]
    for s in range(0, batch, BLOCK):
        blk = slice(s, s + BLOCK)
        o = k1.marginals(code.qx, code.qz, launch["llr"][..., blk], syn_x[:, blk], syn_z[:, blk],
                         int(cfg["num_iter"]), cfg["cn_type"], float(cfg["factor"]))
        for acc, v in zip(outs, o):
            acc.append(v)
    r = [torch.cat(v, dim=-1) for v in outs]
    converged = ~ref.unmet(*hard_decision(*r), syn_x, syn_z)
    for name, prog, want in zip("xyz", launch["out"], r):
        t.gap(f"decode llr{name}", prog, want, converged)
    del r, outs

    # everything after the decode, from the program's own marginals
    marg = [v.to(torch.float32) for v in launch["out"]]
    x_hat, z_hat = hard_decision(*marg)
    flags = ref.unmet(x_hat, z_hat, syn_x, syn_z)
    pflags, pidx, pvalid = capture["flagged_first"]
    t.exact("flagged set", pflags.to(torch.bool), flags)
    idx, valid = _flagged_first(flags, min(batch, cap))
    t.exact("sub-batch", pidx.to(torch.int64), idx)
    t.exact("sub-batch validity", pvalid.to(torch.bool), valid)
    llr_x, llr_z = binary_llrs(*marg)
    solved = {}
    for side, llr, basis, piv, syn in (("z", llr_z, ref.basis_x, ref.piv_x, syn_x),
                                       ("x", llr_x, ref.basis_z, ref.piv_z, syn_z)):
        call = capture["osd"][0 if side == "z" else 1]
        sub_llr, sub_syn = llr.T[idx].contiguous(), syn[torch.as_tensor(piv, device=dev)][:, idx]
        t.exact(f"OSD {side} reliabilities", call["llr"].to(torch.float32), sub_llr)
        t.exact(f"OSD {side} syndrome", call["syndrome"].to(torch.int32), sub_syn)
        solved[side], ops = osd0(sub_llr, basis, sub_syn)
        t.exact(f"OSD {side} solution", call["out"].to(torch.int32), solved[side])
        t.osd_ops += int(ops[valid].sum())
    upd = valid[None, :]
    x_fin = x_hat.index_copy(1, idx, torch.where(upd, solved["x"].T, x_hat[:, idx]))
    z_fin = z_hat.index_copy(1, idx, torch.where(upd, solved["z"].T, z_hat[:, idx]))
    dx, dz = nx.to(torch.int32) ^ x_fin, nz.to(torch.int32) ^ z_fin
    logical = (_mod2(ref.kx, dx) != 0).any(dim=0) | (_mod2(ref.kz, dz) != 0).any(dim=0)
    want = torch.stack([flags.sum(), logical.sum(), flags.sum() - valid.sum()]).to(torch.int64)
    got = torch.stack([torch.as_tensor(c, device=dev).reshape(()) for c in capture["counts"]])
    t.exact("counts (flagged, logical, overflow)", got.to(torch.int64), want)
    return _result(t, decoded=int(valid.sum()))


def _result(t: _Tally, decoded=0):
    """The readings, and the samples OSD decoded with their operations
    (both sides) where the check came that far."""
    return {"mismatches": t.mismatches, "llr_gap": t.llr_gap, "notes": t.notes, "osd_decoded": decoded,
            "osd_ops": t.osd_ops if decoded else 0}
