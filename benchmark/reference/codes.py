"""The codes of the benchmark's configurations, built from the numbers in
their configuration files, in NumPy.

Quasi-cyclic generalized hypergraph product (GHP) codes, arXiv:2310.17758:
hx = [A, I (x) circ(b)], hz = [I (x) circ(b)^T, A^T], where A is a block
matrix of l x l single-shift circulants (shift -1: a zero block) and a
circulant with shifts ``pows`` has ones at ((i + c) mod l, i).

Any other family ``<family>`` is built by ``build(spec) -> (hx, hz, lift or
None)`` of the module ``family_<family>.py`` beside this one; every family's
matrices are held to the same checks (binary, CSS, the configured n and k).

Everything here is written from the construction's definition; nothing is
read from the program.  The slot layouts (``tanner``, ``rowset``) follow
the published decoder's conventions: edges in VN-major order, a VN's slots
in increasing CN order, a CN's slots in increasing VN order.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

__all__ = ["Code", "QCSpec", "Tanner", "RowSet", "build_code", "family_builder", "gf2_kernel", "qc_spec",
           "tanner", "rowset"]


def circulant(l: int, pows) -> np.ndarray:
    h = np.zeros((l, l), np.int64)
    for i in range(l):
        for c in pows:
            h[(i + c) % l, i] = 1
    return h


def cyclic_shift_matrix(n: int, shifts) -> np.ndarray:
    """The GHP shift matrix whose i-th cyclic diagonal holds ``shifts[i]``."""
    a = np.full((n, n), -1, np.int64)
    for i, s in enumerate(shifts):
        for j in range(n):
            a[j, (j - i) % n] = s
    return a


def ghp(l: int, a, b):
    """(hx, hz) of the QC-GHP code of lift ``l``, shift matrix ``a`` and
    circulant ``b``."""
    a = np.asarray(a)
    m, n = a.shape
    zero = np.zeros((l, l), np.int64)
    big_a = np.block([[circulant(l, [s]) if s >= 0 else zero for s in row] for row in a])
    cb = circulant(l, b)
    hx = np.hstack((big_a, np.kron(np.identity(m, dtype=np.int64), cb)))
    hz = np.hstack((np.kron(np.identity(n, dtype=np.int64), cb.T), big_a.T))
    return hx, hz


def gf2_kernel(mat: np.ndarray) -> np.ndarray:
    """Rows spanning {x : mat @ x = 0 (mod 2)}, by reduced row echelon form."""
    m = np.asarray(mat, np.uint8).copy() & 1
    rows, cols = m.shape
    pivots = []
    r = 0
    for c in range(cols):
        if r == rows:
            break
        hit = np.nonzero(m[r:, c])[0]
        if hit.size == 0:
            continue
        p = r + hit[0]
        if p != r:
            m[[r, p]] = m[[p, r]]
        sel = m[:, c].astype(bool)
        sel[r] = False
        m[sel] ^= m[r]
        pivots.append(c)
        r += 1
    free = [c for c in range(cols) if c not in set(pivots)]
    ker = np.zeros((len(free), cols), np.uint8)
    for k, f in enumerate(free):
        ker[k, f] = 1
        for i, pc in enumerate(pivots):
            ker[k, pc] = m[i, f]
    return ker


@dataclass(frozen=True)
class QCSpec:
    """Block-circulant decomposition of one check matrix: groups[g] =
    (block row i, block column j, shift s); CN (i, r) meets VN
    (j, (r - s) mod l)."""

    l: int
    mb: int
    nb: int
    groups: tuple
    cn_groups: tuple
    vn_groups: tuple

    @property
    def num_groups(self):
        return len(self.groups)

    @property
    def num_edges(self):
        return len(self.groups) * self.l


def qc_spec(h: np.ndarray, l: int) -> QCSpec:
    m, n = h.shape
    mb, nb = m // l, n // l
    if mb * l != m or nb * l != n:
        raise ValueError(f"{h.shape} does not tile by {l}")
    diff = (np.arange(l)[:, None] - np.arange(l)[None, :]) % l
    groups = []
    for i in range(mb):
        for j in range(nb):
            block = h[i * l:(i + 1) * l, j * l:(j + 1) * l]
            shifts = sorted(diff[0, np.nonzero(block[0])[0]].tolist())
            recon = np.zeros((l, l), np.int64)
            for s in shifts:
                recon[diff == s] = 1
            if not np.array_equal(recon, block != 0):
                raise ValueError(f"block ({i}, {j}) is not a sum of single-shift circulants")
            groups.extend((i, j, int(s)) for s in shifts)
    groups = tuple(groups)
    cn_groups = tuple(tuple(g for g, (gi, _, _) in enumerate(groups) if gi == i) for i in range(mb))
    vn_groups = tuple(tuple(g for g, (_, gj, _) in enumerate(groups) if gj == j) for j in range(nb))
    return QCSpec(l, mb, nb, groups, cn_groups, vn_groups)


def _aligned(count: int) -> int:
    """The padded node count: a multiple of 8 with at least one pad row."""
    return ((count + 1 + 7) // 8) * 8


@dataclass(frozen=True)
class Tanner:
    """Slot-major layout of one check matrix: messages are [d, node_pad, B]."""

    num_vn: int
    num_cn: int
    n_pad: int
    c_pad: int
    dv: int
    dc: int
    cn_gather: np.ndarray  # [dc * c_pad]: flat VN-slot index of each CN slot
    vn_gather: np.ndarray  # [dv * n_pad]
    vn_mask: np.ndarray  # [dv, n_pad]
    cn_mask: np.ndarray  # [dc, c_pad]
    vn_deg: np.ndarray  # [n_pad]
    edge_cn_byslot: np.ndarray  # [dv, n_pad], pads -> num_cn


def tanner(h: np.ndarray) -> Tanner:
    num_cn, num_vn = h.shape
    cn_ids, vn_ids = np.nonzero(h)
    order = np.lexsort((cn_ids, vn_ids))
    ev, ec = vn_ids[order], cn_ids[order]
    vdeg = np.bincount(ev, minlength=num_vn)
    cdeg = np.bincount(ec, minlength=num_cn)
    dv, dc = int(vdeg.max()), int(cdeg.max())
    n_pad, c_pad = _aligned(num_vn), _aligned(num_cn)
    vslot = np.zeros(len(ev), np.int64)
    cslot = np.zeros(len(ev), np.int64)
    vfill, cfill = np.zeros(num_vn, np.int64), np.zeros(num_cn, np.int64)
    for e in range(len(ev)):
        vslot[e], cslot[e] = vfill[ev[e]], cfill[ec[e]]
        vfill[ev[e]] += 1
        cfill[ec[e]] += 1
    cn_gather = np.full(dc * c_pad, num_vn, np.int64)
    vn_gather = np.full(dv * n_pad, num_cn, np.int64)
    vflat, cflat = vslot * n_pad + ev, cslot * c_pad + ec
    cn_gather[cflat] = vflat
    vn_gather[vflat] = cflat
    vn_mask = np.zeros((dv, n_pad), np.float32)
    cn_mask = np.zeros((dc, c_pad), np.float32)
    vn_mask[vslot, ev] = 1.0
    cn_mask[cslot, ec] = 1.0
    by_slot = np.full((dv, n_pad), num_cn, np.int64)
    by_slot[vslot, ev] = ec
    vn_deg = np.zeros(n_pad, np.float32)
    vn_deg[:num_vn] = vdeg
    return Tanner(num_vn, num_cn, n_pad, c_pad, dv, dc, cn_gather, vn_gather, vn_mask, cn_mask,
                  vn_deg, by_slot)


@dataclass(frozen=True)
class RowSet:
    """VN ids of each row of a check matrix, slot-major [d, r_pad], pads ->
    ``num_vn`` (a zero pad row of an [n_pad, B] source)."""

    num_rows: int
    vn_idx: np.ndarray
    mask: np.ndarray
    row_valid: np.ndarray


def rowset(h: np.ndarray) -> RowSet:
    num_rows, num_vn = h.shape
    deg = h.sum(axis=1)
    d, r_pad = int(deg.max()), _aligned(num_rows)
    idx = np.full((d, r_pad), num_vn, np.int64)
    mask = np.zeros((d, r_pad), np.float32)
    for r in range(num_rows):
        cols = np.nonzero(h[r])[0]
        idx[:len(cols), r] = cols
        mask[:len(cols), r] = 1.0
    valid = np.zeros(r_pad, np.float32)
    valid[:num_rows] = 1.0
    return RowSet(num_rows, idx, mask, valid)


@dataclass(frozen=True)
class Code:
    n: int
    k: int
    l: int | None  # the lift of a block-circulant code, else None
    hx: np.ndarray  # [mx, n] int64
    hz: np.ndarray  # [mz, n]
    ker_hx: np.ndarray  # rows spanning ker(hx): an X residual is a logical error
    ker_hz: np.ndarray  # unless it is orthogonal to all of them (and so for Z)
    qx: QCSpec | None  # hx's and hz's block-circulant layouts where there is a lift
    qz: QCSpec | None


def qc_ghp(spec: dict):
    """(hx, hz, lift) of a ``qc_ghp`` entry."""
    l = int(spec["lift"])
    a = spec["shifts"]
    if isinstance(a, dict):  # a cyclic shift matrix: its diagonals' shifts
        a = cyclic_shift_matrix(int(a["size"]), a["diagonals"])
    hx, hz = ghp(l, a, spec["circulant"])
    return hx, hz, l


def family_builder(family: str):
    """``build`` of the code family's module, or ValueError where there is
    none."""
    if family == "qc_ghp":
        return qc_ghp
    if isinstance(family, str) and family.isidentifier():
        name = f"{__package__}.family_{family}"
        try:
            build = getattr(importlib.import_module(name), "build", None)
        except ModuleNotFoundError as e:
            if e.name != name:
                raise  # the family's module exists and lacks a module it imports
            build = None
        if callable(build):
            return build
    raise ValueError(f"unknown code family {family!r}")


def build_code(spec: dict) -> Code:
    """The code of a configuration file's ``code`` entry."""
    hx, hz, l = family_builder(spec["family"])(spec)
    hx, hz = np.asarray(hx, np.int64), np.asarray(hz, np.int64)
    if hx.ndim != 2 or hz.ndim != 2 or hx.shape[1] != hz.shape[1] or not np.isin(hx, (0, 1)).all() \
            or not np.isin(hz, (0, 1)).all():
        raise ValueError(f"hx {hx.shape} and hz {hz.shape} are not binary matrices of one width")
    if np.any(hx @ hz.T % 2):
        raise ValueError("hx hz^T != 0: not a CSS code")
    ker_hx, ker_hz = gf2_kernel(hx), gf2_kernel(hz)
    n = hx.shape[1]
    k = len(ker_hx) - (n - len(ker_hz))
    if k != int(spec["k"]) or n != int(spec["n"]):
        raise ValueError(f"built [[{n},{k}]], configured [[{spec['n']},{spec['k']}]]")
    qx, qz = (qc_spec(hx, l), qc_spec(hz, l)) if l is not None else (None, None)
    return Code(n, k, l, hx, hz, ker_hx, ker_hz, qx, qz)
