"""Quasi-cyclic (block-circulant) structure of a Tanner graph.

The paper's GHP codes and the GB codes are built from l x l circulant
blocks, so the VN<->CN edge permutation decomposes into per-block cyclic
shifts.  The fused BP4 kernel (decoders/bp4_qc.py) runs on any code whose
Hx and Hz pass ``detect_qc_structure``.

Conventions (matching create_circulant_matrix):
  a single-shift circulant C_s has C_s[r, c] = 1  iff  (r - c) mod l == s,
  so CN (i, r) -- VN (j, (r - s) mod l) for the edge group (i, j, s).

In the VN frame (indexed by q): r = (q + s) mod l.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["QCGraphSpec", "QCPair", "detect_qc_structure", "qc_pair_from_code"]


@dataclass(frozen=True)
class QCGraphSpec:
    """Block-circulant decomposition of one parity-check matrix.

    groups[g] = (i, j, s): CN block row i, VN block col j, circulant shift s.
    Every CN in block row i has degree len(cn_groups[i]); every VN in block
    col j has degree len(vn_groups[j]).
    """

    l: int  # lifting (circulant) size
    mb: int  # CN block rows (num_cn = mb * l)
    nb: int  # VN block cols (num_vn = nb * l)
    groups: tuple  # tuple[(i, j, s), ...]
    cn_groups: tuple = field(default=())  # tuple[tuple[int, ...], ...], len mb
    vn_groups: tuple = field(default=())  # len nb

    @property
    def num_groups(self):
        return len(self.groups)

    @property
    def num_edges(self):
        return len(self.groups) * self.l

    def __repr__(self):
        return (
            f"QCGraphSpec(l={self.l}, cn={self.mb}x{self.l}, vn={self.nb}x{self.l}, "
            f"groups={self.num_groups})"
        )


def detect_qc_structure(pcm: np.ndarray, l: int) -> QCGraphSpec | None:
    """Decompose ``pcm`` into l x l single-shift circulant blocks.

    Returns None if the shape doesn't tile by ``l`` or any block is not a
    (possibly empty) sum of single-shift circulants.
    """
    pcm = np.asarray(pcm)
    M, N = pcm.shape
    if l <= 0 or M % l or N % l:
        return None
    mb, nb = M // l, N // l

    # (r - c) mod l for an l x l block, used to read off shifts
    diff = (np.arange(l)[:, None] - np.arange(l)[None, :]) % l

    groups = []
    for i in range(mb):
        for j in range(nb):
            block = pcm[i * l : (i + 1) * l, j * l : (j + 1) * l]
            w = block.sum()
            if w == 0:
                continue
            if w % l:
                return None
            # candidate shifts: values of (r-c)%l on the first row's support
            shifts = sorted(diff[0, np.nonzero(block[0])[0]].tolist())
            if len(shifts) != w // l:
                return None
            recon = np.zeros((l, l), dtype=pcm.dtype)
            for s in shifts:
                recon[diff == s] = 1
            if not np.array_equal(recon, block != 0):
                return None
            groups.extend((i, j, int(s)) for s in shifts)

    groups = tuple(groups)
    cn_groups = tuple(tuple(g for g, (gi, _, _) in enumerate(groups) if gi == i) for i in range(mb))
    vn_groups = tuple(tuple(g for g, (_, gj, _) in enumerate(groups) if gj == j) for j in range(nb))
    return QCGraphSpec(l=l, mb=mb, nb=nb, groups=groups, cn_groups=cn_groups, vn_groups=vn_groups)


@dataclass(frozen=True)
class QCPair:
    """QC decompositions of both CSS graphs, for the fused BP4 kernel."""

    l: int
    n: int  # true qubit count (= nb * l)
    qx: QCGraphSpec  # Hx
    qz: QCGraphSpec  # Hz
    name: str = ""


def _guess_lifts(code) -> list:
    """Candidate lifting sizes, largest first: explicit attribute, then
    divisors of gcd(mx, mz, n) > 1."""
    cands = []
    l_attr = getattr(code, "lift_size", None)
    if l_attr:
        cands.append(int(l_attr))
    g = math.gcd(math.gcd(code.hx.shape[0], code.hz.shape[0]), code.N)
    for d in range(g, 1, -1):
        if g % d == 0 and d not in cands:
            cands.append(d)
    return cands


def qc_pair_from_code(code, l: int | None = None) -> QCPair | None:
    """Detect block-circulant structure on both Hx and Hz of a CSS code.

    Tries ``l`` if given, else candidate lifts (largest first).  Returns
    None when no common decomposition exists.
    """
    lifts = [l] if l else _guess_lifts(code)
    for cand in lifts:
        if cand <= 1:
            continue
        qx = detect_qc_structure(np.asarray(code.hx), cand)
        if qx is None:
            continue
        qz = detect_qc_structure(np.asarray(code.hz), cand)
        if qz is None:
            continue
        return QCPair(l=cand, n=int(code.N), qx=qx, qz=qz, name=getattr(code, "name", ""))
    return None
