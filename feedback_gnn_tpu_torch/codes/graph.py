"""Tanner-graph layout: aligned slot-major tables, built on the host.

The same dense layout as ``feedback_gnn_tpu/codes/graph.py``, as NumPy
dataclasses (every array equal to the JAX package's, bit for bit):

* per-edge message state is slot-major ``[max_deg, node_pad, B]``;
* ``node_pad`` is a multiple of 8 and ``>= nodes + 1``, so a guaranteed-zero
  pad row exists for branch-free padded gathers.

Zero-invariants relied on by the decoders:
  I1. channel-LLR pad rows are zero -> VN-phase messages at pad VNs are zero;
  I2. CN updates multiply their output by ``cn_mask`` -> pad CN slots are zero;
  I3. gather pad entries point at pad slots, so unmasked per-node sums are exact.

``QuantumGraph.to(device)`` makes torch tensors of every array once per
graph: integer tables become int64 (index tensors), the rest keep their
dtype.  The decoders take the graph that ``to`` returns.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["TannerGraph", "RowSet", "build_graph", "build_rowset", "QuantumGraph", "pad_rows"]


def _aligned(count: int) -> int:
    """Smallest multiple of 8 that is >= count + 1 (always >= 1 pad row)."""
    return ((count + 1 + 7) // 8) * 8


def pad_rows(mat: np.ndarray, rows: int, cols: int | None = None) -> np.ndarray:
    """Zero-pad a host matrix to [rows, cols]."""
    m, n = mat.shape
    out = np.zeros((rows, cols if cols is not None else n), mat.dtype)
    out[:m, :n] = mat
    return out


def _to_tensors(obj, names, device):
    """Copy of a dataclass with the named NumPy fields made device tensors."""

    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=device)

    return dataclasses.replace(obj, **{f: conv(getattr(obj, f)) for f in names})


@dataclass(frozen=True)
class TannerGraph:
    """Static aligned gather tables for one parity-check matrix."""

    num_vn: int
    num_cn: int
    n_pad: int  # aligned VN count (multiple of 8, > num_vn)
    c_pad: int  # aligned CN count
    num_edges: int
    max_vn_deg: int  # dv: VN slot count
    max_cn_deg: int  # dc: CN slot count
    # [dc * c_pad] int32: flat vn-slot index (into dv*n_pad) per cn slot
    cn_gather: np.ndarray
    # [dv * n_pad] int32: flat cn-slot index (into dc*c_pad) per vn slot
    vn_gather: np.ndarray
    # [dv, n_pad] / [dc, c_pad] float32 {0,1} validity masks
    vn_mask: np.ndarray
    cn_mask: np.ndarray
    # true degrees, [n_pad] / [c_pad] float32 (pad rows: 0)
    vn_deg: np.ndarray
    cn_deg: np.ndarray
    # [dv, n_pad] int32: CN id per vn slot (pads -> num_cn) — GNN h_cn gather
    edge_cn_byslot: np.ndarray
    # [dc, c_pad] int32: VN id per cn slot (pads -> num_vn)
    edge_vn_byslot: np.ndarray
    # true edges, VN-major (vn, cn) sorted
    edge_vn: np.ndarray
    edge_cn: np.ndarray

    ARRAYS = (
        "cn_gather", "vn_gather", "vn_mask", "cn_mask", "vn_deg", "cn_deg",
        "edge_cn_byslot", "edge_vn_byslot", "edge_vn", "edge_cn",
    )

    def to(self, device) -> "TannerGraph":
        return _to_tensors(self, self.ARRAYS, device)

    def __repr__(self):
        return (
            f"TannerGraph(vn={self.num_vn}/{self.n_pad}, cn={self.num_cn}/{self.c_pad}, "
            f"edges={self.num_edges}, deg=({self.max_vn_deg},{self.max_cn_deg}))"
        )


@dataclass(frozen=True)
class RowSet:
    """Aligned slot-major per-row VN-id tables for boxplus over PCM rows."""

    num_rows: int
    r_pad: int
    max_deg: int
    # [max_deg, r_pad] int32 VN ids (pads -> vn_sentinel, a zero pad row)
    vn_idx: np.ndarray
    # [max_deg, r_pad] float32 {0,1}
    mask: np.ndarray
    # [r_pad] float32 {0,1}: 0 marks pad rows
    row_valid: np.ndarray
    vn_sentinel: int

    ARRAYS = ("vn_idx", "mask", "row_valid")

    def to(self, device) -> "RowSet":
        return _to_tensors(self, self.ARRAYS, device)


def build_graph(pcm: np.ndarray) -> TannerGraph:
    """Build the aligned layout from a 0/1 parity-check matrix."""
    pcm = np.asarray(pcm)
    num_cn, num_vn = pcm.shape
    cn_ids, vn_ids = np.nonzero(pcm)
    order = np.lexsort((cn_ids, vn_ids))  # VN-major canonical order
    edge_vn = vn_ids[order].astype(np.int32)
    edge_cn = cn_ids[order].astype(np.int32)
    num_edges = edge_vn.shape[0]

    vn_deg = np.bincount(edge_vn, minlength=num_vn)
    cn_deg = np.bincount(edge_cn, minlength=num_cn)
    dv = int(vn_deg.max()) if num_edges else 1
    dc = int(cn_deg.max()) if num_edges else 1
    n_pad = _aligned(num_vn)
    c_pad = _aligned(num_cn)

    # slot of edge e at its VN: rank among the VN's edges (CN order); at its
    # CN: rank among the CN's edges (VN order).  Edges are VN-major sorted,
    # so a running count per node gives both.
    def ranks(ids, count):
        out = np.zeros(num_edges, np.int32)
        fill = np.zeros(count, np.int32)
        for e in range(num_edges):
            out[e] = fill[ids[e]]
            fill[ids[e]] += 1
        return out

    vn_slot = ranks(edge_vn, num_vn)
    cn_slot = ranks(edge_cn, num_cn)

    cn_gather = np.full(dc * c_pad, num_vn, np.int32)  # pad -> slot 0 of a pad VN row
    vn_gather = np.full(dv * n_pad, num_cn, np.int32)  # pad -> slot 0 of a pad CN row
    vn_mask = np.zeros((dv, n_pad), np.float32)
    cn_mask = np.zeros((dc, c_pad), np.float32)
    edge_cn_byslot = np.full((dv, n_pad), num_cn, np.int32)
    edge_vn_byslot = np.full((dc, c_pad), num_vn, np.int32)

    vflat = vn_slot * n_pad + edge_vn
    cflat = cn_slot * c_pad + edge_cn
    cn_gather[cflat] = vflat
    vn_gather[vflat] = cflat
    vn_mask[vn_slot, edge_vn] = 1.0
    cn_mask[cn_slot, edge_cn] = 1.0
    edge_cn_byslot[vn_slot, edge_vn] = edge_cn
    edge_vn_byslot[cn_slot, edge_cn] = edge_vn

    return TannerGraph(
        num_vn=num_vn,
        num_cn=num_cn,
        n_pad=n_pad,
        c_pad=c_pad,
        num_edges=num_edges,
        max_vn_deg=dv,
        max_cn_deg=dc,
        cn_gather=cn_gather,
        vn_gather=vn_gather,
        vn_mask=vn_mask,
        cn_mask=cn_mask,
        vn_deg=np.pad(vn_deg.astype(np.float32), (0, n_pad - num_vn)),
        cn_deg=np.pad(cn_deg.astype(np.float32), (0, c_pad - num_cn)),
        edge_cn_byslot=edge_cn_byslot,
        edge_vn_byslot=edge_vn_byslot,
        edge_vn=edge_vn,
        edge_cn=edge_cn,
    )


def build_rowset(pcm: np.ndarray, vn_sentinel: int | None = None) -> RowSet:
    """Aligned slot-major per-row VN-id table for a PCM.  ``vn_sentinel``
    defaults to the first pad row of an [n_pad, B] source."""
    pcm = np.asarray(pcm)
    num_rows, num_vn = pcm.shape
    if vn_sentinel is None:
        vn_sentinel = num_vn
    deg = pcm.sum(axis=1).astype(np.int64)
    max_deg = int(deg.max()) if num_rows else 1
    r_pad = _aligned(num_rows)

    vn_idx = np.full((max_deg, r_pad), vn_sentinel, np.int32)
    mask = np.zeros((max_deg, r_pad), np.float32)
    row_valid = np.zeros(r_pad, np.float32)
    row_valid[:num_rows] = 1.0
    for r in range(num_rows):
        cols = np.nonzero(pcm[r])[0]
        vn_idx[: len(cols), r] = cols
        mask[: len(cols), r] = 1.0
    return RowSet(
        num_rows=num_rows,
        r_pad=r_pad,
        max_deg=max_deg,
        vn_idx=vn_idx,
        mask=mask,
        row_valid=row_valid,
        vn_sentinel=vn_sentinel,
    )


@dataclass(frozen=True)
class QuantumGraph:
    """Everything the BP4 decoder and the cascade need for one CSS code.

    Dense matrices are stored PADDED: hx/hz are [c_pad, n_pad], hx_perp etc.
    are [r_pad, n_pad], so syndrome and accounting matmuls operate directly
    on padded tensors.  True shapes are (gx.num_cn, n) etc.
    """

    n: int
    k: int
    gx: TannerGraph  # graph of hx
    gz: TannerGraph  # graph of hz
    hx: np.ndarray  # [gx.c_pad, n_pad] float32
    hz: np.ndarray  # [gz.c_pad, n_pad]
    hx_perp: np.ndarray  # [r_pad, n_pad]
    hz_perp: np.ndarray
    lx: np.ndarray
    lz: np.ndarray
    # true row counts of the perp/logical matrices (before padding)
    hx_perp_rows: int
    hz_perp_rows: int
    lx_rows: int
    lz_rows: int
    # boxplus row tables for check-satisfaction logits
    logit_rows_x: RowSet  # rows of pcm_x_perp (gathers llr_x)
    logit_rows_z: RowSet  # rows of pcm_z_perp (gathers llr_z)
    name: str = ""

    DENSE = ("hx", "hz", "hx_perp", "hz_perp", "lx", "lz")

    @property
    def n_pad(self):
        return self.gx.n_pad

    def to(self, device) -> "QuantumGraph":
        """The same graph with every array a tensor on ``device``."""
        g = _to_tensors(self, self.DENSE, device)
        return dataclasses.replace(
            g,
            gx=self.gx.to(device),
            gz=self.gz.to(device),
            logit_rows_x=self.logit_rows_x.to(device),
            logit_rows_z=self.logit_rows_z.to(device),
        )

    @staticmethod
    def from_code(code, stage_mode: bool = True) -> "QuantumGraph":
        pcm_x_perp = code.hz if stage_mode else code.hx_perp
        pcm_z_perp = code.hx if stage_mode else code.hz_perp
        gx = build_graph(code.hx)
        gz = build_graph(code.hz)
        n_pad = gx.n_pad

        def padm(m):
            m = np.asarray(m, np.float32)
            return pad_rows(m, _aligned(m.shape[0]), n_pad)

        return QuantumGraph(
            n=int(code.N),
            k=int(code.K),
            gx=gx,
            gz=gz,
            hx=pad_rows(np.asarray(code.hx, np.float32), gx.c_pad, n_pad),
            hz=pad_rows(np.asarray(code.hz, np.float32), gz.c_pad, n_pad),
            hx_perp=padm(code.hx_perp),
            hz_perp=padm(code.hz_perp),
            lx=padm(code.lx),
            lz=padm(code.lz),
            hx_perp_rows=int(np.asarray(code.hx_perp).shape[0]),
            hz_perp_rows=int(np.asarray(code.hz_perp).shape[0]),
            lx_rows=int(np.asarray(code.lx).shape[0]),
            lz_rows=int(np.asarray(code.lz).shape[0]),
            logit_rows_x=build_rowset(pcm_x_perp),
            logit_rows_z=build_rowset(pcm_z_perp),
            name=getattr(code, "name", ""),
        )
