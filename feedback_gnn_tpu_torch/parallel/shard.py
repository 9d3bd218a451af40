"""Edge partitioning of the Tanner graph across the ``edge`` axis, the port
of ``feedback_gnn_tpu/parallel/shard.py`` (NumPy on the host, array for
array equal to the JAX package's).

Check nodes, and with them their edges, PCM rows and logit rows, are
partitioned into contiguous blocks, one per edge rank.  Every rank keeps
the full VN state ``[*, n_pad, B]``; the only communication is a sum of the
per-VN partial message sums over the edge group (``decoders.graph_ops
.vn_sum``), one ``[n_pad, B]`` all-reduce per BP iteration.

Per-shard graphs keep the aligned slot-major invariants of codes/graph.py:

* every shard's tables are padded to the same shapes (same ``c_pad`` and
  row pads), so the stacked bundle has a uniform leading shard axis;
* each VN's local slots hold its local edges; unused slots point at a pad
  CN slot (zero by the masked CN update), so unmasked VN sums are exact per
  shard and sum to the global sum;
* RowSets carry ``row_valid`` masks that exclude alignment pads and
  phantom rows;
* ``vn_deg`` stays GLOBAL, so means taken after the sum divide correctly;
* logit RowSets are partitioned with the same CN blocks as the matching
  decoder graph, so the GNN's per-slot ``h_cn`` gathers stay local.

``shard_quantum_graph`` returns the stacked bundle (every array with a
leading shard axis, as the JAX package's); ``unstack_shard(stacked, i)``
is shard ``i``, the graph one edge rank keeps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..codes.graph import QuantumGraph, RowSet, TannerGraph, _aligned, pad_rows

__all__ = ["shard_quantum_graph", "unstack_shard", "shard_bounds"]


def shard_bounds(num_rows: int, num_shards: int):
    """Contiguous balanced partition [(start, end), ...]: the first
    ``num_rows % num_shards`` shards get one extra row."""
    base, rem = divmod(num_rows, num_shards)
    bounds, start = [], 0
    for s in range(num_shards):
        size = base + (1 if s < rem else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def _shard_tanner(graph: TannerGraph, num_shards: int):
    """Split one aligned TannerGraph into per-shard graphs with equal padded
    shapes; CN ids are local within each shard."""
    bounds = shard_bounds(graph.num_cn, num_shards)
    c_pad_s = _aligned(max(e - s for s, e in bounds))
    n, n_pad = graph.num_vn, graph.n_pad
    dv, dc = graph.max_vn_deg, graph.max_cn_deg
    edge_vn, edge_cn = np.asarray(graph.edge_vn), np.asarray(graph.edge_cn)

    shards = []
    for s, e in bounds:
        c_local = e - s
        sel = (edge_cn >= s) & (edge_cn < e)
        evn, ecn = edge_vn[sel], edge_cn[sel] - s

        cn_gather = np.full(dc * c_pad_s, n, np.int32)  # pad -> slot 0 of the pad VN row
        vn_gather = np.full(dv * n_pad, c_local, np.int32)  # pad -> slot 0 of the local pad CN row
        vn_mask = np.zeros((dv, n_pad), np.float32)
        cn_mask = np.zeros((dc, c_pad_s), np.float32)
        edge_cn_byslot = np.full((dv, n_pad), c_local, np.int32)
        edge_vn_byslot = np.full((dc, c_pad_s), n, np.int32)
        fill_v = np.zeros(n, np.int32)
        fill_c = np.zeros(c_local, np.int32)
        for v, c in zip(evn, ecn):
            sv, sc = fill_v[v], fill_c[c]
            vflat, cflat = sv * n_pad + v, sc * c_pad_s + c
            cn_gather[cflat] = vflat
            vn_gather[vflat] = cflat
            vn_mask[sv, v] = 1.0
            cn_mask[sc, c] = 1.0
            edge_cn_byslot[sv, v] = c
            edge_vn_byslot[sc, c] = v
            fill_v[v] = sv + 1
            fill_c[c] = sc + 1

        cn_deg = np.zeros(c_pad_s, np.float32)
        cn_deg[:c_local] = np.asarray(graph.cn_deg)[s:e]
        shards.append(TannerGraph(
            num_vn=n, num_cn=c_local, n_pad=n_pad, c_pad=c_pad_s, num_edges=int(sel.sum()),
            max_vn_deg=dv, max_cn_deg=dc, cn_gather=cn_gather, vn_gather=vn_gather,
            vn_mask=vn_mask, cn_mask=cn_mask,
            vn_deg=graph.vn_deg,  # GLOBAL degrees (means after the edge sum)
            cn_deg=cn_deg, edge_cn_byslot=edge_cn_byslot, edge_vn_byslot=edge_vn_byslot,
            edge_vn=np.pad(evn, (0, graph.num_edges - len(evn))),
            edge_cn=np.pad(ecn, (0, graph.num_edges - len(ecn))),
        ))
    # equal static fields across shards, as the JAX package's stacking
    # needs; the masks carry each shard's true structure
    shards = [dataclasses.replace(g, num_cn=shards[0].num_cn, num_edges=shards[0].num_edges)
              for g in shards]
    return shards, bounds, c_pad_s


def _shard_rows(mat: np.ndarray, bounds, r_pad: int):
    """PCM rows partitioned into equal zero-padded blocks [r_pad, n_cols]."""
    return [pad_rows(mat[s:e], r_pad) for s, e in bounds]


def _shard_rowset(rs: RowSet, bounds, r_pad: int):
    out = []
    for s, e in bounds:
        vn_idx = np.full((rs.max_deg, r_pad), rs.vn_sentinel, np.int32)
        mask = np.zeros((rs.max_deg, r_pad), np.float32)
        row_valid = np.zeros(r_pad, np.float32)
        vn_idx[:, : e - s] = rs.vn_idx[:, s:e]
        mask[:, : e - s] = rs.mask[:, s:e]
        row_valid[: e - s] = rs.row_valid[s:e]
        out.append(RowSet(num_rows=bounds[0][1] - bounds[0][0], r_pad=r_pad, max_deg=rs.max_deg,
                          vn_idx=vn_idx, mask=mask, row_valid=row_valid,
                          vn_sentinel=rs.vn_sentinel))
    return out


def _stack(items):
    """One dataclass whose array fields stack the items' along a new
    leading axis; the other fields come from the first item."""
    first = items[0]
    if isinstance(first, (TannerGraph, RowSet)):
        return dataclasses.replace(first, **{f: np.stack([getattr(x, f) for x in items])
                                             for f in first.ARRAYS})
    fields = {f: np.stack([getattr(x, f) for x in items]) for f in QuantumGraph.DENSE}
    for f in ("gx", "gz", "logit_rows_x", "logit_rows_z"):
        fields[f] = _stack([getattr(x, f) for x in items])
    return dataclasses.replace(first, **fields)


def _unstack(item, i: int):
    if isinstance(item, (TannerGraph, RowSet)):
        return dataclasses.replace(item, **{f: getattr(item, f)[i] for f in item.ARRAYS})
    fields = {f: getattr(item, f)[i] for f in QuantumGraph.DENSE}
    for f in ("gx", "gz", "logit_rows_x", "logit_rows_z"):
        fields[f] = _unstack(getattr(item, f), i)
    return dataclasses.replace(item, **fields)


def shard_quantum_graph(qg: QuantumGraph, num_shards: int) -> QuantumGraph:
    """The stacked sharded bundle of a host QuantumGraph: every array with
    a leading ``num_shards`` axis.  ``unstack_shard(stacked, i)`` is shard
    ``i``."""
    gx_shards, bx, cxp = _shard_tanner(qg.gx, num_shards)
    gz_shards, bz, czp = _shard_tanner(qg.gz, num_shards)
    hx_blocks = _shard_rows(np.asarray(qg.hx)[: qg.gx.num_cn], bx, cxp)
    hz_blocks = _shard_rows(np.asarray(qg.hz)[: qg.gz.num_cn], bz, czp)

    def independent(num_rows):
        b = shard_bounds(num_rows, num_shards)
        return b, _aligned(max(e - s for s, e in b))

    # logit rows: aligned with the decoder's CN partition when the true row
    # counts match (stage mode), else an independent contiguous partition
    def shard_logit_rows(rs: RowSet, decoder_bounds, decoder_pad, decoder_rows):
        if rs.num_rows == decoder_rows:
            return _shard_rowset(rs, decoder_bounds, decoder_pad)
        return _shard_rowset(rs, *independent(rs.num_rows))

    lrx = shard_logit_rows(qg.logit_rows_x, bz, czp, qg.gz.num_cn)
    lrz = shard_logit_rows(qg.logit_rows_z, bx, cxp, qg.gx.num_cn)

    # perp and logical matrices: independent row partitions (the accounting)
    def shard_perp(mat, true_rows):
        b, rp = independent(true_rows)
        return _shard_rows(np.asarray(mat)[:true_rows], b, rp), b[0][1] - b[0][0]

    hxp, hxp_rows = shard_perp(qg.hx_perp, qg.hx_perp_rows)
    hzp, hzp_rows = shard_perp(qg.hz_perp, qg.hz_perp_rows)
    lxm, lx_rows = shard_perp(qg.lx, qg.lx_rows)
    lzm, lz_rows = shard_perp(qg.lz, qg.lz_rows)

    per_shard = [
        QuantumGraph(
            n=qg.n, k=qg.k, gx=gx_shards[i], gz=gz_shards[i],
            hx=hx_blocks[i].astype(np.float32), hz=hz_blocks[i].astype(np.float32),
            hx_perp=hxp[i].astype(np.float32), hz_perp=hzp[i].astype(np.float32),
            lx=lxm[i].astype(np.float32), lz=lzm[i].astype(np.float32),
            hx_perp_rows=hxp_rows, hz_perp_rows=hzp_rows,
            lx_rows=max(1, lx_rows), lz_rows=max(1, lz_rows),
            logit_rows_x=lrx[i], logit_rows_z=lrz[i],
            name=f"{qg.name}@shard", is_shard=True,
        )
        for i in range(num_shards)
    ]
    return _stack(per_shard)


def unstack_shard(stacked: QuantumGraph, index: int) -> QuantumGraph:
    """Shard ``index`` of a stacked bundle: the host graph one edge rank
    keeps (``.to(device)`` puts it on the rank's device)."""
    return _unstack(stacked, index)
