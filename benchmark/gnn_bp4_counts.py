"""Least time on an H100 of a GNN_BP4 decode (reference/gnn_bp4.py): its
float32 operations and the bytes its embeddings must move, from the code's
edges and nodes and the configuration's widths.

Operations are those of the dense layers on the true edges and nodes, a
multiply-add counting 2 (the aggregation, the activations and the boxplus
are left out):

* message MLP: 2 (2e h + (depth - 2) h^2 + h m) an edge, for each side's
  VN update and CN update (four MLPs, each on its side's edges);
* VN embed MLP: 2 ((2m + e) h + (depth - 2) h^2 + h e) a VN;
* CN embed MLP: 2 ((m + e + 1) h + (depth - 2) h^2 + h e) a CN of each side;
* llr_inv_embed: 2 e 3 a VN;

with e, m, h the embed, message and hidden widths; ``num_iter`` VN updates,
as many CN updates (the first one counted, the one after the last VN
update not made) and as many logits.  At [[882,24]]'s trained widths that
is 4,800 an edge, 6,400 a VN, 4,880 a CN and 120 a VN: about 60.9 MFLOP an
iteration and 0.487 GFLOP a syndrome.

Bytes are the embeddings' compulsory traffic, float32: each update reads
the embeddings it takes once and writes the one it makes once (a VN update
reads both sides' CN embeddings and the VN's, a CN update of a side the VN
embeddings, its CN embeddings and its logits), the logits read the VN
embeddings and write the check and logical rows' logits; the syndromes are
read once and the decisions written once.  The bound is the larger of the
two times; at the trained widths the operations bound it.
"""

from __future__ import annotations

from . import counts

__all__ = ["Dims", "dims_of", "gnn_bp4_flops", "gnn_bp4_bytes", "gnn_bp4_bound_ms"]


class Dims:
    """A code's numbers that the counts need: VNs, CNs and edges a side,
    logical rows a side."""

    def __init__(self, n, m_x, m_z, edges_x, edges_z, k_x, k_z):
        self.n, self.m_x, self.m_z = n, m_x, m_z
        self.edges_x, self.edges_z, self.k_x, self.k_z = edges_x, edges_z, k_x, k_z


def dims_of(code) -> Dims:
    """The Dims of a ``reference.codes.Code`` (k logical rows a side)."""
    return Dims(code.n, code.hx.shape[0], code.hz.shape[0], int(code.hx.sum()), int(code.hz.sum()), code.k, code.k)


def _mlp(fan_in, hidden, depth, out):
    """Multiply-adds of a ``depth``-layer MLP, times 2."""
    dims = [fan_in] + [hidden] * (depth - 1) + [out]
    return 2 * sum(a * b for a, b in zip(dims, dims[1:]))


def gnn_bp4_flops(d: Dims, widths, batch):
    """Float32 operations of one decode of ``batch`` syndromes."""
    e, m, h = int(widths["num_embed_dims"]), int(widths["num_msg_dims"]), int(widths["num_hidden_units"])
    depth, iters = int(widths["num_mlp_layers"]), int(widths["num_iter"])
    msg = _mlp(2 * e, h, depth, m) * (d.edges_x + d.edges_z)
    vn = msg + d.n * _mlp(2 * m + e, h, depth, e)
    cn = msg + (d.m_x + d.m_z) * _mlp(m + e + 1, h, depth, e)
    logits = d.n * 2 * e * 3
    return batch * iters * (vn + cn + logits)


def gnn_bp4_bytes(d: Dims, widths, batch):
    """Compulsory bytes of one decode of ``batch`` syndromes."""
    e, iters = int(widths["num_embed_dims"]), int(widths["num_iter"])
    cns = d.m_x + d.m_z
    vn = (cns + d.n) * e + d.n * e
    cn = (d.n + cns) * e + cns + cns * e  # the VN embeddings once for both sides
    logits = d.n * e + (cns + d.k_x + d.k_z)
    return 4 * batch * (iters * (vn + cn + logits) + cns + 2 * d.n)


def gnn_bp4_bound_ms(d: Dims, widths, batch):
    """Least time of one decode on an H100: (ms, "operations" or "bytes")."""
    t_ops = gnn_bp4_flops(d, widths, batch) / counts.H100_F32_OPS
    t_bytes = gnn_bp4_bytes(d, widths, batch) / counts.H100_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
