"""Operations and bytes of the work the cells run, computed from shapes, and
the card's published peaks: the yardstick of the roofline and utilization
metrics.

K1 and K2's counts are those of the port's kernel table (read off
csrc/bp4_qc.cu and csrc/bp2_qc.cu: float32 operations per edge and
iteration, transcendentals counted as one each), frozen here.  A QC side is
anything with ``l``, ``mb``, ``nb`` and ``num_groups`` (``reference.codes.
QCSpec``).
"""

from __future__ import annotations

__all__ = ["H100_F32_OPS", "H100_BYTES", "k1_ops", "k1_bytes", "k1_bound_ms", "k2_bound_ms",
           "gnn_ops", "gf2_ops"]

H100_F32_OPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3, H100 SXM data sheet

VN_OPS_PER_EDGE = 12  # sum-add, two subs, lse_neg (8), sub
VN_OPS_PER_NODE = 18  # marginals (4 adds), two softplus (7 each)
CN_OPS_PER_EDGE = {
    ("boxplus-phi", None): 24,  # sign, abs, 2 phi (8 each, tanh form), 5 mul/add
    ("boxplus-phi", "expm1"): 24,
    ("boxplus-phi", "tf"): 36,  # phi in the tf form: 14 each
    ("boxplus-phi", "accurate"): 28,  # phi in the accurate form: 10 each
    ("boxplus", None): 14,
    ("minsum", None): 15,
}
# the bfloat16 carry's rounding of each CN output, per edge and iteration
CARRY_OPS_PER_EDGE = {"float32": 0, "bfloat16": 2}
K2_VN_OPS_PER_EDGE = 2


def _k1_dims(qx, qz):
    l = qx.l
    n = qx.nb * l
    m = (qx.mb + qz.mb) * l
    edges = (qx.num_groups + qz.num_groups) * l
    return n, m, edges


def k1_ops(qx, qz, batch, iters, cn_type="boxplus-phi", phi_impl=None, msg_dtype="float32"):
    """Float32 operations of one K1 decode."""
    n, m, edges = _k1_dims(qx, qz)
    rule = (cn_type, phi_impl if cn_type == "boxplus-phi" else None)
    cn = CN_OPS_PER_EDGE[rule] + CARRY_OPS_PER_EDGE[msg_dtype]
    per_iter = edges * (VN_OPS_PER_EDGE + cn) + n * VN_OPS_PER_NODE + m
    return batch * (iters * per_iter + edges + 4 * n)


def k1_bytes(qx, qz, batch):
    """LLRs and syndromes read once, marginals written once."""
    n, m, _ = _k1_dims(qx, qz)
    return 4 * batch * (3 * n + m) + 4 * batch * 3 * n


def k1_bound_ms(qx, qz, batch, iters, cn_type="boxplus-phi", phi_impl=None, msg_dtype="float32"):
    """Least time of one K1 decode on an H100: (ms, "bytes" or "operations")."""
    t_bytes = k1_bytes(qx, qz, batch) / H100_BYTES
    t_ops = k1_ops(qx, qz, batch, iters, cn_type, phi_impl, msg_dtype) / H100_F32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound_ms(spec, batch, iters, cn_type):
    """Least time of one K2 (binary BP) decode on an H100."""
    n, m, edges = spec.nb * spec.l, spec.mb * spec.l, spec.num_edges
    nbytes = 4 * batch * (n + m + n)
    per_iter = edges * (K2_VN_OPS_PER_EDGE + CN_OPS_PER_EDGE[(cn_type, None)]) + m
    ops = batch * (iters * per_iter + 3 * n + 2 * m + edges + n)
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_F32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gnn_ops(n, edges_x, edges_z, hidden, msg_dims, embed_layers, batch):
    """Float32 operations of one feedback-GNN step over ``batch`` samples of
    a code with ``n`` qubits: multiply-adds as 2, an elementwise operation or
    a tanh as 1, on the true edges and VNs (padding excluded).

    Per side: the per-VN part of edge layer 0 (3 inputs), per edge the check
    term, tanh, mask and sum (5 a hidden unit), the mean, and layer 1
    (hidden -> msg_dims); then the embed layers (2 msg_dims + 3 inputs, tanh)
    and the output layer (hidden -> 3)."""
    per_side_vn = 2 * 3 * hidden + hidden + hidden + 2 * hidden * msg_dims + msg_dims
    ops = 2 * n * per_side_vn + 5 * hidden * (edges_x + edges_z)
    fan_in = 2 * msg_dims + 3
    for _ in range(embed_layers):
        ops += n * (2 * fan_in * hidden + 2 * hidden)
        fan_in = hidden
    ops += n * (2 * hidden * 3 + 3)
    return batch * ops


def gf2_ops(nnz, batch):
    """A product of a sparse 0/1 matrix with ``batch`` vectors over GF(2):
    one operation per nonzero and vector."""
    return nnz * batch
