"""Least time on an H100 of a gather BP4 decode (reference/gather_bp4.py):
its float32 operations and the bytes it must move, from the true edges and
nodes of the reference's code, never the program's padded slots, so that a
decode which skips the padding is measured against the same work.

Operations a syndrome, with counts.py's constants (K1's table): each
iteration a VN update (``VN_OPS_PER_EDGE`` an edge, ``VN_OPS_PER_NODE`` a
qubit) and a CN update (``CN_OPS_PER_EDGE[rule]`` an edge, one a check for
its syndrome sign) on the edges of both sides; the channel LLRs' set-up (an
operation an edge and four a qubit); and the final check logits, boxplus
over the rows of hz and hx (``LOGIT_OPS_PER_EDGE`` a row's edge: sign, abs,
phi, product and sum; ``LOGIT_OPS_PER_ROW`` a row: phi and its sign;
``BINARY_OPS_PER_NODE`` a qubit: its two binary LLRs, each a softplus and a
two-term log-sum-exp).  That is iterations x (edges x 36 + n x 18 + m) +
edges + 4 n + the logits.

Bytes are counts.k1_bytes's: the LLRs and syndromes read once and the
marginals written once.  The bound is the larger of the two times.
"""

from __future__ import annotations

from . import counts

__all__ = ["Dims", "dims_of", "gather_bp4_ops", "gather_bp4_bytes", "gather_bp4_bound_ms",
           "LOGIT_OPS_PER_EDGE", "LOGIT_OPS_PER_ROW", "BINARY_OPS_PER_NODE"]

LOGIT_OPS_PER_EDGE = 12  # sign, abs, phi (8), sign product, sum
LOGIT_OPS_PER_ROW = 9  # phi (8), sign
BINARY_OPS_PER_NODE = 32  # two binary LLRs: softplus (7) and a log-sum-exp (9) each


class Dims:
    """A code's qubits, checks (both sides) and true edges (both sides)."""

    def __init__(self, n, m, edges):
        self.n, self.m, self.edges = n, m, edges


def dims_of(code) -> Dims:
    """The Dims of a ``reference.codes.Code``."""
    return Dims(code.n, code.hx.shape[0] + code.hz.shape[0], int(code.hx.sum()) + int(code.hz.sum()))


def gather_bp4_ops(d: Dims, batch, iters, cn_type="boxplus-phi", phi_impl="expm1"):
    """Float32 operations of one decode of ``batch`` syndromes."""
    rule = (cn_type, phi_impl if cn_type == "boxplus-phi" else None)
    per_iter = d.edges * (counts.VN_OPS_PER_EDGE + counts.CN_OPS_PER_EDGE[rule]) + d.n * counts.VN_OPS_PER_NODE + d.m
    logits = d.edges * LOGIT_OPS_PER_EDGE + d.m * LOGIT_OPS_PER_ROW + d.n * BINARY_OPS_PER_NODE
    return batch * (iters * per_iter + d.edges + 4 * d.n + logits)


def gather_bp4_bytes(d: Dims, batch):
    """LLRs and syndromes read once, marginals written once."""
    return 4 * batch * (3 * d.n + d.m) + 4 * batch * 3 * d.n


def gather_bp4_bound_ms(d: Dims, batch, iters, cn_type="boxplus-phi", phi_impl="expm1"):
    """Least time of one decode on an H100: (ms, "operations" or "bytes")."""
    t_ops = gather_bp4_ops(d, batch, iters, cn_type, phi_impl) / counts.H100_F32_OPS
    t_bytes = gather_bp4_bytes(d, batch) / counts.H100_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
