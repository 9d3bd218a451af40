"""Slot-major graph primitives on a ``TannerGraph`` of tensors.

Message state is ``[d, node_pad, B]`` (degree slots leading, batch last;
see codes/graph.py).  Per-node reductions are leading-axis sums, and the
VN<->CN permutation is one flat row gather per direction.  Pad slots hold
exact zeros (graph invariants I1-I3), so no mask is needed in the sums.

``vn_sum`` takes the edge axis ``axis`` (a process group, or None): with
CN-partitioned edges each rank holds partial VN sums, and one sum over the
group completes them (parallel/shard.py).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import psum

__all__ = ["vn_sum", "gather_to_cn", "scatter_from_cn", "expand_vn", "pad_rows_to"]


def pad_rows_to(x, rows):
    """Zero-pad axis -2 up to ``rows`` (no-op if already that long): true
    node counts to the aligned ``n_pad`` / ``c_pad`` layout."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def vn_sum(msg, graph, axis=None):
    """Per-VN sum of edge messages: [dv, n_pad, B] -> [n_pad, B], summed
    over the edge group ``axis`` when the graph is a shard."""
    return psum(msg.sum(dim=0), axis)


def expand_vn(vals, graph):
    """Broadcast per-VN values to every slot: [n_pad, B] -> [dv, n_pad, B]."""
    return vals[None].expand((graph.max_vn_deg,) + tuple(vals.shape))


def gather_to_cn(msg, graph):
    """VN-slot messages into the CN frame: [dv, n_pad, B] -> [dc, c_pad, B]."""
    flat = msg.reshape(graph.max_vn_deg * graph.n_pad, -1)
    return flat[graph.cn_gather].reshape(graph.max_cn_deg, graph.c_pad, -1)


def scatter_from_cn(msg_cn, graph):
    """Back to the VN-slot layout: [dc, c_pad, B] -> [dv, n_pad, B], by the
    inverse flat gather."""
    flat = msg_cn.reshape(graph.max_cn_deg * graph.c_pad, -1)
    return flat[graph.vn_gather].reshape(graph.max_vn_deg, graph.n_pad, -1)
