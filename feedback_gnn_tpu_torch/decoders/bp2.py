"""Binary syndrome belief propagation on the slot-major gather layout.

The port of ``feedback_gnn_tpu/decoders/bp2.py``:

* input is a logit tensor (positive = bit 1); it is clipped to +-20, padded
  to ``n_pad`` and negated into "true" LLRs;
* flooding VN update (extrinsic sum) and CN update with the syndrome sign
  multiplied into the node product; ``syndrome=None`` decodes classically
  (neutral +1 signs);
* output is the marginal logit (negated back) and its hard decision
  ``logit > 0``.

Messages are slot-major ``[dv, n_pad, B]`` (codes/graph.py).  Outputs keep
the padded [n_pad, B] shape (0-logit pad rows); slice [:n] for true
shapes.  ``axis`` (a process group, or None) decodes on one edge shard of
the graph: the per-VN sums are summed over the group (decoders/bp4.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.collectives import pvary
from ..sim.metrics import llr2mi
from .cn_update import CN_UPDATES, LLR_MAX
from .graph_ops import expand_vn, gather_to_cn, pad_rows_to, scatter_from_cn, vn_sum

__all__ = ["BP2Result", "bp2_decode"]


class BP2Result(NamedTuple):
    logits: torch.Tensor  # [n_pad, B] marginal logits (pad rows 0)
    hard: torch.Tensor  # [n_pad, B] int32 hard decisions (pad rows 0)
    # EXIT trajectories [num_iter+1] (slot 0 = 0), only when track_exit=True
    ie_v: torch.Tensor | None = None
    ie_c: torch.Tensor | None = None


def bp2_decode(graph, llr_ch, syndrome, num_iter: int, cn_type: str = "boxplus-phi",
               normalization_factor: float = 1.0, edge_weights=None,
               track_exit: bool = False, axis=None) -> BP2Result:
    """Run ``num_iter`` binary syndrome-BP iterations.

    Args:
      graph: a ``TannerGraph`` of tensors (``build_graph(pcm).to(device)``).
      llr_ch: [n(,pad), B] channel logits (positive = bit 1 likely).
      syndrome: [num_cn(,pad), B] in {0, 1}, or None for classical
        (non-syndrome) decoding.
      edge_weights: optional [dv, n_pad] per-edge weights multiplied onto
        the outgoing VN messages (weighted BP).
      track_exit: record the EXIT trajectory, the Hagenauer MI estimate of
        the VN- and CN-phase messages per iteration (assumes all-zero-
        codeword symmetry).
      axis: the edge group when ``graph`` is an edge shard, else None
        (the EXIT trajectory then averages the shard's own edges).
    """
    cn_update = CN_UPDATES[cn_type]
    b = llr_ch.shape[-1]
    dev = llr_ch.device

    llr = llr_ch.to(torch.float32).clamp(-LLR_MAX, LLR_MAX)
    llr = -pad_rows_to(llr, graph.n_pad)  # logits -> "true" llrs
    if syndrome is None:  # classical decoding: neutral +1 sign everywhere
        syn_pm = torch.ones((graph.c_pad, b), dtype=torch.float32, device=dev)
    else:
        syn_pm = 1.0 - 2.0 * pad_rows_to(syndrome.to(torch.float32), graph.c_pad)
    cn_mask, vn_mask = graph.cn_mask, graph.vn_mask
    if edge_weights is not None:
        edge_weights = torch.as_tensor(edge_weights, dtype=torch.float32, device=dev)[:, :, None]

    msg = torch.zeros((graph.max_vn_deg, graph.n_pad, b), dtype=torch.float32, device=dev)
    # EXIT trajectories: iteration it at slot it (1-based), slot 0 stays 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ie_v, ie_c = [zero], [zero]
    for _ in range(num_iter):
        # extrinsic VN update
        total = pvary(vn_sum(msg, graph, axis) + llr, axis)  # [n_pad, B]
        msg_v = expand_vn(total, graph) - msg  # [dv, n_pad, B]
        if track_exit:
            ie_v.append(llr2mi(-msg_v, weight=vn_mask[:, :, None]))
        if edge_weights is not None:
            msg_v = msg_v * edge_weights
        # CN update with syndrome sign
        mc = cn_update(gather_to_cn(msg_v, graph), syn_pm, cn_mask) * normalization_factor
        if track_exit:
            ie_c.append(llr2mi(-mc, weight=cn_mask[:, :, None]))
        msg = scatter_from_cn(mc, graph)

    logits = -(llr + vn_sum(msg, graph, axis))  # back to the logit convention
    hard = (logits > 0.0).to(torch.int32)
    if track_exit:
        return BP2Result(logits, hard, torch.stack(ie_v), torch.stack(ie_c))
    return BP2Result(logits, hard)
