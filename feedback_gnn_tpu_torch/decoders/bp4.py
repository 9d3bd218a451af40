"""Quaternary (GF(4)) syndrome BP on the slot-major gather layout.

The port of ``feedback_gnn_tpu/decoders/bp4.py``: two scalar message sets,
``msg_x`` on Hx edges (beliefs about the Z-component of the error) and
``msg_z`` on Hz edges (about X); a VN update that couples them through Y in
stable log space; the slot-major CN updates of decoders/cn_update.py with
the syndrome sign in the node product; check-satisfaction logits and the
argmin hard decision.  The quasi-cyclic decoder (decoders/bp4_qc.py)
shares the result type, logits and decisions.

PADDED CONVENTION: tensors keep the aligned padded shapes ([n_pad, B]
marginals and decisions with zero pad rows, [r_pad, B] logits).  Inputs
may be padded or true-shaped; they are padded on entry.

``axis`` (a process group, or None) runs the same code on one edge shard
of the graph (parallel/shard.py): the per-VN sums are summed over the
group, so the marginals and decisions are replicated, while messages,
syndromes and check logits stay shard-local.  The marginals are marked
with ``pvary`` where they enter shard-local work, so that autograd sums
their cotangents over the group.

Spans (obs.py): ``bp4.vn`` each VN update (both sides), ``bp4.cn`` each CN
update with its gather and scatter (both sides), both with the attribute
``iteration``, and ``bp4.logits`` the final check logits.  Counter
``bp4.decodes``, card calls only, keyed by (batch, iterations, CN rule,
(VN slots, CN slots)), the slot counts the larger of the two sides'.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import obs
from ..parallel.collectives import pvary
from .cn_update import CN_UPDATES, boxplus_rows, cn_update_phi, softplus
from .graph_ops import expand_vn, gather_to_cn, pad_rows_to, scatter_from_cn, vn_sum

__all__ = ["BP4Result", "bp4_decode", "quaternary_to_binary_llrs", "hard_decision"]


class BP4Result(NamedTuple):
    llrx: torch.Tensor  # [n_pad, B] marginal LLR of an X flip (pad rows 0)
    llry: torch.Tensor
    llrz: torch.Tensor
    x_hat: torch.Tensor  # [n_pad, B] int32 hard decision (pad rows 0)
    z_hat: torch.Tensor
    x_logit: torch.Tensor | None  # [r_pad, B] check logits over pcm_x_perp rows
    z_logit: torch.Tensor | None
    logit_stack: tuple | None  # (xs, zs) [num_iter+1, r_pad, B] each, or None


def _logsumexp2(a, b):
    """logsumexp over two tensors."""
    mx = torch.maximum(a, b)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


def _marginals(msg_x, msg_z, llr_ch, graph, axis):
    """(llrx, llry, llrz) [n_pad, B] of the messages, marked for the
    shard-local work that consumes them."""
    s_z = vn_sum(msg_z, graph.gz, axis)  # contributes to the X belief
    s_x = vn_sum(msg_x, graph.gx, axis)  # contributes to the Z belief
    llr = (s_z + llr_ch[0], s_x + s_z + llr_ch[1], s_x + llr_ch[2])
    return llr if axis is None else pvary(torch.stack(llr), axis).unbind(0)


def _vn_update(msg_x, msg_z, llr_ch, graph, axis=None):
    """Coupled VN update.  Returns (new_msg_x, new_msg_z, llrx, llry, llrz);
    llr* are [n_pad, B]."""
    gx, gz = graph.gx, graph.gz
    llrx, llry, llrz = _marginals(msg_x, msg_z, llr_ch, graph, axis)

    # extrinsic per-edge messages, Hx side (about the Z / Y components)
    llrz_hx = expand_vn(llrz, gx) - msg_x
    llry_hx = expand_vn(llry, gx) - msg_x
    new_msg_x = expand_vn(softplus(-llrx), gx) - _logsumexp2(-llrz_hx, -llry_hx)

    # Hz side
    llrx_hz = expand_vn(llrx, gz) - msg_z
    llry_hz = expand_vn(llry, gz) - msg_z
    new_msg_z = expand_vn(softplus(-llrz), gz) - _logsumexp2(-llrx_hz, -llry_hz)
    return new_msg_x, new_msg_z, llrx, llry, llrz


def quaternary_to_binary_llrs(llrx, llry, llrz):
    """Binary LLRs from quaternary marginals:
    llr_z = log((pI+pX)/(pZ+pY)), llr_x = log((pI+pZ)/(pX+pY)).
    Zero pad rows map to llr 0."""
    llr_z = softplus(-llrx) - _logsumexp2(-llrz, -llry)
    llr_x = softplus(-llrz) - _logsumexp2(-llrx, -llry)
    return llr_x, llr_z


def _cal_logit(llrx, llry, llrz, graph, phi_impl=None):
    """Check-satisfaction logits over pcm_x_perp / pcm_z_perp rows."""
    llr_x, llr_z = quaternary_to_binary_llrs(llrx, llry, llrz)
    x_logit = boxplus_rows(llr_x, graph.logit_rows_x, phi_impl)
    z_logit = boxplus_rows(llr_z, graph.logit_rows_z, phi_impl)
    return x_logit, z_logit


def hard_decision(llrx, llry, llrz):
    """argmin over (0, llrx, llrz, llry) -> Pauli in {I,X,Z,Y}, first
    minimum on ties.  Returns int32 (x_hat, z_hat); zero rows decide I."""
    stacked = torch.stack([torch.zeros_like(llrx), llrx, llrz, llry], dim=0)
    decision = torch.argmin(stacked, dim=0).to(torch.int32)
    return decision & 1, decision >> 1


def bp4_decode(graph, llr_ch, syndrome_x, syndrome_z, num_iter: int,
               cn_type: str = "boxplus-phi", normalization_factor: float = 1.0,
               collect_logits: bool = False, phi_impl: str | None = None,
               axis=None) -> BP4Result:
    """Run ``num_iter`` BP4 iterations.

    Args:
      graph: a ``QuantumGraph`` of tensors (``QuantumGraph.to(device)``).
      llr_ch: [3, n(,pad), B] channel LLRs in (x, y, z) order (pad rows, if
        present, must be zero).
      syndrome_x / syndrome_z: [mx(,pad), B] / [mz(,pad), B] in {0, 1}.
      collect_logits: also return the per-iteration check-logit stack of
        the deep-supervision training loss.
      phi_impl: phi formulation of boxplus-phi CN updates and of the
        check-satisfaction logits (None = the cn_update default).
      axis: the edge group when ``graph`` is an edge shard, else None.
    """
    if cn_type == "boxplus-phi":
        def cn_update(msg, syn_pm, mask):
            return cn_update_phi(msg, syn_pm, mask, phi_impl)
    else:
        cn_update = CN_UPDATES[cn_type]
    gx, gz = graph.gx, graph.gz
    b = llr_ch.shape[-1]
    dev = llr_ch.device
    if llr_ch.is_cuda:
        slots = (max(gx.max_vn_deg, gz.max_vn_deg), max(gx.max_cn_deg, gz.max_cn_deg))
        obs.count("bp4.decodes", key=(b, num_iter, cn_type, slots))

    llr_ch = pad_rows_to(llr_ch.to(torch.float32), gx.n_pad)
    syn_x_pm = 1.0 - 2.0 * pad_rows_to(syndrome_x.to(torch.float32), gx.c_pad)
    syn_z_pm = 1.0 - 2.0 * pad_rows_to(syndrome_z.to(torch.float32), gz.c_pad)

    msg_x = torch.zeros((gx.max_vn_deg, gx.n_pad, b), dtype=torch.float32, device=dev)
    msg_z = torch.zeros((gz.max_vn_deg, gz.n_pad, b), dtype=torch.float32, device=dev)
    xs, zs = [], []
    for it in range(num_iter):
        with obs.span("bp4.vn", iteration=it):
            new_msg_x, new_msg_z, llrx, llry, llrz = _vn_update(msg_x, msg_z, llr_ch, graph, axis)
        if collect_logits:
            x_logit, z_logit = _cal_logit(llrx, llry, llrz, graph, phi_impl)
            xs.append(x_logit)
            zs.append(z_logit)
        with obs.span("bp4.cn", iteration=it):
            mcx = cn_update(gather_to_cn(new_msg_x, gx), syn_x_pm, gx.cn_mask) * normalization_factor
            msg_x = scatter_from_cn(mcx, gx)
            mcz = cn_update(gather_to_cn(new_msg_z, gz), syn_z_pm, gz.cn_mask) * normalization_factor
            msg_z = scatter_from_cn(mcz, gz)

    # final marginals and logits
    llrx, llry, llrz = _marginals(msg_x, msg_z, llr_ch, graph, axis)
    with obs.span("bp4.logits"):
        x_logit, z_logit = _cal_logit(llrx, llry, llrz, graph, phi_impl)

    logit_stack = None
    if collect_logits:
        # [num_iter+1, ...]: iteration it at slot it, the final logits last
        logit_stack = (torch.stack(xs + [x_logit]), torch.stack(zs + [z_logit]))
    x_hat, z_hat = hard_decision(llrx, llry, llrz)
    return BP4Result(llrx, llry, llrz, x_hat, z_hat, x_logit, z_logit, logit_stack)
