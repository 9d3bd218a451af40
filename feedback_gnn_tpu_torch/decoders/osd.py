"""Batched order-0 ordered-statistics decoding (OSD-0).

The port of ``feedback_gnn_tpu/decoders/osd.py``: sort the qubits by
reliability, append the syndrome column, run a rank-step batched GF(2)
Gauss-Jordan elimination with first-one pivoting per row, scatter the
solution back through the inverse sort.

The elimination is integer only, so its solutions equal the JAX package's
bit for bit on the same inputs: the sort is stable (as ``jnp.argsort``;
LLR ties are common) and ``torch.argmax`` returns the first maximum (as
``jnp.argmax``).  The table is stored as uint8, a quarter of the JAX
package's int32 bytes: [B, rank, n+1] = [B, 441, 883] is 389 KB per sample
on [[882,24]].

``bp_osd_correct`` runs OSD on the BP-flagged samples; with ``compact_cap``
it first gathers them into a dense sub-batch of that size (stable sort,
flagged first), and flagged samples beyond the capacity keep their BP
estimate and are counted as overflow.
"""

from __future__ import annotations

import torch

from ..ops.gf2mat import mod2_matmul
from .bp4 import quaternary_to_binary_llrs
from .cascade import _flagged_first
from .graph_ops import pad_rows_to

__all__ = ["osd0_decode", "bp_osd_correct"]


def osd0_decode(llr, pcm, syndrome):
    """OSD-0 decode on ``llr``'s device.

    Args:
      llr: [B, n] float32 reliabilities, sorted ascending (the least
        reliable, most likely flipped columns first).
      pcm: [rank, n] 0/1, a full-rank parity-check basis (tensor or array).
      syndrome: [rank, B] 0/1, the pivot-reduced syndromes.

    Returns e_hat [B, n] int32.
    """
    bsz, n = llr.shape
    dev = llr.device
    pcm = torch.as_tensor(pcm, device=dev).to(torch.uint8)
    rank = pcm.shape[0]

    sort_order = torch.argsort(llr, dim=-1, stable=True)  # [B, n]
    inv_sort = torch.argsort(sort_order, dim=-1)  # a permutation: no ties

    # permuted pcm per sample + syndrome column: [B, rank, n+1]
    tab = torch.empty((bsz, rank, n + 1), dtype=torch.uint8, device=dev)
    tab[:, :, :n] = pcm.T[sort_order].transpose(1, 2)
    tab[:, :, n] = torch.as_tensor(syndrome, device=dev).T.to(torch.uint8)

    pivots = torch.empty((bsz, rank), dtype=torch.int64, device=dev)
    samples = torch.arange(bsz, device=dev)
    for row in range(rank):
        current = tab[:, row, :].clone()  # [B, n+1]
        idx_p = torch.argmax(current, dim=-1)  # leftmost 1 of the row
        pivots[:, row] = idx_p
        c = tab[samples, :, idx_p]  # [B, rank]: the pivot column
        c[:, row] = 0  # the pivot row itself stays
        tab ^= c[:, :, None] & current[:, None, :]

    sol = tab[:, :, n].to(torch.int32)  # [B, rank]
    # a full-rank basis gives every row its own pivot column
    e_sorted = torch.zeros((bsz, n), dtype=torch.int32, device=dev).scatter_(1, pivots, sol)
    return e_sorted.gather(1, inv_sort)


def bp_osd_correct(graph, bp_result, noise_x, noise_z, pivot_hx, pivot_hz, hx_basis, hz_basis,
                   compact_cap: int | None = None):
    """BP4 + OSD-0 correction step: OSD replaces the BP estimate of every
    BP-flagged sample.

    Args:
      graph: a ``QuantumGraph`` of tensors.
      bp_result: ``BP4Result`` of the decode.
      noise_x / noise_z: [n(,pad), B] 0/1 true errors.
      pivot_hx / pivot_hz: row indices of the full-rank bases.
      hx_basis / hz_basis: [rank, n] full-rank PCMs.

    Returns (x_hat, z_hat, flagged [B] bool, overflow 0-d int), x_hat and
    z_hat int32 [n_pad, B]; the overflow counts flagged samples beyond
    ``compact_cap`` (0 without a cap).
    """
    hx, hz, n = graph.hx, graph.hz, graph.n
    noise_x = pad_rows_to(noise_x.to(torch.int32), graph.n_pad)
    noise_z = pad_rows_to(noise_z.to(torch.int32), graph.n_pad)
    dev = noise_x.device
    # flagged = BP failed to reproduce the syndrome
    x_diff = noise_x ^ bp_result.x_hat
    z_diff = noise_z ^ bp_result.z_hat
    flagged = (mod2_matmul(hz, x_diff) != 0).any(dim=0) | (mod2_matmul(hx, z_diff) != 0).any(dim=0)

    # binary reliabilities from the quaternary marginals, true qubit rows
    osd_llrx, osd_llrz = quaternary_to_binary_llrs(
        bp_result.llrx[:n], bp_result.llry[:n], bp_result.llrz[:n])

    # pivot-reduced syndromes of the true noise
    red_sx = mod2_matmul(hx, noise_z)[torch.as_tensor(pivot_hx, device=dev)]
    red_sz = mod2_matmul(hz, noise_x)[torch.as_tensor(pivot_hz, device=dev)]

    if compact_cap is not None:
        cap = min(flagged.shape[0], int(compact_cap))
        idx, valid = _flagged_first(flagged, cap)
        z_osd = pad_rows_to(osd0_decode(osd_llrz.T[idx], hx_basis, red_sx[:, idx]).T, graph.n_pad)
        x_osd = pad_rows_to(osd0_decode(osd_llrx.T[idx], hz_basis, red_sz[:, idx]).T, graph.n_pad)
        upd = valid[None, :]
        x_hat = bp_result.x_hat.index_copy(1, idx, torch.where(upd, x_osd, bp_result.x_hat[:, idx]))
        z_hat = bp_result.z_hat.index_copy(1, idx, torch.where(upd, z_osd, bp_result.z_hat[:, idx]))
        # flagged samples beyond the capacity keep their BP estimate: not
        # the reference's result, so the caller must see the count
        overflow = flagged.sum(dtype=torch.int32) - valid.sum(dtype=torch.int32)
        return x_hat, z_hat, flagged, overflow

    z_osd = pad_rows_to(osd0_decode(osd_llrz.T, hx_basis, red_sx).T, graph.n_pad)
    x_osd = pad_rows_to(osd0_decode(osd_llrx.T, hz_basis, red_sz).T, graph.n_pad)
    x_hat = torch.where(flagged[None, :], x_osd, bp_result.x_hat)
    z_hat = torch.where(flagged[None, :], z_osd, bp_result.z_hat)
    return x_hat, z_hat, flagged, torch.zeros((), dtype=torch.int32, device=dev)
