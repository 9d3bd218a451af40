"""Quaternary (GF(4)) BP: result type, LLR conversion, logits, decisions.

The parts of ``feedback_gnn_tpu/decoders/bp4.py`` that the quasi-cyclic
decoder (decoders/bp4_qc.py) shares.  The gather decoder ``bp4_decode`` is
not ported yet.

PADDED CONVENTION: tensors keep the aligned padded shapes ([n_pad, B]
marginals and decisions with zero pad rows, [r_pad, B] logits).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cn_update import boxplus_rows, softplus

__all__ = ["BP4Result", "quaternary_to_binary_llrs", "hard_decision"]


class BP4Result(NamedTuple):
    llrx: torch.Tensor  # [n_pad, B] marginal LLR of an X flip (pad rows 0)
    llry: torch.Tensor
    llrz: torch.Tensor
    x_hat: torch.Tensor  # [n_pad, B] int32 hard decision (pad rows 0)
    z_hat: torch.Tensor
    x_logit: torch.Tensor | None  # [r_pad, B] check logits over pcm_x_perp rows
    z_logit: torch.Tensor | None
    logit_stack: tuple | None  # always None here (eval only)


def _logsumexp2(a, b):
    """logsumexp over two tensors."""
    mx = torch.maximum(a, b)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


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
