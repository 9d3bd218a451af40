"""Error-counting metrics and the Hagenauer mutual-information estimate,
as ``feedback_gnn_tpu/sim/metrics.py`` computes them."""

from __future__ import annotations

import math

import torch

__all__ = [
    "count_errors",
    "count_block_errors",
    "compute_ber",
    "compute_bler",
    "hard_decisions",
    "llr2mi",
]


def hard_decisions(llr):
    """Logit > 0 -> bit 1."""
    return (llr > 0).to(torch.int32)


def count_errors(b, b_hat):
    """Number of differing bits."""
    return (b != b_hat).to(torch.int64).sum()


def count_block_errors(b, b_hat, dim=-1):
    """Number of rows differing anywhere along ``dim``."""
    return (b != b_hat).any(dim=dim).to(torch.int64).sum()


def compute_ber(b, b_hat):
    return count_errors(b, b_hat) / b.numel()


def compute_bler(b, b_hat, dim=-1):
    return (b != b_hat).any(dim=dim).to(torch.float64).mean()


def llr2mi(llr, s=None, weight=None):
    """Hagenauer mutual-information approximation from LLRs:

        I ~ 1 - mean(log2(1 + exp(llr_zero))),  llr_zero clipped to +-20,

    where ``llr_zero = s * llr`` scrambles signs as if the all-zero codeword
    was sent.  ``weight`` (optional, broadcastable, {0,1}) restricts the
    mean to valid entries, e.g. the true edges of a padded slot layout."""
    llr = torch.as_tensor(llr, dtype=torch.float32)
    if s is not None:
        llr = llr * s
    llr = llr.clamp(-20.0, 20.0)
    x = torch.log(1.0 + torch.exp(llr)) / math.log(2.0)
    if weight is None:
        return 1.0 - x.mean()
    w = torch.as_tensor(weight, dtype=torch.float32, device=x.device).expand(x.shape)
    return 1.0 - (x * w).sum() / w.sum().clamp_min(1.0)
