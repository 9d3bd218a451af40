"""Batch-last dense layer: features lead, the Monte-Carlo batch is last.

Weights use the Keras ``[in, out]`` kernel layout of the shipped weights.
"""

from __future__ import annotations

import torch

__all__ = ["dense_bl"]


def dense_bl(x, kernel, bias=None, activation=None):
    """y = act(kernel^T @ x + b) with x of shape [F_in, ..., B]."""
    y = torch.tensordot(kernel, x, dims=([0], [0]))  # [F_out, ..., B]
    if bias is not None:
        y = y + bias.reshape((-1,) + (1,) * (y.ndim - 1))
    if activation is not None:
        y = activation(y)
    return y
