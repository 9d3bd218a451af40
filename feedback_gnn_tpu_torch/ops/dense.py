"""Batch-last dense layers: features lead, the Monte-Carlo batch is last.

Weights use the Keras ``[in, out]`` kernel layout of the shipped weights.
"""

from __future__ import annotations

import torch

__all__ = ["dense_bl", "mlp_bl", "init_dense", "init_mlp"]


def dense_bl(x, kernel, bias=None, activation=None):
    """y = act(kernel^T @ x + b) with x of shape [F_in, ..., B]."""
    y = torch.tensordot(kernel, x, dims=([0], [0]))  # [F_out, ..., B]
    if bias is not None:
        y = y + bias.reshape((-1,) + (1,) * (y.ndim - 1))
    if activation is not None:
        y = activation(y)
    return y


def mlp_bl(x, layers, activations):
    """A stack of dense layers; ``layers`` is a list of dicts with 'kernel'
    and optional 'bias', ``activations`` one callable or None per layer."""
    for layer, act in zip(layers, activations):
        x = dense_bl(x, layer["kernel"], layer.get("bias"), act)
    return x


def init_dense(generator: torch.Generator, fan_in: int, fan_out: int, kernel_init: str = "glorot"):
    """Keras Dense defaults on the generator's device: glorot-uniform kernel
    (``kernel_init="zeros"``: a zero kernel, no draw), ones bias."""
    dev = generator.device
    if kernel_init == "zeros":
        kernel = torch.zeros((fan_in, fan_out), device=dev)
    else:
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        u = torch.rand((fan_in, fan_out), generator=generator, device=dev)
        kernel = u * (2.0 * limit) - limit
    return {"kernel": kernel, "bias": torch.ones((fan_out,), device=dev)}


def init_mlp(generator: torch.Generator, fan_in: int, units):
    """Dense layers of ``units`` widths after an input of ``fan_in``."""
    layers, prev = [], fan_in
    for u in units:
        layers.append(init_dense(generator, prev, u))
        prev = u
    return layers
