"""Pauli channels driven by an explicit ``torch.Generator``.

The threshold semantics of ``feedback_gnn_tpu/channels/pauli.py``:

* i.i.d. mode: one uniform draw u per qubit; ``noise_x = u < px`` and
  ``noise_z = (px - py <= u < px + pz - py)``, so X and Z overlap with
  probability ``py`` (a Y error);
* fixed-weight mode: exactly ``wt`` error positions per sample (without
  replacement); each becomes the X-component with prob. 2/3 and the
  Z-component with prob. 2/3, overlapping in Y with prob. 1/3.

Outputs use the batch-last ``[n, B]`` layout, on the generator's device.
The streams differ from JAX's for the same seed; only the distributions
agree.
"""

from __future__ import annotations

import torch

__all__ = [
    "pauli_iid", "pauli_fixed_weight", "pauli_fixed_weight_traced", "fixed_weight_draw",
    "fixed_weight_from_draw", "depolarizing_probs",
]


def depolarizing_probs(p):
    """(px, py, pz) thresholds for depolarizing noise of strength p: pure
    X/Y/Z each occur with probability p/3."""
    return 2.0 * p / 3.0, p / 3.0, 2.0 * p / 3.0


def pauli_iid(generator: torch.Generator, px, py, pz, n: int, batch: int):
    """i.i.d. Pauli noise: bool tensors (noise_x, noise_z) of shape [n, batch]."""
    u = torch.rand((n, batch), generator=generator, device=generator.device)
    noise_x = u < px
    noise_z = (u >= (px - py)) & (u < (px + pz - py))
    return noise_x, noise_z


def fixed_weight_draw(generator: torch.Generator, n: int, batch: int, wt_max: int):
    """The random part of a fixed-weight draw: ``pos`` [batch, wt_max], the
    first ``wt_max`` entries of a uniform permutation of the n qubits per
    sample (distinct positions), and ``u`` [batch, wt_max] uniforms."""
    dev = generator.device
    pos = torch.rand((batch, n), generator=generator, device=dev).argsort(dim=1)[:, :wt_max]
    u = torch.rand((batch, wt_max), generator=generator, device=dev)
    return pos, u


def fixed_weight_from_draw(pos, u, wt, n: int):
    """Pauli errors of weight ``wt`` <= wt_max from a draw: the first ``wt``
    positions of each sample are hit (``arange(wt_max) < wt``), each
    with its X bit where u < 2/3 and its Z bit where u > 1/3.  ``wt`` may be
    an int or a 0-d tensor.  Bool tensors (noise_x, noise_z) of shape
    [n, batch]."""
    batch, wt_max = pos.shape
    active = torch.arange(wt_max, device=pos.device)[None, :] < wt
    noise_x = torch.zeros((batch, n), dtype=torch.bool, device=pos.device)
    noise_z = torch.zeros((batch, n), dtype=torch.bool, device=pos.device)
    noise_x.scatter_(1, pos, (u < 2.0 / 3.0) & active)
    noise_z.scatter_(1, pos, (u > 1.0 / 3.0) & active)
    return noise_x.T, noise_z.T


def pauli_fixed_weight_traced(generator: torch.Generator, wt, n: int, batch: int, wt_max: int):
    """Exactly-weight-``wt`` Pauli errors for any wt <= ``wt_max`` from one
    draw of ``wt_max`` positions: the same distribution as
    ``pauli_fixed_weight`` (the first ``wt`` entries of a uniform
    permutation are a uniform subset).  Bool tensors of shape [n, batch]."""
    return fixed_weight_from_draw(*fixed_weight_draw(generator, n, batch, wt_max), wt, n)


def pauli_fixed_weight(generator: torch.Generator, wt: int, n: int, batch: int):
    """Exactly-weight-``wt`` Pauli errors: bool tensors (noise_x, noise_z)
    of shape [n, batch]."""
    return pauli_fixed_weight_traced(generator, wt, n, batch, wt)
