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

__all__ = ["pauli_iid", "pauli_fixed_weight", "depolarizing_probs"]


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


def pauli_fixed_weight(generator: torch.Generator, wt: int, n: int, batch: int):
    """Exactly-weight-``wt`` Pauli errors: bool tensors (noise_x, noise_z)
    of shape [n, batch]."""
    dev = generator.device
    # distinct positions per sample: the first wt entries of a uniform permutation
    pos = torch.rand((batch, n), generator=generator, device=dev).argsort(dim=1)[:, :wt]
    u = torch.rand((batch, wt), generator=generator, device=dev)
    noise_x = torch.zeros((batch, n), dtype=torch.bool, device=dev)
    noise_z = torch.zeros((batch, n), dtype=torch.bool, device=dev)
    noise_x.scatter_(1, pos, u < 2.0 / 3.0)
    noise_z.scatter_(1, pos, u > 1.0 / 3.0)
    return noise_x.T, noise_z.T
