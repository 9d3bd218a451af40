"""Binary channels driven by an explicit ``torch.Generator``: the BSC (hard,
and differentiable through a Gumbel-softmax straight-through estimator)
and a uniform bit source, with the semantics of
``feedback_gnn_tpu/channels/bsc.py``.  Outputs lie on the generator's
device.  The streams differ from JAX's for the same seed; only the
distributions agree.
"""

from __future__ import annotations

import torch

__all__ = ["bsc_sample", "bsc_sample_ste", "binary_source"]


def bsc_sample(generator: torch.Generator, p, shape):
    """Hard BSC error pattern ~ Bernoulli(p), bool of ``shape``."""
    return torch.rand(shape, generator=generator, device=generator.device) < p


def bsc_sample_ste(generator: torch.Generator, p, shape, temperature=0.1):
    """Differentiable BSC error sampling: Gumbel-softmax with straight-
    through binarisation.  Returns float errors in {0., 1.} in the forward
    pass whose gradient w.r.t. ``p`` follows the relaxed sigmoid."""
    dev = generator.device
    lo, hi = 1e-9, 1.0 - 1e-9
    u = torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo
    logistic = torch.log(u) - torch.log1p(-u)  # difference of two Gumbels
    p = torch.as_tensor(p, dtype=torch.float32, device=dev).clamp(lo, hi)
    logit_p = torch.log(p) - torch.log1p(-p)
    soft = torch.sigmoid((logit_p + logistic) / temperature)
    hard = (soft > 0.5).to(torch.float32)
    return soft + (hard - soft).detach()  # forward = hard, backward = d soft


def binary_source(generator: torch.Generator, shape):
    """Uniform i.i.d. bits as float32."""
    return (torch.rand(shape, generator=generator, device=generator.device) < 0.5).to(torch.float32)
