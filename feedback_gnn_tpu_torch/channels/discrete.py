"""Discrete binary memoryless channels (DMC / BSC / Z / BEC), the port of
``feedback_gnn_tpu/channels/discrete.py``:

* an asymmetric DMC core with per-position error probabilities
  (pb0, pb1), applied where x is 0 / 1;
* differentiable error sampling by the two-class Gumbel-softmax trick and
  a straight-through binarizer, so gradients flow into ``pb``;
* a straight-through XOR (identity backward);
* optional LLR outputs in the logit convention log[p(x=1)/p(x=0)], clipped;
* BSC (pb0 = pb1), Z-channel (pb0 = 0), and BEC with ternary outputs
  (erasure marker -1 binary / 0 bipolar) or zero-LLR erasures.

Each channel takes a ``torch.Generator`` and draws its uniforms on the
generator's device; the ``*_from_uniforms`` functions build the output
from given uniforms, so the same draw can be given to the JAX package.
"""

from __future__ import annotations

import torch

from ..decoders.cn_update import clip

__all__ = [
    "xor_ste",
    "ste_binarize",
    "sample_errors_gumbel",
    "errors_from_uniforms",
    "binary_memoryless_channel",
    "memoryless_from_uniforms",
    "binary_symmetric_channel",
    "binary_z_channel",
    "binary_erasure_channel",
    "erasure_from_uniforms",
]

_EPS = 1e-9
DEFAULT_TEMPERATURE = 0.1


class _XorSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        return (a - b).abs()

    @staticmethod
    def backward(ctx, g):
        return g, g


class _BinarizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.where(x < 0.5, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        return g


def xor_ste(a, b):
    """XOR of {0, 1} tensors with an identity (straight-through) gradient
    to both inputs."""
    return _XorSTE.apply(a, b)


def ste_binarize(x):
    """Hard decision at 0.5 with an identity gradient."""
    return _BinarizeSTE.apply(x)


def _prob(pb, like):
    """``pb`` as float32 on ``like``'s device, clipped to [0, 1]."""
    return clip(torch.as_tensor(pb, dtype=torch.float32, device=like.device), 0.0, 1.0)


def _uniforms(generator, shape):
    return torch.rand(shape, generator=generator, device=generator.device)


def errors_from_uniforms(u, pb, temperature=DEFAULT_TEMPERATURE):
    """Bernoulli(pb) errors of shape ``u.shape[:-1]`` from uniforms ``u``
    [..., 2]: the two-class Gumbel-softmax with classes (error, no error),
    then the straight-through binarizer.  Float {0., 1.} errors whose
    gradient with respect to ``pb`` follows the relaxed softmax."""
    shape = u.shape[:-1]
    q = -torch.log(-torch.log(u + _EPS) + _EPS)
    pb = _prob(pb, u)
    p = torch.stack([pb.expand(shape), (1.0 - pb).expand(shape)], dim=-1)
    a = (torch.log(p + _EPS) + q) / temperature
    return ste_binarize(torch.softmax(a, dim=-1)[..., 0])


def sample_errors_gumbel(generator: torch.Generator, pb, shape, temperature=DEFAULT_TEMPERATURE):
    """Differentiable Bernoulli(pb) errors of ``shape``; see
    ``errors_from_uniforms``."""
    return errors_from_uniforms(_uniforms(generator, tuple(shape) + (2,)), pb, temperature)


def memoryless_from_uniforms(u0, u1, x, pb, *, bipolar_input: bool = False, return_llrs: bool = False,
                             llr_max: float = 100.0, temperature: float = DEFAULT_TEMPERATURE):
    """The asymmetric binary DMC's output from the uniforms of its two error
    draws, ``u0``/``u1`` [*x.shape, 2]; see ``binary_memoryless_channel``."""
    pb0, pb1 = pb
    x = torch.as_tensor(x, dtype=torch.float32, device=u0.device)
    pb0, pb1 = _prob(pb0, x), _prob(pb1, x)
    e0 = errors_from_uniforms(u0, pb0, temperature)
    e1 = errors_from_uniforms(u1, pb1, temperature)

    neutral = -1.0 if bipolar_input else 0.0
    e = torch.where(x == neutral, e0, e1)
    y = x * (-2.0 * e + 1.0) if bipolar_input else xor_ste(x, e)

    if return_llrs:
        if not bipolar_input:
            y = 2.0 * y - 1.0
        y0 = -(torch.log(pb1 + _EPS) - torch.log(1.0 - pb0 - _EPS))
        y1 = torch.log(1.0 - pb1 - _EPS) - torch.log(pb0 + _EPS)
        y = torch.where(y == 1.0, y1, y0) * y  # multiply to keep the gradient
        y = clip(y, -llr_max, llr_max)
    return y


def binary_memoryless_channel(generator: torch.Generator, x, pb, **kwargs):
    """Asymmetric binary DMC.

    Args:
      x: input bits, {0, 1} (or {-1, 1} with ``bipolar_input``), any shape.
      pb: pair (pb0, pb1) of error probabilities: pb0 flips where x is the
        neutral element (0 / -1), pb1 where x is 1.  Scalars or tensors
        broadcastable to ``x.shape``.
    Returns the channel output (bits, or clipped LLRs in the logit
    convention log[p(x=1)/p(x=0)] with ``return_llrs``).
    """
    shape = tuple(torch.as_tensor(x).shape) + (2,)
    u0 = _uniforms(generator, shape)
    u1 = _uniforms(generator, shape)
    return memoryless_from_uniforms(u0, u1, x, pb, **kwargs)


def binary_symmetric_channel(generator: torch.Generator, x, pb, **kwargs):
    """BSC: symmetric flips with probability pb."""
    return binary_memoryless_channel(generator, x, (pb, pb), **kwargs)


def binary_z_channel(generator: torch.Generator, x, pb, **kwargs):
    """Z-channel: only transmitted 1s flip, p(1|0) = 0."""
    return binary_memoryless_channel(generator, x, (torch.zeros_like(torch.as_tensor(pb, dtype=torch.float32)),
                                                    pb), **kwargs)


def erasure_from_uniforms(u, x, pb, *, bipolar_input: bool = False, return_llrs: bool = False,
                          llr_max: float = 100.0, temperature: float = DEFAULT_TEMPERATURE):
    """The BEC's output from the uniforms ``u`` [*x.shape, 2] of its erasure
    draw; see ``binary_erasure_channel``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=u.device)
    e = errors_from_uniforms(u, _prob(pb, x), temperature)
    if return_llrs:
        xb = x if bipolar_input else 2.0 * x - 1.0
        return torch.where(e == 1.0, 0.0, xb * llr_max)
    return torch.where(e == 0.0, x, 0.0 if bipolar_input else -1.0)


def binary_erasure_channel(generator: torch.Generator, x, pb, **kwargs):
    """Binary erasure channel.  Hard mode returns ternary outputs with the
    erasure marker -1 (binary inputs) / 0 (bipolar inputs); LLR mode
    returns +-llr_max with erased positions set to 0."""
    return erasure_from_uniforms(_uniforms(generator, tuple(torch.as_tensor(x).shape) + (2,)), x, pb,
                                 **kwargs)
