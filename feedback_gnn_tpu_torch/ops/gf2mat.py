"""Device GF(2) matrix product."""

from __future__ import annotations

import torch

__all__ = ["mod2_matmul"]


def mod2_matmul(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(h @ v) mod 2`` with ``h`` a [m, n] 0/1 matrix and ``v`` [n, B].

    Returns int32 in {0,1}.  The product runs and accumulates in float32,
    as the JAX package's does (``preferred_element_type=float32``): sums of
    0/1 products stay integer-exact up to 2^24.  A bfloat16 result would be
    exact only up to 256, which the accounting products over the
    ``hx_perp``/``hz_perp`` rows can exceed.
    """
    prod = torch.matmul(h.to(torch.float32), v.to(torch.float32))
    return prod.to(torch.int32) & 1
