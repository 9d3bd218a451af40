"""Check-node constants, the phi function and boxplus over PCM rows.

Semantics and clip constants follow ``feedback_gnn_tpu/decoders/cn_update.py``:

* phi(x) = log((e^x + 1)/(e^x - 1)), input and output clipped to
  [8.5e-8, 16.635532];
* boxplus: tanh products, 1e-12 zero-replacement, 1e-7 re-zeroing, atanh
  clip 1 - 1e-7;
* minsum: +-20 input clip, duplicate-min detection with ``_LARGE_VAL``.

The per-plane CN rules of the quasi-cyclic decoder live beside its kernel
(decoders/bp4_qc.py).
"""

from __future__ import annotations

import torch

__all__ = ["phi", "boxplus_rows", "softplus"]

PHI_CLIP_MIN = 8.5e-8
PHI_CLIP_MAX = 16.635532
ATANH_CLIP = 1.0 - 1e-7
LLR_MAX = 20.0
_LARGE_VAL = 10000.0  # minsum "ignore" constant

# phi formulations:
# "expm1"    (default): softplus(x) - log(expm1(x));
# "tf"       : softplus(x) - log(exp(x) - 1), TF's arithmetic with its f32
#              staircase for weak messages;
# "accurate" : log1p(e) - log1p(-e) with e = exp(-x).
_PHI_IMPLS = ("expm1", "tf", "accurate")
_PHI_IMPL = "expm1"  # the module default that ``impl=None`` selects


def softplus(x):
    """log(1 + e^x) with no threshold, as JAX's softplus computes it.
    (``torch.nn.functional.softplus`` switches to the identity above 20.)"""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


def phi(x, impl: str | None = None):
    """phi(x) = log((e^x + 1)/(e^x - 1)), clipped on input and output.
    ``impl`` selects the formulation; ``None`` is the module default."""
    if impl is None:
        impl = _PHI_IMPL
    if impl not in _PHI_IMPLS:
        raise ValueError(f"unknown phi formulation {impl!r}")
    x = x.clamp(PHI_CLIP_MIN, PHI_CLIP_MAX)
    if impl == "tf":
        out = softplus(x) - torch.log(torch.exp(x) - 1.0)
    elif impl == "accurate":
        e = torch.exp(-x)
        out = torch.log1p(e) - torch.log1p(-e)
    else:
        out = softplus(x) - torch.log(torch.expm1(x))
    return out.clamp(PHI_CLIP_MIN, PHI_CLIP_MAX)


def _sign_no_zero(msg):
    """Sign with 0 -> +1."""
    return torch.where(msg < 0, -1.0, 1.0)


def boxplus_rows(vals, rowset, phi_impl: str | None = None):
    """Boxplus (via phi) of per-VN LLRs over the rows of a PCM: the
    check-satisfaction logits.  No extrinsic split, no syndrome.

    vals   : [>= vn_sentinel+1, B] float32 with zero pad rows
    rowset : codes.graph.RowSet with tensor fields
    Returns [r_pad, B].
    """
    v = vals[rowset.vn_idx]  # [max_deg, r_pad, B]
    m = rowset.mask[:, :, None]
    sign_val = torch.where(m > 0, _sign_no_zero(v), 1.0)
    sign_node = torch.prod(sign_val, dim=0)  # [r_pad, B]
    p = phi(v.abs(), phi_impl) * m
    s = torch.sum(p, dim=0)
    return sign_node * phi(s, phi_impl)
