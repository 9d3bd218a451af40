"""Check-node updates, the phi function and boxplus over PCM rows.

Semantics and clip constants follow ``feedback_gnn_tpu/decoders/cn_update.py``:

* phi(x) = log((e^x + 1)/(e^x - 1)), input and output clipped to
  [8.5e-8, 16.635532];
* boxplus: tanh products, 1e-12 zero-replacement, 1e-7 re-zeroing, atanh
  clip 1 - 1e-7;
* minsum: +-20 input clip, duplicate-min detection with ``_LARGE_VAL``.

The slot-major CN updates (``cn_update_phi``, ``cn_update_tanh``,
``cn_update_minsum``) take messages ``[dc, c_pad, B]`` in the CN frame of
codes/graph.py, the syndrome as +-1 ``[c_pad, B]`` and the slot mask
``[dc, c_pad]``; pad slots come out as exact zeros.  The per-plane CN rules
of the quasi-cyclic decoders live beside their kernels (decoders/bp4_qc.py).

Gradients (training differentiates the gather decoder) follow JAX's rules
where the two frameworks differ at exact ties: ``clip`` passes 1/2 of the
gradient at a bound, as ``jnp.clip`` does (``torch.clamp`` passes all of
it), and ``softplus`` has slope 1/2 at 0.  Ties are common at the atanh
clip, where float32 has few values below 1.  The forward values are those
of ``torch.clamp``.  The stop-gradients sit where JAX puts them: on the
sign of the phi rule's and min-sum's outputs.
"""

from __future__ import annotations

import torch

__all__ = [
    "phi", "boxplus_rows", "softplus", "clip", "cn_update_phi", "cn_update_tanh", "cn_update_minsum",
    "CN_UPDATES",
]

PHI_CLIP_MIN = 8.5e-8
PHI_CLIP_MAX = 16.635532
ATANH_CLIP = 1.0 - 1e-7
LLR_MAX = 20.0
_LARGE_VAL = 10000.0  # minsum "ignore" constant
# XLA and TensorFlow evaluate float32 tanh on the CPU by a rational
# approximation whose input is clamped to +-TANH_SAT, where it is exactly
# +-1; torch's tanh reaches 1 only near 9.  Boxplus turns the last ulps
# below 1 into LLR differences of order 1 through atanh, so the slot-major
# tanh rule saturates where the reference frameworks do.
TANH_SAT = 7.90531110763549805

# phi formulations:
# "expm1"    (default): softplus(x) - log(expm1(x));
# "tf"       : softplus(x) - log(exp(x) - 1), TF's arithmetic with its f32
#              staircase for weak messages;
# "accurate" : log1p(e) - log1p(-e) with e = exp(-x).
_PHI_IMPLS = ("expm1", "tf", "accurate")
_PHI_IMPL = "expm1"  # the module default that ``impl=None`` selects


class _Clip(torch.autograd.Function):
    """``x.clamp(lo, hi)`` whose gradient is 1/2 at a bound."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        scale = torch.ones_like(x)
        for bound, outside in zip(ctx.bounds, (x.__lt__, x.__gt__)):
            if bound is not None:
                scale = torch.where(outside(bound), 0.0, torch.where(x == bound, 0.5, scale))
        return grad * scale, None, None


def clip(x, lo=None, hi=None):
    """``x.clamp(lo, hi)``; where autograd records, with ``jnp.clip``'s
    gradient (1/2 at a bound)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Clip.apply(x, lo, hi)
    return x.clamp(lo, hi)


def softplus(x):
    """log(1 + e^x) with no threshold, as JAX's softplus computes it, and
    its slope 1/2 at 0.  (``torch.nn.functional.softplus`` switches to the
    identity above 20.)"""
    return torch.log1p(torch.exp(-x.abs())) + clip(x, 0.0)


def phi(x, impl: str | None = None):
    """phi(x) = log((e^x + 1)/(e^x - 1)), clipped on input and output.
    ``impl`` selects the formulation; ``None`` is the module default."""
    if impl is None:
        impl = _PHI_IMPL
    if impl not in _PHI_IMPLS:
        raise ValueError(f"unknown phi formulation {impl!r}")
    x = clip(x, PHI_CLIP_MIN, PHI_CLIP_MAX)
    if impl == "tf":
        out = softplus(x) - torch.log(torch.exp(x) - 1.0)
    elif impl == "accurate":
        e = torch.exp(-x)
        out = torch.log1p(e) - torch.log1p(-e)
    else:
        out = softplus(x) - torch.log(torch.expm1(x))
    return clip(out, PHI_CLIP_MIN, PHI_CLIP_MAX)


def _sign_no_zero(msg):
    """Sign with 0 -> +1."""
    return torch.where(msg < 0, -1.0, 1.0)


def cn_update_phi(msg_cn, syndrome_pm, mask, phi_impl: str | None = None):
    """Extrinsic boxplus via the phi function.

    msg_cn      : [dc, c_pad, B] float32 (pad slots hold 0)
    syndrome_pm : [c_pad, B] float32 in {+1,-1}
    mask        : [dc, c_pad] float32 in {0,1}
    phi_impl    : explicit phi formulation (None = the module default)
    """
    m = mask[:, :, None]
    sign_val = torch.where(m > 0, _sign_no_zero(msg_cn), 1.0)
    sign_node = torch.prod(sign_val, dim=0) * syndrome_pm  # [c_pad, B]
    sign_out = sign_val * sign_node[None]

    p = phi(msg_cn.abs(), phi_impl) * m  # pad slots -> 0 contribution
    ext = torch.sum(p, dim=0)[None] - p
    return sign_out.detach() * phi(ext, phi_impl) * m


def _tanh_sat(x):
    """tanh, exactly +-1 from |x| = TANH_SAT on."""
    return torch.where(x.abs() >= TANH_SAT, torch.sign(x), torch.tanh(x))


def cn_update_tanh(msg_cn, syndrome_pm, mask):
    """Extrinsic boxplus via tanh products (saturating tanh, see TANH_SAT)."""
    m = mask[:, :, None]
    t = _tanh_sat(msg_cn / 2.0)
    t = torch.where(t == 0.0, 1e-12, t)
    t = torch.where(m > 0, t, 1.0)  # pad slots neutral in the product
    prod = torch.prod(t, dim=0) * syndrome_pm  # [c_pad, B]
    out = t**-1 * prod[None]
    out = torch.where(out.abs() < 1e-7, 0.0, out)
    out = clip(out, -ATANH_CLIP, ATANH_CLIP)
    return 2.0 * torch.atanh(out) * m


def cn_update_minsum(msg_cn, syndrome_pm, mask):
    """Extrinsic normalized min-sum with duplicate-min detection."""
    m = mask[:, :, None]
    msg = clip(msg_cn, -LLR_MAX, LLR_MAX)

    sign_val = torch.where(m > 0, _sign_no_zero(msg), 1.0)
    sign_node = torch.prod(sign_val, dim=0) * syndrome_pm
    sign_out = sign_val.detach() * sign_node[None]

    amsg_valid = torch.where(m > 0, msg.abs(), _LARGE_VAL)
    min1 = amsg_valid.amin(dim=0, keepdim=True)  # [1, c_pad, B]
    is_min = (amsg_valid == min1) & (m > 0)
    min2 = torch.where(is_min, _LARGE_VAL, amsg_valid).amin(dim=0, keepdim=True)
    double_min = is_min.to(torch.float32).sum(dim=0, keepdim=True) >= 2.0
    min_e = torch.where(double_min, min1, min2)
    out_abs = torch.where(is_min, min_e, min1)
    return sign_out * out_abs * m


CN_UPDATES = {
    "boxplus-phi": cn_update_phi,
    "boxplus": cn_update_tanh,
    "minsum": cn_update_minsum,
}


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
