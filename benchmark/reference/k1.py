"""Quaternary syndrome BP on a quasi-cyclic code, plain PyTorch: the
reference for the program's fused decode (K1).

A frozen copy of the published decoder's plain version: ``num_iter``
flooding iterations over single-shift circulant edge groups, one l-row
plane per group in the CN frame (plane row r = the message on the edge of
CN (i, r)), the VN frame reading row (q + s) mod l.

* VN update: Y-coupled log-space extrinsics, VN sums in ``vn_groups`` order;
* CN update: boxplus-phi with the syndrome sign in the node product (phi in
  the tanh form -log(tanh(x/2)); "tf" and "accurate" forms), boxplus (tanh
  products saturated at TANH_SAT), or min-sum with duplicate-min detection;
  the result is scaled by ``factor``;
* softplus without threshold, sign(0) = +1;
* ``msg_dtype="bfloat16"`` rounds each CN output to bfloat16 (nearest even)
  where it is carried, and nothing else.

Every operation is per sample, so a batch may be split into blocks without
changing a bit.
"""

from __future__ import annotations

import torch

from .codes import QCSpec

__all__ = ["marginals", "PHI_CLIP_MIN", "PHI_CLIP_MAX", "softplus"]

PHI_CLIP_MIN = 8.5e-8
PHI_CLIP_MAX = 16.635532
ATANH_CLIP = 1.0 - 1e-7
LLR_MAX = 20.0
LARGE_VAL = 10000.0
TANH_SAT = 7.90531110763549805


def softplus(x):
    """log(1 + e^x) with no threshold."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp(min=0.0)


def _tanh_sat(x):
    return torch.where(x.abs() >= TANH_SAT, torch.sign(x), torch.tanh(x))


def _phi(x, impl):
    x = x.clamp(PHI_CLIP_MIN, PHI_CLIP_MAX)
    if impl == "tf":
        out = softplus(x) - torch.log(torch.exp(x) - 1.0)
    elif impl == "accurate":
        e = torch.exp(-x)
        out = torch.log1p(e) - torch.log1p(-e)
    else:
        out = -torch.log(torch.tanh(x * 0.5))
    return out.clamp(PHI_CLIP_MIN, PHI_CLIP_MAX)


def _lse_neg(a, b):
    return -torch.minimum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _sign(x):
    return torch.where(x < 0, -1.0, 1.0)


class _Side:
    def __init__(self, spec: QCSpec, device):
        l = spec.l
        s = torch.tensor([g[2] for g in spec.groups], dtype=torch.int64)
        rows = torch.arange(l)
        self.to_vn = ((rows[None, :] + s[:, None]) % l).to(device)
        self.to_cn = ((rows[None, :] - s[:, None]) % l).to(device)
        self.grp_j = torch.tensor([g[1] for g in spec.groups], dtype=torch.int64, device=device)
        dv = max(len(v) for v in spec.vn_groups)
        G = spec.num_groups
        tab = [list(v) + [G] * (dv - len(v)) for v in spec.vn_groups]
        self.vn_tab = torch.tensor(tab, dtype=torch.int64, device=device)
        by_deg = {}
        for i, gs in enumerate(spec.cn_groups):
            if gs:
                by_deg.setdefault(len(gs), []).append(i)
        self.cn_classes = [
            (torch.tensor(rs, dtype=torch.int64, device=device),
             torch.tensor([spec.cn_groups[i] for i in rs], dtype=torch.int64, device=device))
            for _, rs in sorted(by_deg.items())
        ]


def _roll(planes, idx):
    return torch.gather(planes, 1, idx[:, :, None].expand(-1, -1, planes.shape[-1]))


def _vn_sums(v, side):
    ext = torch.cat([v, torch.zeros_like(v[:1])], dim=0)
    acc = ext[side.vn_tab[:, 0]]
    for d in range(1, side.vn_tab.shape[1]):
        acc = acc + ext[side.vn_tab[:, d]]
    return acc


def _cn(msg, syn_pm, side, cn_type, factor, phi_impl):
    out = torch.empty_like(msg)
    for rows, groups in side.cn_classes:
        m = msg[groups]
        syn = syn_pm[rows]
        d = m.shape[1]
        if cn_type == "boxplus-phi":
            signs = _sign(m)
            sprod = signs[:, 0]
            for k in range(1, d):
                sprod = sprod * signs[:, k]
            sprod = sprod * syn
            ps = _phi(m.abs(), phi_impl)
            psum = ps[:, 0]
            for k in range(1, d):
                psum = psum + ps[:, k]
            res = signs * sprod[:, None] * _phi(psum[:, None] - ps, phi_impl) * factor
        elif cn_type == "boxplus":
            ts = _tanh_sat(m * 0.5)
            ts = torch.where(ts == 0.0, 1e-12, ts)
            tprod = ts[:, 0]
            for k in range(1, d):
                tprod = tprod * ts[:, k]
            tprod = tprod * syn
            o = tprod[:, None] / ts
            o = torch.where(o.abs() < 1e-7, 0.0, o)
            o = o.clamp(-ATANH_CLIP, ATANH_CLIP)
            res = 2.0 * torch.atanh(o) * factor
        elif cn_type == "minsum":
            ms = m.clamp(-LLR_MAX, LLR_MAX)
            signs = _sign(ms)
            sprod = signs[:, 0]
            for k in range(1, d):
                sprod = sprod * signs[:, k]
            sprod = sprod * syn
            ams = ms.abs()
            min1 = ams[:, 0]
            for k in range(1, d):
                min1 = torch.minimum(min1, ams[:, k])
            is_min = ams == min1[:, None]
            masked = torch.where(is_min, LARGE_VAL, ams)
            min2 = masked[:, 0]
            for k in range(1, d):
                min2 = torch.minimum(min2, masked[:, k])
            nmin = is_min.to(torch.float32).sum(dim=1)
            min_e = torch.where(nmin >= 2.0, min1, min2)
            res = signs * sprod[:, None] * torch.where(is_min, min_e[:, None], min1[:, None]) * factor
        else:
            raise ValueError(f"unknown CN rule {cn_type!r}")
        out[groups.reshape(-1)] = res.reshape((-1,) + res.shape[2:])
    return out


def marginals(qx: QCSpec, qz: QCSpec, llr_ch, syndrome_x, syndrome_z, num_iter: int,
              cn_type: str = "boxplus-phi", factor: float = 1.0, phi_impl: str | None = None,
              msg_dtype: str = "float32"):
    """(llrx, llry, llrz) [n, B] after ``num_iter`` iterations from channel
    LLRs [3, n, B] (x, y, z) and syndromes [mx, B] (Hx) and [mz, B] (Hz)."""
    dev = llr_ch.device
    sx, sz = _Side(qx, dev), _Side(qz, dev)
    l, nb, b = qx.l, qx.nb, llr_ch.shape[-1]
    L = llr_ch.to(torch.float32).reshape(3, nb, l, b)
    syn_x = 1.0 - 2.0 * syndrome_x.to(torch.float32).reshape(qx.mb, l, b)
    syn_z = 1.0 - 2.0 * syndrome_z.to(torch.float32).reshape(qz.mb, l, b)
    mx = torch.zeros((qx.num_groups, l, b), dtype=torch.float32, device=dev)
    mz = torch.zeros((qz.num_groups, l, b), dtype=torch.float32, device=dev)

    def marg(vx, vz):
        s_x, s_z = _vn_sums(vx, sx), _vn_sums(vz, sz)
        return s_z + L[0], s_x + s_z + L[1], s_x + L[2]

    def carry(msg):
        return msg.to(torch.bfloat16).to(torch.float32) if msg_dtype == "bfloat16" else msg

    for _ in range(num_iter):
        vx, vz = _roll(mx, sx.to_vn), _roll(mz, sz.to_vn)
        llrx, llry, llrz = marg(vx, vz)
        jx, jz = sx.grp_j, sz.grp_j
        nvx = softplus(-llrx)[jx] - _lse_neg(llrz[jx] - vx, llry[jx] - vx)
        nvz = softplus(-llrz)[jz] - _lse_neg(llrx[jz] - vz, llry[jz] - vz)
        mx = carry(_cn(_roll(nvx, sx.to_cn), syn_x, sx, cn_type, factor, phi_impl))
        mz = carry(_cn(_roll(nvz, sz.to_cn), syn_z, sz, cn_type, factor, phi_impl))

    llrx, llry, llrz = marg(_roll(mx, sx.to_vn), _roll(mz, sz.to_vn))
    n = nb * l
    return llrx.reshape(n, b), llry.reshape(n, b), llrz.reshape(n, b)
