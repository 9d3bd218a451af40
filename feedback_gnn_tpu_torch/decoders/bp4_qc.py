"""Fused quaternary BP for quasi-cyclic CSS codes: a CUDA kernel and its
plain PyTorch version.

``bp4_qc_marginals`` runs ``num_iter`` flooding iterations of quaternary
syndrome BP with all message state of a sample kept on chip and returns
the marginals.  It replaces the Pallas kernel of
``feedback_gnn_tpu/decoders/bp4_qc.py`` (``bp4_qc_marginals``); the CUDA
source is ``csrc/bp4_qc.cu``.  One wrapper chooses the version by where
the tensors lie: CPU tensors take the plain version below, CUDA tensors
launch the kernel (or raise), never the plain version.

Message state: one l-row plane per single-shift circulant edge group g =
(i, j, s), stored in the CN frame (plane row r = the message on the edge of
CN (i, r)); the VN frame reads row (q + s) mod l (codes/qc.py).

Numerics are those of the JAX kernel:
* VN update: Y-coupled log-space extrinsics, VN sums in ``vn_groups`` order;
* CN update: boxplus-phi with the syndrome sign in the node product (phi in
  the tanh form -log(tanh(x/2)) for ``phi_impl`` None or "expm1"; "tf" and
  "accurate" as in decoders/cn_update.py), boxplus (tanh products), or
  minsum with duplicate-min detection; the result is scaled by ``factor``;
* softplus without threshold, sign(0) = +1.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..codes.qc import QCGraphSpec, QCPair
from .bp4 import BP4Result, _cal_logit, hard_decision
from .cn_update import ATANH_CLIP, LLR_MAX, PHI_CLIP_MAX, PHI_CLIP_MIN, _LARGE_VAL, softplus

__all__ = ["bp4_qc_marginals", "bp4_qc_marginals_plain", "bp4_decode_qc", "qc_supported", "launches"]

CN_TYPES = ("boxplus-phi", "boxplus", "minsum")
# phi_impl -> the kernel's formulation code (0: tanh form, 1: tf, 2: accurate)
PHI_CODES = {None: 0, "expm1": 0, "tf": 1, "accurate": 2}
MAX_DEG = 8  # largest node degree the kernel takes (csrc/bp4_qc.cu)
THREADS = 256  # threads per block; each block decodes one sample
SMEM_LIMIT = 232448  # shared memory one block may use on Hopper

# kernel launches since the last reset; the plain version does not count
launches = 0


def qc_supported(cn_type: str) -> bool:
    return cn_type in CN_TYPES


def _phi_plain(x, impl):
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
    """log(exp(-a) + exp(-b)) = -min(a,b) + log1p(exp(-|a-b|))."""
    return -torch.minimum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _sign(x):
    return torch.where(x < 0, -1.0, 1.0)


class _SideIndex:
    """Index tensors of one side's planes for the plain version."""

    def __init__(self, spec: QCGraphSpec, device):
        l = spec.l
        s = torch.tensor([g[2] for g in spec.groups], dtype=torch.int64)
        rows = torch.arange(l)
        self.to_vn = ((rows[None, :] + s[:, None]) % l).to(device)  # VN row q reads plane row q+s
        self.to_cn = ((rows[None, :] - s[:, None]) % l).to(device)  # plane row r reads VN row r-s
        self.grp_j = torch.tensor([g[1] for g in spec.groups], dtype=torch.int64, device=device)
        dv = max(len(v) for v in spec.vn_groups)
        G = spec.num_groups
        # pad entries point at an appended zero plane: adding 0.0 is exact
        vn_tab = [list(v) + [G] * (dv - len(v)) for v in spec.vn_groups]
        self.vn_tab = torch.tensor(vn_tab, dtype=torch.int64, device=device)  # [nb, dv]
        # block rows grouped by CN degree: (rows [R], groups [R, d])
        by_deg = {}
        for i, gs in enumerate(spec.cn_groups):
            if gs:
                by_deg.setdefault(len(gs), []).append(i)
        self.cn_classes = [
            (
                torch.tensor(rs, dtype=torch.int64, device=device),
                torch.tensor([spec.cn_groups[i] for i in rs], dtype=torch.int64, device=device),
            )
            for _, rs in sorted(by_deg.items())
        ]


def _roll(planes, idx):
    """out[g, r] = planes[g, idx[g, r]] for planes [G, l, B]."""
    return torch.gather(planes, 1, idx[:, :, None].expand(-1, -1, planes.shape[-1]))


def _vn_sums(v, side: _SideIndex):
    """Per-block-column sums of VN-frame planes, in vn_groups order: [nb, l, B]."""
    ext = torch.cat([v, torch.zeros_like(v[:1])], dim=0)
    acc = ext[side.vn_tab[:, 0]]
    for d in range(1, side.vn_tab.shape[1]):
        acc = acc + ext[side.vn_tab[:, d]]
    return acc


def _cn_plain(msg, syn_pm, side: _SideIndex, cn_type, factor, phi_impl):
    """Extrinsic CN update of CN-frame planes msg [G, l, B]; syn_pm [mb, l, B]."""
    out = torch.empty_like(msg)
    for rows, groups in side.cn_classes:
        m = msg[groups]  # [R, d, l, B]
        syn = syn_pm[rows]  # [R, l, B]
        d = m.shape[1]
        if cn_type == "boxplus-phi":
            signs = _sign(m)
            sprod = signs[:, 0]
            for k in range(1, d):
                sprod = sprod * signs[:, k]
            sprod = sprod * syn
            ps = _phi_plain(m.abs(), phi_impl)
            psum = ps[:, 0]
            for k in range(1, d):
                psum = psum + ps[:, k]
            res = signs * sprod[:, None] * _phi_plain(psum[:, None] - ps, phi_impl) * factor
        elif cn_type == "boxplus":
            ts = torch.tanh(m * 0.5)
            ts = torch.where(ts == 0.0, 1e-12, ts)
            tprod = ts[:, 0]
            for k in range(1, d):
                tprod = tprod * ts[:, k]
            tprod = tprod * syn
            o = tprod[:, None] / ts
            o = torch.where(o.abs() < 1e-7, 0.0, o)
            o = o.clamp(-ATANH_CLIP, ATANH_CLIP)
            res = 2.0 * torch.atanh(o) * factor
        else:  # minsum
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
            masked = torch.where(is_min, _LARGE_VAL, ams)
            min2 = masked[:, 0]
            for k in range(1, d):
                min2 = torch.minimum(min2, masked[:, k])
            nmin = is_min.to(torch.float32).sum(dim=1)
            min_e = torch.where(nmin >= 2.0, min1, min2)
            res = signs * sprod[:, None] * torch.where(is_min, min_e[:, None], min1[:, None]) * factor
        out[groups.reshape(-1)] = res.reshape((-1,) + res.shape[2:])
    return out


@functools.lru_cache(maxsize=8)
def _side_indices(qc: QCPair, device: torch.device):
    return _SideIndex(qc.qx, device), _SideIndex(qc.qz, device)


def bp4_qc_marginals_plain(qc: QCPair, llr_ch, syndrome_x, syndrome_z, num_iter: int,
                           cn_type: str = "boxplus-phi", normalization_factor: float = 1.0,
                           phi_impl: str | None = None):
    """The plain PyTorch version of the kernel, on whatever device the
    tensors lie: index gathers over [G, l, B] planes.  Same contract as
    ``bp4_qc_marginals``."""
    sx_idx, sz_idx = _side_indices(qc, llr_ch.device)
    l, nb = qc.l, qc.qx.nb
    b = llr_ch.shape[-1]
    factor = float(normalization_factor)
    L = llr_ch.to(torch.float32).reshape(3, nb, l, b)
    syn_x = 1.0 - 2.0 * syndrome_x.to(torch.float32).reshape(qc.qx.mb, l, b)
    syn_z = 1.0 - 2.0 * syndrome_z.to(torch.float32).reshape(qc.qz.mb, l, b)
    mx = torch.zeros((qc.qx.num_groups, l, b), dtype=torch.float32, device=llr_ch.device)
    mz = torch.zeros((qc.qz.num_groups, l, b), dtype=torch.float32, device=llr_ch.device)

    def marginals(vx, vz):
        s_x = _vn_sums(vx, sx_idx)  # beliefs about Z
        s_z = _vn_sums(vz, sz_idx)  # beliefs about X
        return s_z + L[0], s_x + s_z + L[1], s_x + L[2]

    for _ in range(num_iter):
        vx = _roll(mx, sx_idx.to_vn)
        vz = _roll(mz, sz_idx.to_vn)
        llrx, llry, llrz = marginals(vx, vz)
        jx, jz = sx_idx.grp_j, sz_idx.grp_j
        nvx = softplus(-llrx)[jx] - _lse_neg(llrz[jx] - vx, llry[jx] - vx)
        nvz = softplus(-llrz)[jz] - _lse_neg(llrx[jz] - vz, llry[jz] - vz)
        mx = _cn_plain(_roll(nvx, sx_idx.to_cn), syn_x, sx_idx, cn_type, factor, phi_impl)
        mz = _cn_plain(_roll(nvz, sz_idx.to_cn), syn_z, sz_idx, cn_type, factor, phi_impl)

    llrx, llry, llrz = marginals(_roll(mx, sx_idx.to_vn), _roll(mz, sz_idx.to_vn))
    n = qc.n
    return llrx.reshape(n, b), llry.reshape(n, b), llrz.reshape(n, b)


def _side_table(spec: QCGraphSpec):
    """shifts [G], cn_tab [mb*dc], cn_deg [mb], vn_tab [nb*dv], vn_deg [nb]."""
    dc = max(len(c) for c in spec.cn_groups)
    dv = max(len(v) for v in spec.vn_groups)
    cn_tab = [list(c) + [-1] * (dc - len(c)) for c in spec.cn_groups]
    vn_tab = [list(v) + [-1] * (dv - len(v)) for v in spec.vn_groups]
    parts = [
        [g[2] for g in spec.groups],
        sum(cn_tab, []),
        [len(c) for c in spec.cn_groups],
        sum(vn_tab, []),
        [len(v) for v in spec.vn_groups],
    ]
    return np.concatenate([np.asarray(p, np.int32) for p in parts]), dc, dv


@functools.lru_cache(maxsize=8)
def _kernel_tables(qc: QCPair, device: torch.device):
    """The kernel's int32 table (both sides, layout of csrc/bp4_qc.cu) on
    the card, its degree bounds and its shared-memory size in bytes."""
    tx, dcx, dvx = _side_table(qc.qx)
    tz, dcz, dvz = _side_table(qc.qz)
    if max(dcx, dcz, dvx, dvz) > MAX_DEG:
        raise ValueError(f"node degree above the kernel's MAX_DEG={MAX_DEG}")
    tab = np.concatenate([tx, tz])
    l = qc.l
    floats = (qc.qx.num_groups + qc.qz.num_groups) * l + 3 * qc.n + (qc.qx.mb + qc.qz.mb) * l
    smem = 4 * floats + 4 * tab.size
    if smem > SMEM_LIMIT:
        raise ValueError(f"one sample's state ({smem} B) exceeds a block's shared memory")
    return torch.as_tensor(tab, device=device), (dcx, dcz, dvx, dvz), smem


def _launch_kernel(qc: QCPair, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type, factor, phi_impl):
    from .._build import load_kernels

    global launches
    lib = load_kernels()
    dev = llr_ch.device
    tab, (dcx, dcz, dvx, dvz), smem = _kernel_tables(qc, dev)
    n, b = qc.n, llr_ch.shape[-1]
    # per-sample contiguous copies: the kernel gives each sample one block
    llr_k = llr_ch.to(torch.float32).permute(2, 0, 1).contiguous()  # [B, 3, n]
    synx_k = syndrome_x.to(torch.float32).T.contiguous()  # [B, mx]
    synz_k = syndrome_z.to(torch.float32).T.contiguous()  # [B, mz]
    out = torch.empty((b, 3, n), dtype=torch.float32, device=dev)
    if b:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fgt_bp4_qc_launch(
                llr_k.data_ptr(), synx_k.data_ptr(), synz_k.data_ptr(), out.data_ptr(),
                tab.data_ptr(), int(tab.numel()), b, qc.l, qc.qx.nb, qc.qx.mb, qc.qz.mb,
                qc.qx.num_groups, qc.qz.num_groups, dcx, dcz, dvx, dvz, int(num_iter),
                CN_TYPES.index(cn_type), PHI_CODES[phi_impl], ctypes.c_float(factor),
                THREADS, smem, stream,
            )
        if err != 0:
            raise RuntimeError(f"bp4_qc kernel launch failed: {lib.fgt_cuda_error_string(err).decode()}")
        launches += 1
    out = out.permute(1, 2, 0)  # [3, n, B]
    return out[0], out[1], out[2]


def bp4_qc_marginals(qc: QCPair, llr_ch, syndrome_x, syndrome_z, num_iter: int,
                     cn_type: str = "boxplus-phi", normalization_factor: float = 1.0,
                     msg_dtype: str = "float32", phi_impl: str | None = None):
    """Run the fused QC BP4 decode.

    Args:
      llr_ch: [3, n, B] channel LLRs (x, y, z), true n = qc.n.
      syndrome_x / syndrome_z: [mx, B] / [mz, B] in {0,1}.
    Returns (llrx, llry, llrz), each [n, B].

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Messages are float32; ``msg_dtype="bfloat16"`` (a perf-study switch of
    the JAX kernel) is not ported.
    """
    if msg_dtype != "float32":
        raise NotImplementedError("only float32 message state is ported")
    if cn_type not in CN_TYPES:
        raise ValueError(f"unsupported cn_type {cn_type!r}")
    if phi_impl not in PHI_CODES:
        raise ValueError(f"unknown phi formulation {phi_impl!r}")
    n, b = qc.n, llr_ch.shape[-1]
    if llr_ch.shape != (3, n, b):
        raise ValueError(f"llr_ch shape {tuple(llr_ch.shape)} != (3, {n}, B)")
    if syndrome_x.shape != (qc.qx.mb * qc.l, b) or syndrome_z.shape != (qc.qz.mb * qc.l, b):
        raise ValueError("syndrome shapes do not match the code")
    devices = {t.device for t in (llr_ch, syndrome_x, syndrome_z)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return _launch_kernel(qc, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type,
                              float(normalization_factor), phi_impl)
    if dev.type == "cpu":
        return bp4_qc_marginals_plain(qc, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type,
                                      normalization_factor, phi_impl)
    raise ValueError(f"unsupported device {dev}")


def bp4_decode_qc(graph, qc: QCPair, llr_ch, syndrome_x, syndrome_z, num_iter: int,
                  cn_type: str = "boxplus-phi", normalization_factor: float = 1.0,
                  need_logits: bool = True, msg_dtype: str = "float32",
                  phi_impl: str | None = None) -> BP4Result:
    """Eval-mode BP4 on the fused decode.  Accepts the cascade's padded
    layouts ([3, n_pad, B] LLRs, [c_pad, B] syndromes) and returns a
    ``BP4Result`` with the padded shapes.  ``need_logits=False`` skips the
    check-satisfaction logits."""
    n, l = qc.n, qc.l
    mx, mz = qc.qx.mb * l, qc.qz.mb * l
    llrx, llry, llrz = bp4_qc_marginals(
        qc, llr_ch[:, :n, :], syndrome_x[:mx], syndrome_z[:mz], num_iter, cn_type,
        normalization_factor, msg_dtype=msg_dtype, phi_impl=phi_impl,
    )
    pad = (0, 0, 0, graph.n_pad - n)
    llrx, llry, llrz = (torch.nn.functional.pad(t, pad) for t in (llrx, llry, llrz))
    x_logit = z_logit = None
    if need_logits:
        x_logit, z_logit = _cal_logit(llrx, llry, llrz, graph, phi_impl)
    x_hat, z_hat = hard_decision(llrx, llry, llrz)
    return BP4Result(llrx, llry, llrz, x_hat, z_hat, x_logit, z_logit, None)
