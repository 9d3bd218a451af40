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
  "accurate" as in decoders/cn_update.py), boxplus (tanh products, the
  tanh saturated at cn_update.TANH_SAT), or
  minsum with duplicate-min detection; the result is scaled by ``factor``;
* softplus without threshold, sign(0) = +1.

``msg_dtype="bfloat16"`` is the JAX kernel's bfloat16 message carry: each
CN output is rounded to bfloat16 (round to nearest even) where it is
stored, and nothing else is.  The VN extrinsics, the marginals and all
arithmetic stay float32; the messages keep their float32 slots (holding
bfloat16 values).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..codes.qc import QCGraphSpec, QCPair
from .bp4 import BP4Result, _cal_logit, hard_decision
from .cn_update import (
    ATANH_CLIP, LLR_MAX, PHI_CLIP_MAX, PHI_CLIP_MIN, _LARGE_VAL, _tanh_sat, softplus,
)

__all__ = ["bp4_qc_marginals", "bp4_qc_marginals_plain", "bp4_decode_qc", "qc_supported"]

CN_TYPES = ("boxplus-phi", "boxplus", "minsum")
# message carry -> the kernel's code (0: float32; 1: each CN output rounded to bfloat16)
MSG_DTYPES = ("float32", "bfloat16")
# phi_impl -> the kernel's formulation code (0: tanh form, 1: tf, 2: accurate)
PHI_CODES = {None: 0, "expm1": 0, "tf": 1, "accurate": 2}
MAX_DEG = 8  # largest node degree of the generic instance (csrc/qc_common.cuh)
# degree pairs (DC, DV) with instances of their own; (0, 0) is the generic one
SPECIALISED = ((6, 3), (8, 4))
NO_SLOT = 0xFFFF  # an unused entry of a slot-table row
# The card (H100 SXM): shared memory one block may use, shared memory of one
# SM (1 KB of it reserved per resident block), SMs, threads and registers per SM
SMEM_LIMIT = 232448
SM_SMEM, SM_BLOCK_RESERVED = 233472, 1024
SM_COUNT, SM_THREADS, SM_REGS = 132, 2048, 65536
MAX_SAMPLES_PER_BLOCK = 15  # named barriers 1..15, one per sample
ENOUGH_WARPS = 16  # resident warps per SM a large-batch plan must keep
# K1's __launch_bounds__(1024, 1): registers per thread and threads per block
K1_REGS, K1_MAX_THREADS = 64, 1024


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
            ts = _tanh_sat(m * 0.5)  # +-1 from TANH_SAT on, as XLA and TF give
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


def _carry(msg, msg_dtype):
    """CN outputs as the message carry stores them: rounded to bfloat16
    (nearest even) and widened back, or unchanged for float32."""
    return msg.to(torch.bfloat16).to(torch.float32) if msg_dtype == "bfloat16" else msg


def _check_msg_dtype(msg_dtype):
    if msg_dtype not in MSG_DTYPES:
        raise ValueError(f"unsupported msg_dtype {msg_dtype!r}: one of {MSG_DTYPES}")


@functools.lru_cache(maxsize=8)
def _side_index(spec: QCGraphSpec, device: torch.device):
    return _SideIndex(spec, device)


def bp4_qc_marginals_plain(qc: QCPair, llr_ch, syndrome_x, syndrome_z, num_iter: int,
                           cn_type: str = "boxplus-phi", normalization_factor: float = 1.0,
                           phi_impl: str | None = None, msg_dtype: str = "float32"):
    """The plain PyTorch version of the kernel, on whatever device the
    tensors lie: index gathers over [G, l, B] planes.  Same contract as
    ``bp4_qc_marginals``."""
    _check_msg_dtype(msg_dtype)
    sx_idx, sz_idx = _side_index(qc.qx, llr_ch.device), _side_index(qc.qz, llr_ch.device)
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
        mx, mz = _carry(mx, msg_dtype), _carry(mz, msg_dtype)  # the carry's only rounding

    llrx, llry, llrz = marginals(_roll(mx, sx_idx.to_vn), _roll(mz, sz_idx.to_vn))
    n = qc.n
    return llrx.reshape(n, b), llry.reshape(n, b), llrz.reshape(n, b)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _instance(specs) -> tuple:
    """The degree pair (DC, DV) of the kernel instance for these sides:
    their own if every CN has degree DC and every VN degree DV on each side
    and an instance exists for the pair, else (0, 0), the generic one."""
    dcs = {len(c) for s in specs for c in s.cn_groups}
    dvs = {len(v) for s in specs for v in s.vn_groups}
    if max(dcs | dvs) > MAX_DEG:
        raise ValueError(f"node degree above the kernel's MAX_DEG={MAX_DEG}")
    pair = (dcs.pop(), dvs.pop()) if len(dcs) == 1 and len(dvs) == 1 else None
    return pair if pair in SPECIALISED else (0, 0)


def _vn_slots(spec: QCGraphSpec, width: int, offset: int) -> np.ndarray:
    """[nb*l, width]: the message slots (CN frame, plane g row (q + s_g) mod
    l, plus ``offset``) of each VN's edges in vn_groups order, NO_SLOT past
    its degree."""
    l = spec.l
    q = np.arange(l)
    out = np.full((spec.nb, l, width), NO_SLOT, np.int64)
    for j, gs in enumerate(spec.vn_groups):
        for k, g in enumerate(gs):
            out[j, :, k] = offset + g * l + (q + spec.groups[g][2]) % l
    return out.reshape(spec.nb * l, width)


def _cn_slots(spec: QCGraphSpec, width: int, offset: int) -> np.ndarray:
    """[mb*l, width]: the message slots (plane g row r, plus ``offset``) of
    each CN (i, r)'s edges in cn_groups order, NO_SLOT past its degree."""
    l = spec.l
    out = np.full((spec.mb, l, width), NO_SLOT, np.int64)
    for i, gs in enumerate(spec.cn_groups):
        for k, g in enumerate(gs):
            out[i, :, k] = offset + g * l + np.arange(l)
    return out.reshape(spec.mb * l, width)


def _slot_tables(qc: QCPair, instance: tuple):
    """K1's per-node slot tables for an instance (layout K1Layout of
    csrc/bp4_qc.cu): VN rows [n, RV] (VW Hx slots, then VW Hz slots) and CN
    rows [mx + mz, RC] (Hx CNs, then Hz CNs); Hz slots follow the Hx planes."""
    dc, dv = instance
    vw, cw = dv or MAX_DEG, dc or MAX_DEG
    zoff = qc.qx.num_edges
    if zoff + qc.qz.num_edges > NO_SLOT:
        raise ValueError("more message slots than a uint16 slot table holds")
    vtab = np.full((qc.n, _round_up(2 * vw, 8)), NO_SLOT, np.int64)
    vtab[:, :vw] = _vn_slots(qc.qx, vw, 0)
    vtab[:, vw:2 * vw] = _vn_slots(qc.qz, vw, zoff)
    ctab = np.full((qc.qx.mb * qc.l + qc.qz.mb * qc.l, _round_up(cw, 8)), NO_SLOT, np.int64)
    ctab[:, :cw] = np.concatenate([_cn_slots(qc.qx, cw, 0), _cn_slots(qc.qz, cw, zoff)])
    return vtab, ctab


def _pack_tables(vtab: np.ndarray, ctab: np.ndarray) -> np.ndarray:
    """VN rows, zero padding to 16 bytes, CN rows: the uint16 table the
    kernels copy into shared memory, as int16 (torch's) bits."""
    vflat = vtab.astype(np.uint16).reshape(-1)
    pad = np.zeros(_round_up(vflat.size, 8) - vflat.size, np.uint16)
    return np.concatenate([vflat, pad, ctab.astype(np.uint16).reshape(-1)]).view(np.int16)


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch of K1 or K2 lays out its batch."""

    instance: tuple  # (DC, DV) of the kernel instance; (0, 0) the generic one
    threads: int  # threads per sample (whole warps)
    samples_per_block: int
    smem_bytes: int  # dynamic shared memory per block: slot table + samples
    blocks_per_sm: int  # resident blocks per SM the plan expects
    regime: str  # "small" (about one node per thread) or "large" (fill the SM)
    nodes_per_thread: int  # VNs or CNs a thread visits per half-iteration, at most:
    # ceil(nodes / threads), so threads x nodes_per_thread covers every node

    @property
    def block_threads(self) -> int:
        return self.threads * self.samples_per_block

    def blocks(self, batch: int) -> int:
        return -(-batch // self.samples_per_block)


def _blocks_per_sm(block_threads: int, smem: int, regs: int) -> int:
    """Resident blocks per SM by threads, registers (allocated per warp in
    units of 256) and shared memory."""
    warps = block_threads // 32
    by_regs = SM_REGS // (warps * _round_up(regs * 32, 256))
    by_smem = SM_SMEM // (smem + SM_BLOCK_RESERVED)
    return min(SM_THREADS // block_threads, by_regs, by_smem, 32)


def _plan(instance, nodes, tab_bytes, sample_bytes, batch, regs, max_threads,
          threads=None, samples_per_block=None) -> LaunchPlan:
    """The launch plan of one decode.  ``nodes`` is max(VNs, CNs) of a
    sample; ``regs`` the instance's register cap from its launch bounds.

    Large batches fill each SM: as many samples as shared memory holds at
    ENOUGH_WARPS resident warps or more, then the fewest warps (each thread
    walks more nodes between its sample's barriers), and the block's
    threads shared out among them.  A batch that one wave of that plan
    holds is small: its samples spread over the SMs in one block each, as
    ceil(batch / SM_COUNT) samples per block sharing the block's threads
    (about one node per thread at one sample).  Both rules are the winners
    of the plan grid chip_smoke.py measures (PERF.md).  ``threads`` and
    ``samples_per_block`` override the choice."""
    all_threads = _round_up(nodes, 32)
    thread_cap = min(SM_THREADS, SM_REGS // _round_up(regs * 32, 256) * 32)
    best = None
    for nblk in range(1, thread_cap // 32 + 1):
        bt_max = min(max_threads, thread_cap // nblk // 32 * 32)
        budget = min(SMEM_LIMIT, SM_SMEM // nblk - SM_BLOCK_RESERVED)
        spb = min(MAX_SAMPLES_PER_BLOCK, (budget - tab_bytes) // sample_bytes, bt_max // 32)
        if spb < 1:
            continue
        thr = min(all_threads, bt_max // spb // 32 * 32)
        warps, samples = nblk * spb * thr // 32, nblk * spb
        key = (warps >= ENOUGH_WARPS, samples, -warps)
        if best is None or key > best[0]:
            best = (key, thr, spb)
    if best is None:
        raise ValueError(f"one sample's state ({tab_bytes + sample_bytes} B with the slot table) "
                         f"exceeds a block's shared memory ({SMEM_LIMIT} B)")
    _, large_threads, large_spb = best
    large_blocks = _blocks_per_sm(large_threads * large_spb, tab_bytes + large_spb * sample_bytes, regs)
    regime = "small" if batch <= SM_COUNT * large_blocks * large_spb else "large"
    if regime == "small":
        spb = min(large_spb, -(-batch // SM_COUNT))
        thr = min(all_threads, max_threads // spb // 32 * 32)
    else:
        thr, spb = large_threads, large_spb
    thr = threads or thr
    spb = samples_per_block or spb
    smem = tab_bytes + spb * sample_bytes
    per = -(-nodes // thr)
    if thr % 32 or thr * spb > max_threads or not 1 <= spb <= MAX_SAMPLES_PER_BLOCK:
        raise ValueError(f"no launch of {spb} x {thr} threads (whole warps, at most {max_threads})")
    if smem > SMEM_LIMIT:
        raise ValueError(f"{spb} samples ({smem} B with the slot table) exceed a block's shared "
                         f"memory ({SMEM_LIMIT} B)")
    blocks = _blocks_per_sm(thr * spb, smem, regs)
    if blocks < 1:
        raise ValueError(f"a block of {thr * spb} threads and {smem} B does not fit an SM")
    return LaunchPlan(instance, thr, spb, smem, blocks, regime, per)


def _k1_bytes(qc: QCPair, instance: tuple):
    """(slot-table bytes, bytes of one sample's state) of K1 in shared memory."""
    vtab, ctab = _slot_tables(qc, instance)
    tab_bytes = 2 * _round_up(vtab.size, 8) + 2 * ctab.size
    m = (qc.qx.mb + qc.qz.mb) * qc.l
    msgs = qc.qx.num_edges + qc.qz.num_edges
    return tab_bytes, _round_up(4 * msgs + 12 * qc.n + m, 16)


@functools.lru_cache(maxsize=64)
def _launch_plan(qc: QCPair, batch: int, threads: int | None = None,
                 samples_per_block: int | None = None, instance: tuple | None = None) -> LaunchPlan:
    """K1's launch plan for ``batch`` samples of ``qc`` (see ``_plan``);
    ``instance`` overrides the degree pair (the tests reach the generic
    instance with it)."""
    instance = instance or _instance((qc.qx, qc.qz))
    tab_bytes, sample_bytes = _k1_bytes(qc, instance)
    nodes = max(qc.n, (qc.qx.mb + qc.qz.mb) * qc.l)
    return _plan(instance, nodes, tab_bytes, sample_bytes, batch, K1_REGS, K1_MAX_THREADS,
                 threads, samples_per_block)


@functools.lru_cache(maxsize=8)
def _kernel_table(qc: QCPair, instance: tuple, device: torch.device):
    """K1's packed slot table for an instance, on the card."""
    return torch.as_tensor(_pack_tables(*_slot_tables(qc, instance)), device=device)


def _kernel_codes(cn_type, phi_impl, instance, msg_dtype="float32"):
    """The C launcher's instance key: CN rule, phi form (0 for the rules
    that do not use phi), DC, DV, message carry."""
    phi = PHI_CODES[phi_impl] if cn_type == "boxplus-phi" else 0
    return (CN_TYPES.index(cn_type), phi) + tuple(instance) + (MSG_DTYPES.index(msg_dtype),)


def _occupancy(qc: QCPair, cn_type, phi_impl, plan: LaunchPlan, msg_dtype="float32"):
    """(resident blocks per SM, registers per thread, spill bytes per
    thread) of the plan's K1 instance on the card, from the CUDA runtime."""
    from .._build import load_kernels

    lib = load_kernels()
    out = (ctypes.c_int * 3)()
    err = lib.fgt_bp4_qc_occupancy(*_kernel_codes(cn_type, phi_impl, plan.instance, msg_dtype),
                                   plan.block_threads, plan.smem_bytes, out)
    if err != 0:
        raise RuntimeError(f"bp4_qc occupancy query failed: {lib.fgt_cuda_error_string(err).decode()}")
    return tuple(out)


def _launch_kernel(qc: QCPair, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type, factor, phi_impl,
                   plan: LaunchPlan | None = None, msg_dtype: str = "float32"):
    from .._build import load_kernels

    lib = load_kernels()
    dev = llr_ch.device
    n, b = qc.n, llr_ch.shape[-1]
    mx, mz = qc.qx.mb * qc.l, qc.qz.mb * qc.l
    # per-sample contiguous copies: each sample's state is loaded by its own threads
    llr_k = llr_ch.to(torch.float32).permute(2, 0, 1).contiguous()  # [B, 3, n]
    synx_k = syndrome_x.to(torch.float32).T.contiguous()  # [B, mx]
    synz_k = syndrome_z.to(torch.float32).T.contiguous()  # [B, mz]
    out = torch.empty((b, 3, n), dtype=torch.float32, device=dev)
    if b:
        plan = plan or _launch_plan(qc, b)
        tab = _kernel_table(qc, plan.instance, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            with obs.span("k1.kernel"):
                err = lib.fgt_bp4_qc_launch(
                    llr_k.data_ptr(), synx_k.data_ptr(), synz_k.data_ptr(), out.data_ptr(),
                    tab.data_ptr(), b, n, mx, mz, qc.qx.num_edges + qc.qz.num_edges, int(num_iter),
                    *_kernel_codes(cn_type, phi_impl, plan.instance, msg_dtype), ctypes.c_float(factor),
                    plan.threads, plan.samples_per_block, plan.smem_bytes, stream,
                )
        if err != 0:
            raise RuntimeError(f"bp4_qc kernel launch failed: {lib.fgt_cuda_error_string(err).decode()}")
        # the launch's shape, as the benchmark counts K1's operations; the plain version does not count
        obs.count("k1.launches", key=(b, int(num_iter), cn_type, phi_impl, msg_dtype))
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
    ``msg_dtype`` "bfloat16" rounds each CN output to bfloat16 where it is
    carried (the module docstring); "float32" carries them unrounded.
    """
    _check_msg_dtype(msg_dtype)
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
                              float(normalization_factor), phi_impl, msg_dtype=msg_dtype)
    if dev.type == "cpu":
        return bp4_qc_marginals_plain(qc, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type,
                                      normalization_factor, phi_impl, msg_dtype)
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
