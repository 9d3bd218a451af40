"""Fused binary BP for one quasi-cyclic parity-check matrix: a CUDA kernel
and its plain PyTorch version.

``bp2_qc_logits`` runs ``num_iter`` flooding iterations of binary syndrome
BP with all message state of a sample kept on chip and returns the
marginal logits.  It replaces the Pallas kernel of
``feedback_gnn_tpu/decoders/bp2_qc.py`` (``bp2_qc_logits``); the CUDA
source is ``csrc/bp2_qc.cu``.  CPU tensors take the plain version below,
CUDA tensors launch the kernel (or raise), never the plain version.

Semantics are those of ``decoders/bp2.py``: channel logits (positive = bit
1) are clipped to +-20 and negated into "true" LLRs, the syndrome sign
multiplies the CN product, and the marginals are negated back into logits.
The VN total starts from the channel LLR and adds the messages in
``vn_groups`` order; the CN rules are those of the quaternary decoder
(decoders/bp4_qc.py) with phi in the tanh form.  Eval only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import obs
from ..codes.qc import QCGraphSpec
from .bp4_qc import (
    CN_TYPES, MAX_DEG, NO_SLOT, LaunchPlan, _cn_plain, _cn_slots, _instance, _pack_tables, _plan,
    _roll, _round_up, _side_index, _SideIndex, _vn_slots,
)
from .cn_update import LLR_MAX

__all__ = ["bp2_qc_logits", "bp2_qc_logits_plain"]


def _vn_totals(v, side: _SideIndex, llr):
    """Per-VN totals llr + sum of the VN-frame planes, in vn_groups order:
    [nb, l, B]."""
    ext = torch.cat([v, torch.zeros_like(v[:1])], dim=0)  # pad entries add an exact 0
    acc = llr
    for d in range(side.vn_tab.shape[1]):
        acc = acc + ext[side.vn_tab[:, d]]
    return acc


def bp2_qc_logits_plain(spec: QCGraphSpec, llr_ch, syndrome, num_iter: int,
                        cn_type: str = "boxplus-phi", normalization_factor: float = 1.0):
    """The plain PyTorch version of the kernel, on whatever device the
    tensors lie: index gathers over [G, l, B] planes.  Same contract as
    ``bp2_qc_logits``."""
    side = _side_index(spec, llr_ch.device)
    l, nb, mb = spec.l, spec.nb, spec.mb
    b = llr_ch.shape[-1]
    factor = float(normalization_factor)
    llr = -llr_ch.to(torch.float32).clamp(-LLR_MAX, LLR_MAX).reshape(nb, l, b)
    syn = 1.0 - 2.0 * syndrome.to(torch.float32).reshape(mb, l, b)
    msg = torch.zeros((spec.num_groups, l, b), dtype=torch.float32, device=llr_ch.device)
    for _ in range(num_iter):
        v = _roll(msg, side.to_vn)
        ext = _vn_totals(v, side, llr)[side.grp_j] - v
        msg = _cn_plain(_roll(ext, side.to_cn), syn, side, cn_type, factor, None)
    tot = _vn_totals(_roll(msg, side.to_vn), side, llr)
    return -tot.reshape(nb * l, b)


# K2's __launch_bounds__: the minsum instances at (512, 3), 40 registers;
# the others at (512, 2), 64
K2_MAX_THREADS = 512


def _k2_regs(cn_type: str) -> int:
    return 40 if cn_type == "minsum" else 64


def _slot_tables(spec: QCGraphSpec, instance: tuple):
    """K2's per-node slot tables for an instance (layout K2Layout of
    csrc/bp2_qc.cu): VN rows [n, RV], CN rows [m, RC]."""
    dc, dv = instance
    vw, cw = dv or MAX_DEG, dc or MAX_DEG
    if spec.num_edges > NO_SLOT:
        raise ValueError("more message slots than a uint16 slot table holds")
    vtab = np.full((spec.nb * spec.l, _round_up(vw, 4)), NO_SLOT, np.int64)
    vtab[:, :vw] = _vn_slots(spec, vw, 0)
    ctab = np.full((spec.mb * spec.l, _round_up(cw, 8)), NO_SLOT, np.int64)
    ctab[:, :cw] = _cn_slots(spec, cw, 0)
    return vtab, ctab


@functools.lru_cache(maxsize=64)
def _launch_plan(spec: QCGraphSpec, batch: int, cn_type: str, threads: int | None = None,
                 samples_per_block: int | None = None, instance: tuple | None = None) -> LaunchPlan:
    """K2's launch plan for ``batch`` samples of ``spec`` under ``cn_type``,
    whose instance's register cap it takes (see bp4_qc._plan); ``instance``
    overrides the degree pair."""
    instance = instance or _instance((spec,))
    vtab, ctab = _slot_tables(spec, instance)
    tab_bytes = 2 * _round_up(vtab.size, 8) + 2 * ctab.size
    n, m = spec.nb * spec.l, spec.mb * spec.l
    sample_bytes = _round_up(4 * spec.num_edges + 4 * n + m, 16)
    return _plan(instance, max(n, m), tab_bytes, sample_bytes, batch, _k2_regs(cn_type),
                 K2_MAX_THREADS, threads, samples_per_block)


@functools.lru_cache(maxsize=8)
def _kernel_table(spec: QCGraphSpec, instance: tuple, device: torch.device):
    """K2's packed slot table for an instance, on the card."""
    return torch.as_tensor(_pack_tables(*_slot_tables(spec, instance)), device=device)


def _occupancy(spec: QCGraphSpec, cn_type, plan: LaunchPlan):
    """(resident blocks per SM, registers per thread, spill bytes per
    thread) of the plan's K2 instance on the card, from the CUDA runtime."""
    from .._build import load_kernels

    lib = load_kernels()
    out = (ctypes.c_int * 3)()
    err = lib.fgt_bp2_qc_occupancy(CN_TYPES.index(cn_type), *plan.instance, plan.block_threads,
                                   plan.smem_bytes, out)
    if err != 0:
        raise RuntimeError(f"bp2_qc occupancy query failed: {lib.fgt_cuda_error_string(err).decode()}")
    return tuple(out)


def _launch_kernel(spec: QCGraphSpec, llr_ch, syndrome, num_iter, cn_type, factor,
                   plan: LaunchPlan | None = None):
    from .._build import load_kernels

    lib = load_kernels()
    dev = llr_ch.device
    n, m, b = spec.nb * spec.l, spec.mb * spec.l, llr_ch.shape[-1]
    # per-sample contiguous copies: each sample's state is loaded by its own threads
    llr_k = llr_ch.to(torch.float32).T.contiguous()  # [B, n]
    syn_k = syndrome.to(torch.float32).T.contiguous()  # [B, m]
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b:
        plan = plan or _launch_plan(spec, b, cn_type)
        tab = _kernel_table(spec, plan.instance, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fgt_bp2_qc_launch(
                llr_k.data_ptr(), syn_k.data_ptr(), out.data_ptr(), tab.data_ptr(), b, n, m,
                spec.num_edges, int(num_iter), CN_TYPES.index(cn_type), *plan.instance,
                ctypes.c_float(factor), plan.threads, plan.samples_per_block, plan.smem_bytes,
                stream,
            )
        if err != 0:
            raise RuntimeError(f"bp2_qc kernel launch failed: {lib.fgt_cuda_error_string(err).decode()}")
        obs.count("k2.launches")  # the plain version does not count
    return out.T  # [n, B]


def bp2_qc_logits(spec: QCGraphSpec, llr_ch, syndrome, num_iter: int,
                  cn_type: str = "boxplus-phi", normalization_factor: float = 1.0):
    """Run the fused QC BP2 decode.

    Args:
      llr_ch: [n, B] channel LOGITS (positive = bit 1), n = spec.nb * spec.l.
      syndrome: [m, B] in {0,1}, m = spec.mb * spec.l.
    Returns marginal logits [n, B] (the convention of ``bp2_decode``).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if cn_type not in CN_TYPES:
        raise ValueError(f"unsupported cn_type {cn_type!r}")
    n, b = spec.nb * spec.l, llr_ch.shape[-1]
    if llr_ch.shape != (n, b):
        raise ValueError(f"llr_ch shape {tuple(llr_ch.shape)} != ({n}, B)")
    if syndrome.shape != (spec.mb * spec.l, b):
        raise ValueError(f"syndrome shape {tuple(syndrome.shape)} != ({spec.mb * spec.l}, {b})")
    if llr_ch.device != syndrome.device:
        raise ValueError(f"inputs lie on several devices: {llr_ch.device}, {syndrome.device}")
    dev = llr_ch.device
    if dev.type == "cuda":
        return _launch_kernel(spec, llr_ch, syndrome, num_iter, cn_type, float(normalization_factor))
    if dev.type == "cpu":
        return bp2_qc_logits_plain(spec, llr_ch, syndrome, num_iter, cn_type, normalization_factor)
    raise ValueError(f"unsupported device {dev}")
