"""Sandwich BP -> (GNN -> BP)^nG cascade: the paper's flagship decoder.

The port of ``feedback_gnn_tpu/decoders/cascade.py``: stage-1 BP4, then nG
rounds of {syndrome of the current estimate, still-flagged tracking,
feedback GNN, BP4-16, masked update of the still-flagged samples}, then
flagged and logical accounting.  With ``qc`` (a ``QCPair``) every BP run
goes through ``bp4_decode_qc``, i.e. the CUDA kernel on the card; without
it, through the gather decoder ``bp4_decode`` (plain PyTorch).

Flagged-sample compaction (``compact_fraction``, ``stage1_prepass``,
``round_fraction``) gathers the still-flagged samples into a dense
sub-batch with a stable sort, exactly as the JAX package does; per-sample
results equal the uncompacted cascade while no capacity overflows.  The
rescue stage (``rescue_phi``) re-decodes the samples still flagged after
the cascade with other phi formulations and adopts syndrome-consistent
rescues.

The GNN gets the semantic logit names: ``logit_hx`` is the per-Hx-row logit
(z_logit of BP4 in stage mode), ``logit_hz`` the per-Hz-row logit (x_logit).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, replace
from typing import Any, Sequence

import torch

from ..channels.pauli import depolarizing_probs, pauli_fixed_weight, pauli_iid
from ..ops.gf2mat import mod2_matmul
from . import cn_update
from .bp4 import BP4Result, bp4_decode
from .bp4_qc import bp4_decode_qc, qc_supported
from .gnn_feedback import feedback_gnn_apply

__all__ = ["CascadeConfig", "sandwich_decode", "sandwich_eval_step", "prior_llr"]


@dataclass(frozen=True)
class CascadeConfig:
    """Decoder schedule for the cascade; the fields and their meaning are
    those of the JAX package's ``CascadeConfig``."""

    num_iter1: int = 64
    num_iter2: int = 16
    factor1: float = 1.0
    factor2: float = 1.0
    cn_type: str = "boxplus-phi"
    num_rounds: int = 3  # nG
    p0: float = 0.05  # prior used for the uniform llr init
    # on the QC backend, compaction and rescue capacities are rounded up to
    # a multiple of this tile, as in the JAX package (where it is the Pallas
    # batch tile; the gather backend rounds to 8): the rounding decides
    # which samples overflow, so the port keeps it
    qc_batch_tile: int = 128
    # storage dtype of the decode's message state; only "float32" is ported
    qc_msg_dtype: str = "float32"
    # level-1 compaction: after stage 1, the still-flagged samples go into a
    # sub-batch of ceil(fraction * B) (tile-rounded); None = off
    compact_fraction: float | None = None
    # adaptive stage 1: only this many BP iterations on the full batch, then
    # the full num_iter1 schedule on the level-1 subset; needs compaction
    stage1_prepass: int | None = None
    # level-2 compaction: sub-batch of the GNN rounds, as a fraction of the
    # full batch; None = rounds run on the level-1 subset
    round_fraction: float | None = None
    # formulation-ensemble rescue: after the cascade, re-decode the samples
    # still flagged with another phi formulation (cn_update._PHI_IMPLS) and
    # adopt the rescue estimate only where it is syndrome-consistent, so
    # the flagged count never increases (the logical count may move either
    # way).  A comma-separated list ("tf,accurate") chains stages, each on
    # the remnant of the one before.  None = off.
    rescue_phi: str | None = None
    # capacity of the rescue sub-batch as a fraction of the batch (tile-
    # rounded); overflow samples keep the cascade's estimate and count in
    # the overflow
    rescue_fraction: float = 0.02


def prior_llr(p0, n, batch, n_pad=None, device=None):
    """Uniform depolarizing prior llr = log(3(1-p0)/p0) replicated over
    (x, y, z): [3, n, batch], or [3, n_pad, batch] with ZERO pad rows."""
    val = torch.log(torch.tensor(3.0 * (1.0 - p0) / p0, dtype=torch.float32, device=device))
    body = val.expand(3, n, batch)
    if n_pad is None:
        return body.clone()
    return torch.nn.functional.pad(body, (0, 0, 0, n_pad - n))


def _capacity(fraction, b, tile):
    return min(b, -(-int(math.ceil(fraction * b)) // tile) * tile)


def _take(t, idx):
    return t.index_select(-1, idx)


def _take_res(res: BP4Result, idx):
    return BP4Result(*[_take(f, idx) if f is not None else None for f in res])


def _flagged_first(flags, cap):
    """The first ``cap`` sample indices, flagged samples first in their
    original order (stable sort), and which of those are flagged."""
    order = torch.argsort(torch.logical_not(flags).to(torch.int8), stable=True)
    idx = order[:cap]
    return idx, flags[idx]


def sandwich_decode(graph, gnn_params_list: Sequence[Any], cfg: CascadeConfig, llr0,
                    syndrome_x, syndrome_z, gt_sx, gt_sz, qc=None, with_overflow: bool = False,
                    phi_impl: str | None = None):
    """Decode given syndromes.  ``gt_sx``/``gt_sz`` are the target syndromes
    the estimate must reproduce (they equal syndrome_z/syndrome_x's ground
    truth in evaluation).  ``qc`` (a codes.qc.QCPair) selects the fused QC
    decode for every BP run; None the gather decoder.  ``phi_impl`` is the
    phi formulation of every BP run (None = the cn_update default); the
    rescue stage passes its own through it.

    Returns (x_hat, z_hat) int32 [n_pad, B]; with ``with_overflow`` also a
    0-d int tensor counting DISTINCT flagged samples that did not fit a
    capacity at any level (level 1, level 2 or rescue).  They keep their
    earlier estimate: fail-safe but pessimistic.
    """
    if not qc_supported(cfg.cn_type):
        raise ValueError(f"unsupported cn_type {cfg.cn_type!r}")
    hz, hx = graph.hz, graph.hx

    if qc is not None:
        def run_bp(llr, syn_x, syn_z, num_iter, factor, need_logits=True):
            return bp4_decode_qc(graph, qc, llr, syn_x, syn_z, num_iter, cfg.cn_type, factor,
                                 need_logits=need_logits, msg_dtype=cfg.qc_msg_dtype,
                                 phi_impl=phi_impl)
    else:
        def run_bp(llr, syn_x, syn_z, num_iter, factor, need_logits=True):
            del need_logits  # the gather decoder always computes the logits
            return bp4_decode(graph, llr, syn_x, syn_z, num_iter, cfg.cn_type, factor,
                              phi_impl=phi_impl)

    def syndromes_differ(x_hat, z_hat, gt):
        return (torch.cat([mod2_matmul(hz, x_hat), mod2_matmul(hx, z_hat)], dim=0) != gt).any(dim=0)

    def gnn_rounds(res, x_hat, z_hat, syn_x, syn_z, gt, errors):
        """The nG (GNN -> BP-16 -> masked update) rounds."""
        for r in range(cfg.num_rounds):
            errors = errors & syndromes_differ(x_hat, z_hat, gt)
            h_vn = torch.stack([res.llrx, res.llry, res.llrz], dim=0)
            new_llr = feedback_gnn_apply(
                gnn_params_list[min(r, len(gnn_params_list) - 1)], graph, h_vn,
                res.z_logit,  # per-Hx-row logits (stage-mode z_logit)
                res.x_logit,  # per-Hz-row logits (stage-mode x_logit)
                syn_x, syn_z,
            )
            res = run_bp(new_llr, syn_x, syn_z, cfg.num_iter2, cfg.factor2)
            # masked update: only still-flagged samples adopt the new estimate
            x_hat = torch.where(errors[None, :], res.x_hat, x_hat)
            z_hat = torch.where(errors[None, :], res.z_hat, z_hat)
        return x_hat, z_hat

    # gt comparison rows: [Hz rows; Hx rows]
    gt = torch.cat([gt_sx, gt_sz], dim=0)

    stage1_iters = cfg.num_iter1
    if cfg.stage1_prepass is not None:
        if not cfg.compact_fraction:
            raise ValueError("stage1_prepass requires compact_fraction")
        stage1_iters = min(cfg.stage1_prepass, cfg.num_iter1)
    # the prepass result never feeds the GNN, so it skips the check logits
    prepass_active = cfg.stage1_prepass is not None and stage1_iters < cfg.num_iter1
    res = run_bp(llr0, syndrome_x, syndrome_z, stage1_iters, cfg.factor1,
                 need_logits=not prepass_active)
    x_hat, z_hat = res.x_hat, res.z_hat
    b = x_hat.shape[-1]
    dev = x_hat.device
    tile = cfg.qc_batch_tile if qc is not None else 8

    def finish(x_hat, z_hat, ov_mask):
        # ov_mask [B] int32 {0,1}: a sample lost a capacity somewhere; the
        # element-wise max over the levels counts each sample once
        if cfg.rescue_phi is not None:
            for impl in cfg.rescue_phi.split(","):
                x_hat, z_hat, r_ov_mask = _ensemble_rescue(
                    graph, gnn_params_list, cfg, impl.strip(), llr0, syndrome_x, syndrome_z,
                    gt_sx, gt_sz, x_hat, z_hat, qc=qc, main_phi_impl=phi_impl)
                ov_mask = torch.maximum(ov_mask, r_ov_mask)
        if with_overflow:
            return x_hat, z_hat, ov_mask.sum()
        return x_hat, z_hat

    if not cfg.compact_fraction:  # None and 0.0 both mean "off"
        if cfg.round_fraction:
            raise ValueError("round_fraction requires compact_fraction")
        x_hat, z_hat = gnn_rounds(res, x_hat, z_hat, syndrome_x, syndrome_z, gt,
                                  torch.ones(b, dtype=torch.bool, device=dev))
        return finish(x_hat, z_hat, torch.zeros(b, dtype=torch.int32, device=dev))

    # ---- flagged-sample compaction ----
    cap = _capacity(cfg.compact_fraction, b, tile)
    flags0 = syndromes_differ(x_hat, z_hat, gt)
    idx, valid = _flagged_first(flags0, cap)
    syn_x_s, syn_z_s, gt_s = _take(syndrome_x, idx), _take(syndrome_z, idx), _take(gt, idx)

    if prepass_active:
        # re-run the full stage-1 schedule on the flagged subset only
        sub_res = run_bp(_take(llr0, idx), syn_x_s, syn_z_s, cfg.num_iter1, cfg.factor1)
        x_s = torch.where(valid[None, :], sub_res.x_hat, _take(x_hat, idx))
        z_s = torch.where(valid[None, :], sub_res.z_hat, _take(z_hat, idx))
    else:
        sub_res = _take_res(res, idx)
        x_s, z_s = _take(x_hat, idx), _take(z_hat, idx)

    # samples flagged after stage 1 but beyond the level-1 capacity
    covered = torch.zeros(b, dtype=torch.bool, device=dev).index_copy(0, idx, valid)
    ov_mask = (flags0 & ~covered).to(torch.int32)

    if cfg.round_fraction is not None:
        # level 2: the GNN rounds act only on samples still flagged after
        # the full stage-1 schedule
        cap2 = min(cap, _capacity(cfg.round_fraction, b, tile))
        flags1 = syndromes_differ(x_s, z_s, gt_s) & valid
        idx2, valid2 = _flagged_first(flags1, cap2)
        covered2 = torch.zeros(cap, dtype=torch.bool, device=dev).index_copy(0, idx2, valid2)
        sub_ov = flags1 & ~covered2
        ov_mask = ov_mask.scatter_reduce(0, idx, sub_ov.to(torch.int32), "amax")
        x2, z2 = gnn_rounds(_take_res(sub_res, idx2), _take(x_s, idx2), _take(z_s, idx2),
                            _take(syn_x_s, idx2), _take(syn_z_s, idx2), _take(gt_s, idx2), valid2)
        x_sub = x_s.index_copy(1, idx2, x2)
        z_sub = z_s.index_copy(1, idx2, z2)
    else:
        x_sub, z_sub = gnn_rounds(sub_res, x_s, z_s, syn_x_s, syn_z_s, gt_s, valid)
    x_hat = x_hat.index_copy(1, idx, x_sub)
    z_hat = z_hat.index_copy(1, idx, z_sub)
    return finish(x_hat, z_hat, ov_mask)


def sandwich_eval_step(graph, gnn_params_list: Sequence[Any], cfg: CascadeConfig,
                       generator: torch.Generator, p, batch: int, wt: int | None = None,
                       return_full: bool = False, qc=None, return_overflow: bool = False):
    """Full Monte-Carlo evaluation step on the generator's device: sample
    the channel, compute syndromes, run the cascade, count errors.

    Returns 0-d tensors (flagged_count, logical_count), or with
    ``return_full`` (s_hat [B, mz+mx], ls_hat [B, Rx+Rz]) batch-first over
    the true (unpadded) rows.  With ``return_overflow`` a third output
    counts compaction and rescue overflows (see ``sandwich_decode``).
    """
    n, n_pad = graph.n, graph.n_pad
    if wt is not None:
        noise_x, noise_z = pauli_fixed_weight(generator, wt, n, batch)
    else:
        px, py, pz = depolarizing_probs(p)
        noise_x, noise_z = pauli_iid(generator, px, py, pz, n, batch)
    # aligned padded layout: zero pad rows
    noise_x = torch.nn.functional.pad(noise_x.to(torch.int32), (0, 0, 0, n_pad - n))
    noise_z = torch.nn.functional.pad(noise_z.to(torch.int32), (0, 0, 0, n_pad - n))

    hx, hz = graph.hx, graph.hz
    syndrome_x = mod2_matmul(hx, noise_z)  # [mx, B]
    syndrome_z = mod2_matmul(hz, noise_x)  # [mz, B]
    # ground-truth syndromes for the flag tracking: the same products
    gt_sx, gt_sz = syndrome_z, syndrome_x

    llr0 = prior_llr(cfg.p0, n, batch, n_pad=n_pad, device=noise_x.device)
    dec = sandwich_decode(graph, gnn_params_list, cfg, llr0, syndrome_x, syndrome_z, gt_sx, gt_sz,
                          qc=qc, with_overflow=return_overflow)
    x_diff = noise_x ^ dec[0]
    z_diff = noise_z ^ dec[1]

    sx, sz = mod2_matmul(hz, x_diff), mod2_matmul(hx, z_diff)
    lsx, lsz = mod2_matmul(graph.hx_perp, x_diff), mod2_matmul(graph.hz_perp, z_diff)
    if return_full:
        s_hat = torch.cat([sx[: graph.gz.num_cn], sz[: graph.gx.num_cn]], dim=0)
        ls_hat = torch.cat([lsx[: graph.hx_perp_rows], lsz[: graph.hz_perp_rows]], dim=0)
        return s_hat.T, ls_hat.T
    flagged_count = (torch.cat([sx, sz], dim=0) != 0).any(dim=0).sum()
    logical_count = (torch.cat([lsx, lsz], dim=0) != 0).any(dim=0).sum()
    if return_overflow:
        return flagged_count, logical_count, dec[2]
    return flagged_count, logical_count


def _ensemble_rescue(graph, gnn_params_list, cfg, rescue_impl, llr0, syndrome_x, syndrome_z,
                     gt_sx, gt_sz, x_hat, z_hat, qc=None, main_phi_impl=None):
    """Re-decode the still-flagged samples with the ``rescue_impl`` phi
    formulation and adopt the rescue estimate where it is syndrome-
    consistent (CascadeConfig.rescue_phi).  Warns when the rescue
    formulation equals the main one (``main_phi_impl``, None = the
    cn_update default): a guaranteed no-op that still costs a sub-batch
    cascade per batch.

    Returns (x_hat, z_hat, ov_mask [B] int32), ov_mask marking the
    still-flagged samples beyond the rescue capacity.
    """
    if rescue_impl not in cn_update._PHI_IMPLS:
        raise ValueError(f"unknown rescue phi formulation {rescue_impl!r}")
    effective_main = main_phi_impl if main_phi_impl is not None else cn_update._PHI_IMPL
    if rescue_impl == effective_main:
        warnings.warn(
            f"rescue_phi formulation {rescue_impl!r} equals the main "
            "cascade's phi formulation — the rescue stage is a guaranteed "
            "no-op but still costs a full extra sub-batch cascade per "
            "batch",
            stacklevel=3,
        )
    hz, hx = graph.hz, graph.hx
    b = x_hat.shape[-1]
    tile = cfg.qc_batch_tile if qc is not None else 8
    cap = _capacity(cfg.rescue_fraction, b, tile)

    # still flagged after the cascade: estimate syndromes != ground truth
    flags = (mod2_matmul(hz, x_hat) != gt_sx).any(dim=0) | (mod2_matmul(hx, z_hat) != gt_sz).any(dim=0)
    idx, valid = _flagged_first(flags, cap)
    covered = torch.zeros(b, dtype=torch.bool, device=flags.device).index_copy(0, idx, valid)
    ov_mask = (flags & ~covered).to(torch.int32)

    syn_x_s, syn_z_s = _take(syndrome_x, idx), _take(syndrome_z, idx)
    gt_sx_s, gt_sz_s = _take(gt_sx, idx), _take(gt_sz, idx)
    # the rescue sub-batch is already compacted: the plain cascade on it
    rcfg = replace(cfg, compact_fraction=None, round_fraction=None, stage1_prepass=None,
                   rescue_phi=None)
    rx, rz = sandwich_decode(graph, gnn_params_list, rcfg, _take(llr0, idx), syn_x_s, syn_z_s,
                             gt_sx_s, gt_sz_s, qc=qc, phi_impl=rescue_impl)

    converged = (mod2_matmul(hz, rx) == gt_sx_s).all(dim=0) & (mod2_matmul(hx, rz) == gt_sz_s).all(dim=0)
    adopt = (valid & converged)[None, :]
    x_hat = x_hat.index_copy(1, idx, torch.where(adopt, rx, _take(x_hat, idx)))
    z_hat = z_hat.index_copy(1, idx, torch.where(adopt, rz, _take(z_hat, idx)))
    return x_hat, z_hat, ov_mask
