"""System models: end-to-end Monte-Carlo step functions composing a
channel, a decoder and the error accounting, with the semantics of
``feedback_gnn_tpu/models.py``.

Each step returns ``(flagged_count, logical_count)`` as 0-d int32 tensors
and runs on the generator's device.  Each is a sampling part followed by
a decode-and-count part that takes the noise as an argument
(``bp2_bsc_count``, ``bp4_plain_count``), so that the same noise can be
given to this package and to the JAX package.

  bp2_bsc_eval_step    binary syndrome BP over a BSC (gather decoder, or
                       the fused QC kernel with ``qc_spec``)
  bp4_plain_eval_step  plain BP4 over the depolarizing channel
  bp4_osd_eval_step    BP4 + OSD-0 over the depolarizing channel
  bp2_osd_eval_step    BP2 + OSD-0 over a BSC
  sandwich_eval_step   the feedback-GNN cascade (decoders/cascade.py)
  gnn_bp4_eval_step    the fully-learned GNN decoder (decoders/gnn_full.py)
                       over the depolarizing channel

The OSD steps decode with the gather decoders, as the JAX package's do.
"""

from __future__ import annotations

import torch

from .channels.bsc import bsc_sample
from .channels.pauli import depolarizing_probs, pauli_fixed_weight, pauli_iid
from .decoders.bp2 import bp2_decode
from .decoders.bp2_qc import bp2_qc_logits
from .decoders.bp4 import bp4_decode
from .decoders.cascade import prior_llr, sandwich_eval_step  # noqa: F401
from .decoders.cascade import _flagged_first
from .decoders.gnn_full import gnn_bp4_apply
from .decoders.graph_ops import pad_rows_to
from .decoders.osd import bp_osd_correct, osd0_decode
from .ops.gf2mat import mod2_matmul

__all__ = [
    "bp2_bsc_eval_step",
    "bp2_bsc_count",
    "bp4_plain_eval_step",
    "bp4_plain_count",
    "bp4_osd_eval_step",
    "bp4_osd_count",
    "bp2_osd_eval_step",
    "bp2_osd_count",
    "sandwich_eval_step",
    "gnn_bp4_eval_step",
    "gnn_bp4_count",
]


def _counts(s_hat, ls_hat, accounting: str = "all"):
    """Per-batch error counts (flagged, logical).

    accounting="all": a block is a logical error when any logical-syndrome
    row is nonzero, so every non-converged sample whose residual touches a
    logical row also counts (the convention of every headline table).

    accounting="undetected": count only syndrome-consistent outputs that
    flip a logical (s_hat == 0 AND ls_hat != 0), the convention of the
    plain-BP tables of the TF original's OSD notebook.
    """
    fl = (s_hat != 0).any(dim=0)
    lg = (ls_hat != 0).any(dim=0)
    if accounting == "undetected":
        lg = lg & ~fl
    elif accounting != "all":
        raise ValueError(f"unknown accounting {accounting!r}")
    return fl.sum(dtype=torch.int32), lg.sum(dtype=torch.int32)


def _llr_const(p):
    """-log((1 - p) / p) in float32: the channel logit of a BSC prior p."""
    return -torch.log(torch.tensor((1.0 - p) / p, dtype=torch.float32)).item()


def bp2_bsc_count(pcm_graph, pcm, logical_pcm, noise, p, num_iter: int = 100,
                  cn_type: str = "minsum", normalization_factor: float = 0.8, p0=None,
                  qc_spec=None, accounting: str = "all"):
    """Decode the syndrome of a given BSC error pattern ``noise`` [n, B]
    (0/1) and count the errors; the decode-and-count part of
    ``bp2_bsc_eval_step``."""
    dev = noise.device
    pcm = torch.as_tensor(pcm, dtype=torch.float32, device=dev)
    logical_pcm = torch.as_tensor(logical_pcm, dtype=torch.float32, device=dev)
    n, batch = noise.shape
    noise = noise.to(torch.int32)
    p_prior = p if p0 is None else p0
    llr_true = torch.full((n, batch), _llr_const(p_prior), dtype=torch.float32, device=dev)
    syndrome = mod2_matmul(pcm, noise)

    if qc_spec is not None:
        logits = bp2_qc_logits(qc_spec, llr_true, syndrome[: qc_spec.mb * qc_spec.l], num_iter,
                               cn_type, normalization_factor)
        noise_hat = (logits > 0.0).to(torch.int32)
    else:
        llr = pad_rows_to(llr_true, pcm_graph.n_pad)  # zero pad rows
        res = bp2_decode(pcm_graph, llr, syndrome, num_iter, cn_type, normalization_factor)
        noise_hat = res.hard[:n]

    diff = noise ^ noise_hat
    return _counts(mod2_matmul(pcm, diff), mod2_matmul(logical_pcm, diff), accounting)


def bp2_bsc_eval_step(pcm_graph, pcm, logical_pcm, generator: torch.Generator, p, batch: int,
                      num_iter: int = 100, cn_type: str = "minsum",
                      normalization_factor: float = 0.8, p0=None, qc_spec=None,
                      accounting: str = "all"):
    """Binary syndrome BP over a BSC with a logical-operator check.
    ``pcm`` is one of hx/hz (the decoding graph, ``pcm_graph`` its
    ``TannerGraph`` of tensors), ``logical_pcm`` the matrix of the logical
    check.  ``qc_spec`` (the ``QCGraphSpec`` of ``pcm``) switches to the
    fused QC kernel.  ``accounting``: see ``_counts``."""
    noise = bsc_sample(generator, p, (pcm.shape[1], batch))
    return bp2_bsc_count(pcm_graph, pcm, logical_pcm, noise, p, num_iter, cn_type,
                         normalization_factor, p0, qc_spec, accounting)


def bp4_plain_count(graph, noise_x, noise_z, p, num_iter: int = 64,
                    cn_type: str = "boxplus-phi", normalization_factor: float = 1.0, p0=None,
                    accounting: str = "all"):
    """Decode the syndromes of given Pauli errors ``noise_x``/``noise_z``
    [n, B] (0/1) with the gather BP4 and count the errors; the
    decode-and-count part of ``bp4_plain_eval_step``."""
    n, batch = noise_x.shape
    noise_x = pad_rows_to(noise_x.to(torch.int32), graph.n_pad)
    noise_z = pad_rows_to(noise_z.to(torch.int32), graph.n_pad)
    syndrome_x = mod2_matmul(graph.hx, noise_z)
    syndrome_z = mod2_matmul(graph.hz, noise_x)
    p_prior = p if p0 is None else p0
    llr0 = prior_llr(p_prior, n, batch, n_pad=graph.n_pad, device=noise_x.device)

    res = bp4_decode(graph, llr0, syndrome_x, syndrome_z, num_iter, cn_type, normalization_factor)
    x_diff = noise_x ^ res.x_hat
    z_diff = noise_z ^ res.z_hat
    s_hat = torch.cat([mod2_matmul(graph.hz, x_diff), mod2_matmul(graph.hx, z_diff)], dim=0)
    ls_hat = torch.cat([mod2_matmul(graph.hx_perp, x_diff), mod2_matmul(graph.hz_perp, z_diff)],
                       dim=0)
    return _counts(s_hat, ls_hat, accounting)


def bp4_plain_eval_step(graph, generator: torch.Generator, p, batch: int, num_iter: int = 64,
                        cn_type: str = "boxplus-phi", normalization_factor: float = 1.0, p0=None,
                        accounting: str = "all"):
    """Plain BP4 evaluation over the depolarizing channel (the TF
    original's "plain BP4" rows; its notebook tables use
    accounting="undetected", see ``_counts``).  ``graph`` is a
    ``QuantumGraph`` of tensors."""
    px, py, pz = depolarizing_probs(p)
    noise_x, noise_z = pauli_iid(generator, px, py, pz, graph.n, batch)
    return bp4_plain_count(graph, noise_x, noise_z, p, num_iter, cn_type, normalization_factor,
                           p0, accounting)


def bp4_osd_count(graph, code, noise_x, noise_z, p, num_iter: int = 100, cn_type: str = "minsum",
                  normalization_factor: float = 0.8, osd_compact_cap: int | None = None):
    """Decode the syndromes of given Pauli errors ``noise_x``/``noise_z``
    [n, B] with BP4 and OSD-0 on the BP-flagged samples, and count the
    errors; the decode-and-count part of ``bp4_osd_eval_step``."""
    n, batch = noise_x.shape
    noise_x = pad_rows_to(noise_x.to(torch.int32), graph.n_pad)
    noise_z = pad_rows_to(noise_z.to(torch.int32), graph.n_pad)
    syndrome_x = mod2_matmul(graph.hx, noise_z)
    syndrome_z = mod2_matmul(graph.hz, noise_x)
    llr0 = prior_llr(p, n, batch, n_pad=graph.n_pad, device=noise_x.device)

    res = bp4_decode(graph, llr0, syndrome_x, syndrome_z, num_iter, cn_type, normalization_factor)
    x_hat, z_hat, flagged, osd_overflow = bp_osd_correct(
        graph, res, noise_x, noise_z, code.pivot_hx, code.pivot_hz, code.hx_basis, code.hz_basis,
        compact_cap=osd_compact_cap)
    x_diff = noise_x ^ x_hat
    z_diff = noise_z ^ z_hat
    # the logical check uses lz/lx, as the reference's BP4_OSD_Model does
    ls_hat = torch.cat([mod2_matmul(graph.lz, x_diff), mod2_matmul(graph.lx, z_diff)], dim=0)
    logical = (ls_hat != 0).any(dim=0).sum(dtype=torch.int32)
    # first output: the BP-flagged samples routed to OSD (a diagnostic; the
    # LER is the same either way)
    if osd_compact_cap is not None:
        return flagged.sum(dtype=torch.int32), logical, osd_overflow
    return flagged.sum(dtype=torch.int32), logical


def bp4_osd_eval_step(graph, code, generator: torch.Generator, p, batch: int, num_iter: int = 100,
                      cn_type: str = "minsum", normalization_factor: float = 0.8,
                      osd_compact_cap: int | None = None):
    """BP4 + OSD-0 fallback over the depolarizing channel.  ``graph`` is a
    ``QuantumGraph`` of tensors, ``code`` the ``CSSCode`` (its bases and
    pivots).  With ``osd_compact_cap`` OSD runs on a dense flagged-only
    sub-batch of that size and a third output counts the flagged samples
    beyond it."""
    px, py, pz = depolarizing_probs(p)
    noise_x, noise_z = pauli_iid(generator, px, py, pz, graph.n, batch)
    return bp4_osd_count(graph, code, noise_x, noise_z, p, num_iter, cn_type, normalization_factor,
                         osd_compact_cap)


def bp2_osd_count(pcm_graph, pcm, pcm_basis, pivot_pcm, logical_pcm, noise, p, num_iter: int = 100,
                  cn_type: str = "minsum", normalization_factor: float = 0.8,
                  osd_compact_cap: int | None = None):
    """Decode the syndrome of a given BSC error pattern ``noise`` [n, B] with
    BP2 and OSD-0 on the BP-flagged samples, and count the errors; the
    decode-and-count part of ``bp2_osd_eval_step``."""
    dev = noise.device
    pcm = torch.as_tensor(pcm, dtype=torch.float32, device=dev)
    logical_pcm = torch.as_tensor(logical_pcm, dtype=torch.float32, device=dev)
    n, batch = noise.shape
    noise = noise.to(torch.int32)
    llr = torch.full((n, batch), _llr_const(p), dtype=torch.float32, device=dev)
    syndrome = mod2_matmul(pcm, noise)

    res = bp2_decode(pcm_graph, pad_rows_to(llr, pcm_graph.n_pad), syndrome, num_iter, cn_type,
                     normalization_factor)
    noise_hat = res.hard[:n]
    flagged = (mod2_matmul(pcm, noise ^ noise_hat) != 0).any(dim=0)

    # OSD on the soft output, in the "true llr" convention
    osd_llr = -res.logits[:n]
    reduced_s = syndrome[torch.as_tensor(pivot_pcm, device=dev)]
    if osd_compact_cap is not None:
        cap = min(batch, int(osd_compact_cap))
        idx, valid = _flagged_first(flagged, cap)
        osd_sub = osd0_decode(osd_llr.T[idx], pcm_basis, reduced_s[:, idx]).T  # [n, cap]
        upd = torch.where(valid[None, :], osd_sub, noise_hat[:, idx])
        noise_final = noise_hat.index_copy(1, idx, upd)
        osd_overflow = flagged.sum(dtype=torch.int32) - valid.sum(dtype=torch.int32)
    else:
        noise_final = torch.where(flagged[None, :], osd0_decode(osd_llr.T, pcm_basis, reduced_s).T,
                                  noise_hat)
    ls_hat = mod2_matmul(logical_pcm, noise ^ noise_final)
    logical = (ls_hat != 0).any(dim=0).sum(dtype=torch.int32)
    if osd_compact_cap is not None:
        return flagged.sum(dtype=torch.int32), logical, osd_overflow
    return flagged.sum(dtype=torch.int32), logical


def bp2_osd_eval_step(pcm_graph, pcm, pcm_basis, pivot_pcm, logical_pcm, generator: torch.Generator,
                      p, batch: int, num_iter: int = 100, cn_type: str = "minsum",
                      normalization_factor: float = 0.8, osd_compact_cap: int | None = None):
    """BP2 + OSD-0 over a BSC.  ``pcm`` (one of hx/hz) is the decoding
    matrix and ``pcm_graph`` its ``TannerGraph`` of tensors, ``pcm_basis``
    and ``pivot_pcm`` its full-rank basis and pivot rows, ``logical_pcm``
    the matrix of the logical check.  ``osd_compact_cap``: see
    ``bp4_osd_eval_step``."""
    noise = bsc_sample(generator, p, (pcm.shape[1], batch))
    return bp2_osd_count(pcm_graph, pcm, pcm_basis, pivot_pcm, logical_pcm, noise, p, num_iter,
                         cn_type, normalization_factor, osd_compact_cap)


@torch.no_grad()
def gnn_bp4_count(graph, lrowsets, params, cfg, noise_x, noise_z):
    """Decode the syndromes of given Pauli errors ``noise_x``/``noise_z``
    [n, B] (0/1) with GNN_BP4 and count the errors; the decode-and-count
    part of ``gnn_bp4_eval_step``."""
    noise_x = pad_rows_to(noise_x.to(torch.int32), graph.n_pad)
    noise_z = pad_rows_to(noise_z.to(torch.int32), graph.n_pad)
    syndrome_x = mod2_matmul(graph.hx, noise_z)
    syndrome_z = mod2_matmul(graph.hz, noise_x)

    x_hat, z_hat, _ = gnn_bp4_apply(params, graph, lrowsets, syndrome_x, syndrome_z, cfg)
    x_diff = noise_x ^ x_hat
    z_diff = noise_z ^ z_hat
    s_hat = torch.cat([mod2_matmul(graph.hz, x_diff), mod2_matmul(graph.hx, z_diff)], dim=0)
    ls_hat = torch.cat([mod2_matmul(graph.hx_perp, x_diff), mod2_matmul(graph.hz_perp, z_diff)],
                       dim=0)
    return _counts(s_hat, ls_hat)


def gnn_bp4_eval_step(graph, lrowsets, params, cfg, generator: torch.Generator, p, batch: int,
                      wt: int | None = None):
    """Monte-Carlo evaluation of the fully-learned GNN decoder: Pauli noise
    (exactly ``wt`` errors a sample when ``wt`` is given, else depolarizing
    of strength ``p``) -> syndromes -> GNN_BP4 -> (flagged, logical).
    ``graph`` is a ``QuantumGraph`` of tensors, ``lrowsets`` from
    ``decoders.gnn_full.make_logit_rowsets``, ``params``/``cfg`` GNN_BP4's."""
    if wt is not None:
        noise_x, noise_z = pauli_fixed_weight(generator, wt, graph.n, batch)
    else:
        px, py, pz = depolarizing_probs(p)
        noise_x, noise_z = pauli_iid(generator, px, py, pz, graph.n, batch)
    return gnn_bp4_count(graph, lrowsets, params, cfg, noise_x, noise_z)
