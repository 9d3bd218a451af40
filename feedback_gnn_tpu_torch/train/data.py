"""Failure mining for the training curriculum, the port of
``feedback_gnn_tpu/train/data.py``.

 1. "easy" set: fixed-weight Pauli noise that plain BP4-64 fails to decode
    (flagged), mined per weight;
 2. "hard" set: noise still flagged after BP4-64 -> coarse GNN -> BP4-64;
 3. final mix: easy + hard x 50 oversampling.

A miner is a sampler (generator, wt, batch) -> (noise_x, noise_z) plus a
body that decodes given noise, so tests can feed it another package's
noise.  With ``qc`` (a ``QCPair``) the body's BP runs on the fused QC
decode, i.e. K1 on the card (``csrc/bp4_qc.cu``); else on the gather
decoder.  Every output stays on the device; with ``compact_cap`` the
flagged samples are packed to the front on the device, so a host copy of
[n, cap] uint8 replaces one of [n, B].  Mining generators are seeded per
(weight, batch) from ``numpy.random.SeedSequence``, so a shard replays
alone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..channels.pauli import pauli_fixed_weight, pauli_fixed_weight_traced
from ..decoders.bp4 import bp4_decode
from ..decoders.bp4_qc import bp4_decode_qc
from ..decoders.cascade import prior_llr
from ..decoders.compact import flagged_first
from ..decoders.gnn_feedback import feedback_gnn_apply
from ..ops.gf2mat import mod2_matmul
from .trainer import _pad_noise, _syndromes

__all__ = [
    "FailureMiner", "make_bp_failure_miner", "make_cascade_failure_miner", "mine_failures",
    "mix_easy_hard", "batch_iterator", "batch_iterator_stacked", "shard_seed",
]


def shard_seed(*words: int) -> int:
    """A generator seed: a 64-bit word of ``SeedSequence(words)``."""
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])


def _flagged_after(graph, x_hat, z_hat, noise_x, noise_z):
    """[B] bool: the estimate leaves a nonzero syndrome."""
    sx = mod2_matmul(graph.hz, _pad_noise(graph, noise_x) ^ x_hat)
    sz = mod2_matmul(graph.hx, _pad_noise(graph, noise_z) ^ z_hat)
    return (sx != 0).any(dim=0) | (sz != 0).any(dim=0)


def _make_run_bp(graph, qc, need_logits: bool):
    """The miners' BP: ``bp4_decode_qc`` (K1 on the card) with ``qc``, else
    the gather ``bp4_decode``."""
    if qc is None:
        def run_bp(llr, syn_x, syn_z, num_iter, cn_type):
            return bp4_decode(graph, llr, syn_x, syn_z, num_iter, cn_type)
    else:
        def run_bp(llr, syn_x, syn_z, num_iter, cn_type):
            return bp4_decode_qc(graph, qc, llr, syn_x, syn_z, num_iter, cn_type,
                                 need_logits=need_logits)
    return run_bp


@dataclass(frozen=True)
class FailureMiner:
    """``miner(generator, wt, batch)`` = ``body(*sample(generator, wt, batch))``.

    ``sample`` draws fixed-weight noise [n, B] on the generator's device;
    ``body(noise_x, noise_z)`` returns (noise_x [n,B], noise_z, flagged [B]),
    or with ``compact_cap`` (nx [n,cap] uint8, nz, kept)."""

    sample: Callable
    body: Callable
    device: torch.device

    def __call__(self, generator: torch.Generator, wt, batch: int):
        return self.body(*self.sample(generator, wt, batch))


def _sampler(graph, wt_max):
    def sample(generator, wt, batch):
        if wt_max is None:
            return pauli_fixed_weight(generator, int(wt), graph.n, batch)
        return pauli_fixed_weight_traced(generator, wt, graph.n, batch, wt_max)
    return sample


def _prepare(graph, p0, noise_x, noise_z):
    noise_x, noise_z = _pad_noise(graph, noise_x), _pad_noise(graph, noise_z)
    syndrome_x, syndrome_z = _syndromes(graph, noise_x, noise_z)
    llr0 = prior_llr(p0, graph.n, noise_x.shape[-1], n_pad=graph.n_pad, device=noise_x.device)
    return noise_x, noise_z, syndrome_x, syndrome_z, llr0


def _finish(graph, res, noise_x, noise_z, compact_cap):
    """(noise_x [n, B], noise_z, flagged [B]); with ``compact_cap`` the
    flagged samples packed to the front in their order (``flagged_first``),
    cut to ``compact_cap`` columns: (nx [n, cap] uint8, nz, kept), ``kept``
    the 0-d count of valid columns."""
    flagged = _flagged_after(graph, res.x_hat, res.z_hat, noise_x, noise_z)
    n = graph.n
    if compact_cap is None:
        return noise_x[:n], noise_z[:n], flagged
    idx, _ = flagged_first(flagged, compact_cap)
    kept = flagged.sum().clamp_max(compact_cap).to(torch.int32)
    return noise_x[:n].to(torch.uint8)[:, idx], noise_z[:n].to(torch.uint8)[:, idx], kept


def make_bp_failure_miner(graph, num_iter=64, p0=0.05, cn_type="boxplus-phi", wt_max=None,
                          compact_cap=None, qc=None) -> FailureMiner:
    """Easy-set miner: noise flagged after plain BP4 of ``num_iter``
    iterations (the reference's BP4_Error_Model).  ``wt_max``: one draw of
    wt_max positions serves every weight up to it (the sampler masks the
    tail); ``compact_cap``: pack the flagged samples on the device (see
    ``_finish``); ``qc``: run BP on the fused QC decode."""
    run_bp = _make_run_bp(graph, qc, need_logits=False)

    @torch.no_grad()
    def body(noise_x, noise_z):
        noise_x, noise_z, syn_x, syn_z, llr0 = _prepare(graph, p0, noise_x, noise_z)
        res = run_bp(llr0, syn_x, syn_z, num_iter, cn_type)
        return _finish(graph, res, noise_x, noise_z, compact_cap)

    return FailureMiner(_sampler(graph, wt_max), body, graph.hx.device)


def make_cascade_failure_miner(graph, gnn_params, num_iter1=64, num_iter2=64, p0=0.05,
                               cn_type="boxplus-phi", wt_max=None, compact_cap=None,
                               qc=None) -> FailureMiner:
    """Hard-set miner: noise still flagged after BP4 -> GNN -> BP4 (the
    reference's Feedback_GNN_Error_Model).  With ``qc`` both BP runs are K1
    launches on the card; the first also computes its check logits, which
    the GNN reads.  Other arguments as ``make_bp_failure_miner``."""
    run_bp = _make_run_bp(graph, qc, need_logits=True)

    @torch.no_grad()
    def body(noise_x, noise_z):
        noise_x, noise_z, syn_x, syn_z, llr0 = _prepare(graph, p0, noise_x, noise_z)
        res = run_bp(llr0, syn_x, syn_z, num_iter1, cn_type)
        h_vn = torch.stack([res.llrx, res.llry, res.llrz], dim=0)
        new_llr = feedback_gnn_apply(gnn_params, graph, h_vn, res.z_logit, res.x_logit,
                                     syn_x, syn_z)
        res2 = run_bp(new_llr, syn_x, syn_z, num_iter2, cn_type)
        return _finish(graph, res2, noise_x, noise_z, compact_cap)

    return FailureMiner(_sampler(graph, wt_max), body, graph.hx.device)


def mine_failures(miner: FailureMiner, seed: int, weights, batches_per_weight: int,
                  batch_size: int, out_dir=None, prefix=""):
    """Run a miner (built without ``compact_cap``) over a weight schedule;
    returns {wt: (x, z)}, uint8 arrays [num_failed, n] (batch-first on the
    host, as the reference's .npy shards).  Batch b of weight wt draws from
    a generator seeded with ``shard_seed(seed, wt, b)``."""
    generator = torch.Generator(device=miner.device)
    shards = {}
    for wt in weights:
        xs, zs = [], []
        for b in range(batches_per_weight):
            generator.manual_seed(shard_seed(seed, wt, b))
            noise_x, noise_z, flagged = miner(generator, int(wt), int(batch_size))
            mask = flagged.cpu().numpy()
            xs.append(noise_x.cpu().numpy().T[mask])
            zs.append(noise_z.cpu().numpy().T[mask])
        x = np.vstack(xs).astype(np.uint8)
        z = np.vstack(zs).astype(np.uint8)
        shards[wt] = (x, z)
        if out_dir:
            np.save(os.path.join(out_dir, f"{prefix}_wt{wt}_x.npy"), x)
            np.save(os.path.join(out_dir, f"{prefix}_wt{wt}_z.npy"), z)
    return shards


def mix_easy_hard(easy, hard, hard_oversample=50):
    """Final training mix: easy + hard x oversample."""
    ex, ez = easy
    hx_, hz_ = hard
    x = np.vstack([ex] + [hx_] * hard_oversample)
    z = np.vstack([ez] + [hz_] * hard_oversample)
    return x, z


def _permutation(num, generator, perm):
    if perm is None:
        perm = torch.randperm(num, generator=generator).numpy()
    return np.asarray(perm)


def batch_iterator(x, z, batch_size, generator=None, perm=None, drop_remainder=True,
                   device="cpu"):
    """Shuffled epoch over host arrays x, z [num, n], yielding [n, B]
    tensors on ``device``.  The order is ``perm`` if given, else a
    ``torch.randperm`` from ``generator`` (a CPU generator)."""
    num = x.shape[0]
    perm = _permutation(num, generator, perm)
    stop = num - (num % batch_size) if drop_remainder else num
    for s in range(0, stop, batch_size):
        idx = perm[s: s + batch_size]
        yield (torch.as_tensor(np.ascontiguousarray(x[idx].T), device=device),
               torch.as_tensor(np.ascontiguousarray(z[idx].T), device=device))


def batch_iterator_stacked(x, z, batch_size, generator=None, k=1, perm=None, device="cpu"):
    """Like ``batch_iterator`` but yields ([j, n, B], [j, n, B]) stacks of
    j <= k consecutive minibatches, one host-to-device copy each; their
    concatenation is ``batch_iterator``'s sequence for the same order."""
    num = x.shape[0]
    perm = _permutation(num, generator, perm)
    stop = num - (num % batch_size)
    starts = list(range(0, stop, batch_size))
    for c in range(0, len(starts), k):
        idx = np.stack([perm[s: s + batch_size] for s in starts[c: c + k]])  # [j, B]
        yield (torch.as_tensor(np.ascontiguousarray(x[idx].transpose(0, 2, 1)), device=device),
               torch.as_tensor(np.ascontiguousarray(z[idx].transpose(0, 2, 1)), device=device))
