"""Deep-supervision loss of feedback-GNN training, the port of
``feedback_gnn_tpu/train/loss.py``.

The sum over BP iterations of the BCE-with-logits between the FLIPPED
syndrome labels and the per-iteration check logits, on both sides:

  gt_x = 1 - syndrome_z   (the logit predicts "check satisfied")
  gt_z = 1 - syndrome_x

With the logit stack of ``bp4_decode(collect_logits=True)`` (xs[i] the
logits of iteration i, xs[num_iter] the final ones) the terms are stack
indices loss_from+1 .. num_iter.  ``axis`` (the edge group of an
edge-sharded graph, or None) completes each mean across the row partition:
its numerator and denominator are summed over the group.
"""

from __future__ import annotations

import torch

from ..decoders.cn_update import clip
from ..parallel.collectives import psum

__all__ = ["bce_with_logits", "deep_supervision_loss"]


def _bce_elem(labels, logits):
    return clip(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def bce_with_logits(labels, logits, row_valid=None, axis=None):
    """Mean sigmoid cross-entropy (Keras BinaryCrossentropy(from_logits)).
    ``row_valid`` [R] masks rows out of the mean (pad rows, phantom rows of
    an edge shard); ``axis`` completes the mean across the edge shards."""
    elem = _bce_elem(labels, logits)
    if row_valid is None and axis is None:
        return elem.mean()
    if row_valid is None:
        row_valid = torch.ones(elem.shape[0], dtype=elem.dtype, device=elem.device)
    num = psum((elem * row_valid[:, None]).sum(), axis)
    den = psum(row_valid.sum() * elem.shape[1], axis)
    return num / den


def deep_supervision_loss(logit_stack, syndrome_x, syndrome_z, num_iter: int, loss_from: int = 8,
                          row_valid_x=None, row_valid_z=None, axis=None):
    """Sum of per-iteration BCE terms.

    Args:
      logit_stack: (xs, zs) each [num_iter+1, R, B] from bp4_decode with
        collect_logits=True.
      syndrome_x / syndrome_z: [mx, B] / [mz, B] in {0,1}, rows aligned
        with the logit rows (the shard's rows under edge sharding).
    """
    xs, zs = logit_stack
    gt_x = 1.0 - syndrome_z.to(torch.float32)  # label flip
    gt_z = 1.0 - syndrome_x.to(torch.float32)
    loss = 0.0
    for i in range(loss_from + 1, num_iter + 1):
        loss = (loss + bce_with_logits(gt_x, xs[i], row_valid_x, axis)
                + bce_with_logits(gt_z, zs[i], row_valid_z, axis))
    return loss
