"""Flagged-first compaction, the one place of the package that decides a
sub-batch: its capacity, flagged samples first in their order (a stable sort),
the flagged samples it leaves out, and the merge back.  The expressions are the
JAX package's (``feedback_gnn_tpu/decoders/cascade.py``), so every sample lands
in the same slot."""

import math

import torch

__all__ = ["capacity", "flagged_first", "overflow", "merge"]


def capacity(fraction, batch: int, tile: int) -> int:
    """ceil(fraction * batch) rounded up to a multiple of ``tile``, at most ``batch``."""
    return min(batch, -(-int(math.ceil(fraction * batch)) // tile) * tile)


def flagged_first(flags, cap: int):
    """The first ``cap`` sample indices, flagged samples first, and which of them are flagged."""
    idx = torch.argsort(torch.logical_not(flags).to(torch.int8), stable=True)[:cap]
    return idx, flags[idx]


def overflow(flags, idx, valid):
    """[B] bool: the flagged samples that the sub-batch ``idx`` leaves out."""
    return flags & ~torch.zeros_like(flags).index_copy(0, idx, valid)


def merge(full, idx, sub, adopt):
    """``full`` [rows, B] with column ``idx[j]`` replaced by ``sub[:, j]`` where ``adopt[j]``."""
    return full.index_copy(1, idx, torch.where(adopt[None, :], sub, full[:, idx]))
