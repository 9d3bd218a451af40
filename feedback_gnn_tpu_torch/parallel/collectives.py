"""The collectives of the sharded paths, over ``torch.distributed`` process
groups: the counterparts of JAX's ``psum``, ``pmean``, ``pvary``, ``pmax``
and ``pmin`` inside ``shard_map``.

Every function takes ``group``, a ``ProcessGroup`` or None; None (an axis of
size 1, or no mesh) makes it the identity.  Only ``all_reduce`` is used:
Gloo, the backend of ranks that share a card, does little else on CUDA
tensors.

Differentiation follows JAX's rules for replicated and shard-local values.
``psum`` turns shard-local partial values into a replicated one, so its
backward is the identity; ``pvary`` marks a replicated value (a parameter,
or a result of ``psum``) where it enters a shard-local computation, so its
forward is the identity and its backward sums the shard-local cotangents
over the group.  A replicated value consumed by replicated computation
needs no mark: every rank computes the whole of its cotangent.  Summing the
finished gradients over the group instead would count that replicated part
once per rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["psum", "pmean", "pvary", "pvary_tree", "pmax", "pmin", "por"]


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _PExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return _all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("pmax/pmin across a process group are not differentiable "
                           "(as JAX's are not)")


def psum(x, group):
    """Sum over the group; every rank gets the same result."""
    return x if group is None else _PSum.apply(x, group)


def pmean(x, group):
    """Mean over the group."""
    return x if group is None else _PSum.apply(x, group) / dist.get_world_size(group)


def pvary(x, group):
    """Identity that marks a replicated value entering shard-local work."""
    return x if group is None else _PVary.apply(x, group)


def pvary_tree(tree, group):
    """``pvary`` on every tensor of a parameter tree (nested dicts and
    lists), for parameters used only in shard-local work."""
    if group is None:
        return tree
    if isinstance(tree, dict):
        return {k: pvary_tree(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [pvary_tree(v, group) for v in tree]
    return pvary(tree, group)


def pmax(x, group):
    return x if group is None else _PExtreme.apply(x, group, dist.ReduceOp.MAX)


def pmin(x, group):
    return x if group is None else _PExtreme.apply(x, group, dist.ReduceOp.MIN)


def por(flags, group):
    """Element-wise logical or of a bool tensor over the group."""
    return flags if group is None else _all_reduce(flags.to(torch.int32), group) > 0
