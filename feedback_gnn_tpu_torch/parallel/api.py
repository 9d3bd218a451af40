"""Data-parallel and edge-partitioned execution of the evaluation cascade
and the train step over a ('data', 'edge') grid of ranks, the port of
``feedback_gnn_tpu/parallel/api.py``.  Every rank runs the same Python
(one process per rank, the PyTorch idiom for JAX's ``shard_map``):

    init_distributed()                                   # torchrun's env://
    mesh = make_mesh(data=4, edge=1)
    stacked = shard_quantum_graph(graph, mesh.edge)
    step = make_sharded_eval_step(mesh, stacked, [params], cfg, local_batch)
    flagged, logical = step(generator, p)                # global counts, every rank

The global batch of a call is ``local_batch * mesh.data``.  Each rank keeps
only its own shard of the graph on its device.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from ..decoders.cascade import CascadeConfig, data_seed, sandwich_eval_step
from ..train.trainer import stage_one_features, stage_two_loss
from .collectives import pmean, por
from .mesh import Mesh
from .shard import unstack_shard

__all__ = ["make_sharded_eval_step", "make_sharded_train_step", "rank_graph"]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


def rank_graph(mesh: Mesh, stacked_graph):
    """This rank's shard of a stacked bundle, as tensors on its device."""
    return unstack_shard(stacked_graph, mesh.edge_index).to(mesh.device)


def make_sharded_eval_step(mesh: Mesh, stacked_graph, gnn_params_list: Sequence[Any],
                           cfg: CascadeConfig, local_batch: int, wt: int | None = None, qc=None,
                           return_overflow: bool = False):
    """(generator, p) -> (flagged_count, logical_count) summed over the
    grid, the same on every rank; with ``return_overflow`` a third count of
    compaction and rescue overflows.

    ``stacked_graph`` comes from ``shard_quantum_graph(graph, mesh.edge)``.
    Each data rank decodes ``local_batch`` samples drawn from its own
    generator, seeded ``data_seed(generator.initial_seed(), data_index)``,
    so the edge ranks of one data index draw the same noise.  ``qc`` (a
    ``QCPair``) runs every BP of each data rank through K1, the production
    multi-device mode; it needs edge 1, as compaction and the rescue do
    (``sandwich_decode`` refuses them on an edge shard).
    """
    edge_axis = mesh.edge_group if mesh.edge > 1 else None
    if edge_axis is not None and qc is not None:
        raise ValueError(
            "the fused QC kernel is shard-local and cannot run with edge-partitioned PCM rows "
            "(edge shards > 1).  Use pure data parallelism (--edge-shards 1; the production "
            "multi-device mode, README 'Edge partitioning') or drop --qc-kernel to use the "
            "gather decoder, which supports edge sharding.")
    graph = rank_graph(mesh, stacked_graph)
    params_list = [_to(p, mesh.device) for p in gnn_params_list]
    generator = torch.Generator(device=mesh.device)

    def step(base: torch.Generator, p):
        generator.manual_seed(data_seed(base.initial_seed(), mesh.data_index))
        return sandwich_eval_step(graph, params_list, cfg, generator, p, local_batch, wt=wt, qc=qc,
                                  return_overflow=return_overflow, axis=edge_axis,
                                  data_axis=mesh.data_group)

    return step


def _average_grads(leaves, loss, s_hat, ls_hat, edge_axis):
    """Average the leaves' gradients, the loss and the two rates over the
    whole grid in one flattened all-reduce, and set the leaves' ``.grad``
    to the averages: (loss, flagged_bler, bler).  The edge ranks of a data
    index hold the same values, so this is the mean over the data ranks,
    and it keeps the edge replicas bit-identical."""
    # rows sharded over the edge axis: per-sample or-reduce first
    flags = por(torch.stack([(s_hat != 0).any(dim=0), (ls_hat != 0).any(dim=0)]), edge_axis)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1), flags.to(torch.float32).mean(dim=1)])
    flat = pmean(flat, dist.group.WORLD)
    offset = 0
    for p in leaves:
        p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
        offset += p.numel()
    return flat[offset:].unbind(0)


def make_sharded_train_step(mesh: Mesh, stacked_graph, cfg, optimizer, local_batch: int):
    """The sharded train step
    (params, opt_state, noise_x [n, B], noise_z [n, B]) ->
    (params, opt_state, loss, flagged_bler, bler).

    The noise is the global batch, B = ``local_batch * mesh.data``; each
    rank takes its data index's columns.  Stage 1 runs under no_grad and
    stage 2 under autograd, both on this rank's edge shard.  The gradients,
    the loss and the two rates are then averaged over the grid
    (``_average_grads``) before ``optimizer``'s clip, as the JAX package
    clips the averaged gradients.  ``params`` (on ``mesh.device``) are
    updated in place, the same on every rank; their ``.grad`` hold the
    averaged, clipped gradients afterwards.
    """
    edge_axis = mesh.edge_group if mesh.edge > 1 else None
    graph = rank_graph(mesh, stacked_graph)
    cols = slice(mesh.data_index * local_batch, (mesh.data_index + 1) * local_batch)

    def step(params, opt_state, noise_x, noise_z):
        nx, nz = noise_x[:, cols].to(mesh.device), noise_z[:, cols].to(mesh.device)
        feats = stage_one_features(graph, cfg, nx, nz, axis=edge_axis)
        loss, (s_hat, ls_hat) = stage_two_loss(params, graph, cfg, nx, nz, *feats, axis=edge_axis)
        opt_state.zero_grad(set_to_none=True)
        loss.backward()
        leaves = [p for group in opt_state.param_groups for p in group["params"]]
        loss, flagged_bler, bler = _average_grads(leaves, loss, s_hat, ls_hat, edge_axis)
        optimizer.update(opt_state)
        return params, opt_state, loss, flagged_bler, bler

    return step
