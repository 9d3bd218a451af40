"""Rank programs for ``launch``: the sharded paths driven on a joined
process group, returning NumPy results to the parent.  They serve the
multi-device checks (the CPU tests and chip_smoke.py's phase ``parallel``)
and cli/bench_scaling.py; they live in the package so that a spawned rank
imports nothing else.

``run_tasks(tasks, device)`` runs ``[(name, kwargs), ...]`` in order on
every rank (each task builds its own grid with ``make_mesh``, a collective
call, so every rank must run the same list) and returns each task's
result: one launch checks many layouts.  Graphs and codes arrive as host
objects (``QuantumGraph``, ``QCPair``), parameters as NumPy trees or a
weight path.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..decoders.bp2 import bp2_decode
from ..decoders.bp4 import bp4_decode
from ..decoders.cascade import prior_llr, sandwich_decode
from ..decoders.gnn_feedback import load_weights, params_from_numpy
from ..decoders.gnn_full import gnn_bp4_apply, make_logit_rowsets
from ..io.checkpoint import flatten_with_paths
from ..ops.gf2mat import mod2_matmul
from ..train.trainer import ClipAdam, stage_two_loss
from .api import _average_grads, make_sharded_eval_step, make_sharded_train_step, rank_graph
from .mesh import make_mesh
from .shard import shard_bounds, shard_quantum_graph, unstack_shard

__all__ = ["run_tasks", "TASKS"]


def _params(params, device):
    if isinstance(params, str):
        return load_weights(params, device)
    return params_from_numpy(params, device)


def _np(t):
    return t.detach().cpu().numpy()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_counts(mesh_shape, graph, params, cfg, local_batch, seeds, p, qc=None,
                return_overflow=False, warmup=0, device=None):
    """Counts of ``make_sharded_eval_step`` for each batch seed in ``seeds``
    (the base generator seeded so; rank r draws from ``data_seed``), with
    the seconds of those steps after ``warmup`` untimed ones, this rank's
    K1 launches in the counted steps, its peak device memory, and the
    backend that carried them."""
    mesh = make_mesh(*mesh_shape, device=device)
    step = make_sharded_eval_step(mesh, shard_quantum_graph(graph, mesh.edge),
                                  [_params(params, mesh.device)], cfg, local_batch, qc=qc,
                                  return_overflow=return_overflow)
    base = torch.Generator(device=mesh.device)
    for i in range(warmup):
        step(base.manual_seed(10**9 + i), p)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    _sync(mesh.device)
    torch.distributed.barrier()
    launches0 = obs.counter("k1.launches")
    t0 = time.perf_counter()
    counts = [tuple(int(c) for c in step(base.manual_seed(s), p)) for s in seeds]
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda" else None
    return {"counts": counts, "seconds": seconds, "k1_launches": obs.counter("k1.launches") - launches0,
            "backend": mesh.backend, "data_index": mesh.data_index, "peak_bytes": peak}


def decode(edge, graph, params, cfg, noise_x, noise_z, device=None):
    """Hard decisions {"x_hat", "z_hat"} (uint8 [n, B]) of the cascade on
    one edge shard, on the injected noise [n, B], its seconds and
    backend."""
    mesh = make_mesh(1, edge, device=device)
    g = rank_graph(mesh, shard_quantum_graph(graph, edge))
    nx = torch.nn.functional.pad(torch.as_tensor(noise_x, dtype=torch.int32, device=mesh.device),
                                 (0, 0, 0, g.n_pad - g.n))
    nz = torch.nn.functional.pad(torch.as_tensor(noise_z, dtype=torch.int32, device=mesh.device),
                                 (0, 0, 0, g.n_pad - g.n))
    sx, sz = mod2_matmul(g.hx, nz), mod2_matmul(g.hz, nx)
    llr0 = prior_llr(cfg.p0, g.n, nx.shape[1], n_pad=g.n_pad, device=mesh.device)
    params = [_params(params, mesh.device)]
    _sync(mesh.device)
    t0 = time.perf_counter()
    x_hat, z_hat = sandwich_decode(g, params, cfg, llr0, sx, sz, sz, sx, axis=mesh.edge_group)
    _sync(mesh.device)
    return {"x_hat": _np(x_hat[: g.n].to(torch.uint8)), "z_hat": _np(z_hat[: g.n].to(torch.uint8)),
            "seconds": time.perf_counter() - t0, "backend": mesh.backend}


def _shard_rows(a, bounds, rows):
    """Rows [start, end) of ``a`` zero-padded to ``rows``."""
    out = np.zeros((rows,) + a.shape[1:], np.float32)
    out[: bounds[1] - bounds[0]] = a[bounds[0]:bounds[1]]
    return out


def bp4(edge, graph, llr0, syndrome_x, syndrome_z, num_iter, device=None):
    """``bp4_decode`` on one edge shard: (llrx [n_pad, B], x_hat, z_hat)."""
    mesh = make_mesh(1, edge, device=device)
    stacked = shard_quantum_graph(graph, edge)
    g = rank_graph(mesh, stacked)
    i = mesh.edge_index
    sx = _shard_rows(syndrome_x, shard_bounds(graph.gx.num_cn, edge)[i], g.gx.c_pad)
    sz = _shard_rows(syndrome_z, shard_bounds(graph.gz.num_cn, edge)[i], g.gz.c_pad)
    res = bp4_decode(g, torch.as_tensor(llr0, device=mesh.device), torch.as_tensor(sx, device=mesh.device),
                     torch.as_tensor(sz, device=mesh.device), num_iter, axis=mesh.edge_group)
    return _np(res.llrx), _np(res.x_hat), _np(res.z_hat)


def bp2(edge, graph, llr, syndrome, num_iter, cn_type, device=None):
    """``bp2_decode`` on the Hx side of one edge shard: (logits, hard)."""
    mesh = make_mesh(1, edge, device=device)
    g = unstack_shard(shard_quantum_graph(graph, edge), mesh.edge_index).gx.to(mesh.device)
    syn = _shard_rows(syndrome, shard_bounds(graph.gx.num_cn, edge)[mesh.edge_index], g.c_pad)
    res = bp2_decode(g, torch.as_tensor(llr, device=mesh.device), torch.as_tensor(syn, device=mesh.device),
                     num_iter, cn_type, axis=mesh.edge_group)
    return _np(res.logits), _np(res.hard)


def stage_two_grads(edge, graph, params, cfg, noise_x, noise_z, h_vn, logit_hx, logit_hz, device=None):
    """Loss and {path: gradient} of ``stage_two_loss`` on one edge shard,
    fed fixed stage-1 features (``logit_hx``/``logit_hz`` the global rows,
    split here as the decoder's CN blocks)."""
    mesh = make_mesh(1, edge, device=device)
    g = rank_graph(mesh, shard_quantum_graph(graph, edge))
    i = mesh.edge_index
    lhx = _shard_rows(logit_hx, shard_bounds(graph.gx.num_cn, edge)[i], g.gx.c_pad)
    lhz = _shard_rows(logit_hz, shard_bounds(graph.gz.num_cn, edge)[i], g.gz.c_pad)
    tparams = _params(params, mesh.device)
    for leaf in flatten_with_paths(tparams).values():
        leaf.requires_grad_(True)
    dev = mesh.device
    loss, _ = stage_two_loss(tparams, g, cfg, *(torch.as_tensor(a, device=dev)
                                                 for a in (noise_x, noise_z, h_vn, lhx, lhz)),
                             axis=mesh.edge_group)
    loss.backward()
    return loss.item(), {k: _np(v.grad) for k, v in flatten_with_paths(tparams).items()}


def dp_stage_two_grads(data, graph, params, cfg, noise_x, noise_z, features, device=None):
    """Stage 2 of the data-parallel train step (``data`` ranks, edge 1) on
    shared stage-1 features of the global batch (h_vn [3, n_pad, B],
    logit_hx, logit_hz): each rank takes its columns of the noise and the
    features, and the gradients, loss and rates are averaged as
    ``make_sharded_train_step`` averages them.  Returns (loss,
    flagged_bler, bler), the averaged gradients and the backend: the
    gradient of stage 2 alone, as the single-process step computes it on
    the same features."""
    mesh = make_mesh(data, 1, device=device)
    g = rank_graph(mesh, shard_quantum_graph(graph, 1))
    b = noise_x.shape[1] // data
    cols = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    tparams = _params(params, mesh.device)
    leaves = list(flatten_with_paths(tparams).values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    nx, nz, *feats = (torch.as_tensor(a)[..., cols].to(mesh.device)
                      for a in (noise_x, noise_z, *features))
    loss, (s_hat, ls_hat) = stage_two_loss(tparams, g, cfg, nx, nz, *feats)
    loss.backward()
    rates = tuple(float(v) for v in _average_grads(leaves, loss, s_hat, ls_hat, None))
    return {"rates": [rates], "grads": {k: _np(v.grad) for k, v in flatten_with_paths(tparams).items()},
            "backend": mesh.backend}


def train_step(mesh_shape, graph, params, cfg, noise_x, noise_z, learning_rate=0.0, grad_clip=1e30, steps=1,
               device=None):
    """``steps`` calls of ``make_sharded_train_step`` on the global noise
    (one ``ClipAdam``): per step (loss, flagged_bler, bler), the last
    step's averaged gradients and the parameters after it.  The default
    optimizer leaves the parameters and the gradients as they are."""
    mesh = make_mesh(*mesh_shape, device=device)
    b = noise_x.shape[1]
    opt = ClipAdam(learning_rate, grad_clip)
    step = make_sharded_train_step(mesh, shard_quantum_graph(graph, mesh.edge), cfg, opt,
                                   b // mesh.data)
    tparams = _params(params, mesh.device)
    state = opt.init(tparams)
    nx, nz = torch.as_tensor(noise_x), torch.as_tensor(noise_z)
    rates = []
    for _ in range(steps):
        _, _, loss, fb, bl = step(tparams, state, nx, nz)
        rates.append((float(loss), float(fb), float(bl)))
    flat = flatten_with_paths(tparams)
    return {"rates": rates, "grads": {k: _np(v.grad) for k, v in flat.items()},
            "params": {k: _np(v) for k, v in flat.items()}, "backend": mesh.backend}


def gnn_bp4(edge, graph, params, cfg, syndrome_x, syndrome_z, device=None):
    """GNN_BP4's forward on one edge shard: (x_hat, z_hat) [n_pad, B]."""
    mesh = make_mesh(1, edge, device=device)
    host = unstack_shard(shard_quantum_graph(graph, edge), mesh.edge_index)
    g = host.to(mesh.device)
    rows = make_logit_rowsets(host, mesh.device)
    i = mesh.edge_index
    sx = _shard_rows(syndrome_x, shard_bounds(graph.gx.num_cn, edge)[i], g.gx.c_pad)
    sz = _shard_rows(syndrome_z, shard_bounds(graph.gz.num_cn, edge)[i], g.gz.c_pad)
    x_hat, z_hat, _ = gnn_bp4_apply(params_from_numpy(params, mesh.device), g, rows,
                                    torch.as_tensor(sx, device=mesh.device),
                                    torch.as_tensor(sz, device=mesh.device), cfg, axis=mesh.edge_group)
    return _np(x_hat), _np(z_hat)


TASKS = {f.__name__: f for f in (eval_counts, decode, bp4, bp2, stage_two_grads, dp_stage_two_grads,
                                  train_step, gnn_bp4)}


def run_tasks(tasks, device=None):
    """Each task's result, in order: ``tasks`` is [(name, kwargs), ...]
    with names from ``TASKS``."""
    return [TASKS[name](**kwargs, device=device) for name, kwargs in tasks]
