"""Two-stage feedback-GNN training, the port of
``feedback_gnn_tpu/train/trainer.py``.

Stage 1 (frozen): BP4-64 on the mined noise, producing the marginals and
check logits, under ``torch.no_grad()`` (JAX's stop_gradient).
Stage 2 (trained): feedback GNN -> BP4-16 with per-iteration logits ->
deep-supervision BCE -> element-wise gradient clip at +-10 -> Adam(2e-4).
Both stages run the gather decoder ``bp4_decode``; ``torch.autograd``
differentiates stage 2.

Parameters are the JAX layout's dict of leaf tensors
(``decoders.gnn_feedback``); the optimizer state is a ``torch.optim.Adam``
over those leaves in the checkpoint's key order, and a step updates them
in place.  The graph is a ``QuantumGraph`` of tensors on the training
device.  ``axis`` (the edge group of an edge-sharded graph, or None) runs
both stages on one edge shard; parallel/api.py's ``make_sharded_train_step``
drives them over a grid of ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..decoders.bp4 import bp4_decode
from ..decoders.cascade import prior_llr
from ..decoders.gnn_feedback import feedback_gnn_apply
from ..decoders.graph_ops import pad_rows_to
from ..io.checkpoint import flatten_with_paths
from ..ops.gf2mat import mod2_matmul
from .loss import deep_supervision_loss

__all__ = [
    "TrainConfig", "ClipAdam", "make_optimizer", "stage_one_features", "stage_two_loss",
    "make_train_step", "make_train_step_multi",
]


@dataclass(frozen=True)
class TrainConfig:
    num_iter1: int = 64
    num_iter2: int = 16
    loss_from: int = 8
    cn_type: str = "boxplus-phi"
    factor1: float = 1.0
    factor2: float = 1.0
    p0: float = 0.05
    learning_rate: float = 2e-4
    grad_clip: float = 10.0


@dataclass(frozen=True)
class ClipAdam:
    """optax.chain(clip(grad_clip), adam(learning_rate)): each gradient
    element clipped to +-grad_clip, then Adam with optax's defaults
    (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)."""

    learning_rate: float
    grad_clip: float

    def init(self, params) -> torch.optim.Adam:
        """The optimizer state over ``params``' leaves, which it marks as
        requiring gradients."""
        leaves = [p.requires_grad_(True) for p in flatten_with_paths(params).values()]
        return torch.optim.Adam(leaves, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def update(self, opt_state: torch.optim.Adam):
        """Clip the leaves' gradients and take one Adam step in place."""
        leaves = [p for group in opt_state.param_groups for p in group["params"]]
        torch.nn.utils.clip_grad_value_(leaves, self.grad_clip)
        opt_state.step()


def make_optimizer(cfg: TrainConfig) -> ClipAdam:
    """Element-wise value clip then Adam, as in the reference loop."""
    return ClipAdam(cfg.learning_rate, cfg.grad_clip)


def _pad_noise(graph, noise):
    """[n, B] -> [n_pad, B] int32 with zero pad rows."""
    return pad_rows_to(noise.to(torch.int32), graph.n_pad)


def _syndromes(graph, noise_x, noise_z):
    return mod2_matmul(graph.hx, noise_z), mod2_matmul(graph.hz, noise_x)


@torch.no_grad()
def stage_one_features(graph, cfg: TrainConfig, noise_x, noise_z, axis=None):
    """Frozen BP4 pass of ``cfg.num_iter1`` iterations: no autograd graph.

    noise_x / noise_z: [n, B] {0,1}.  Returns (h_vn [3, n_pad, B],
    logit_hx, logit_hz), the logits by their per-Hx-row / per-Hz-row names.
    """
    noise_x, noise_z = _pad_noise(graph, noise_x), _pad_noise(graph, noise_z)
    syndrome_x, syndrome_z = _syndromes(graph, noise_x, noise_z)
    llr0 = prior_llr(cfg.p0, graph.n, noise_x.shape[-1], n_pad=graph.n_pad, device=noise_x.device)
    res = bp4_decode(graph, llr0, syndrome_x, syndrome_z, cfg.num_iter1, cfg.cn_type, cfg.factor1,
                     axis=axis)
    h_vn = torch.stack([res.llrx, res.llry, res.llrz], dim=0)
    # z_logit = per-Hx-row logits in stage mode (see cascade.py)
    return h_vn, res.z_logit, res.x_logit


def stage_two_loss(params, graph, cfg: TrainConfig, noise_x, noise_z, h_vn, logit_hx, logit_hz,
                   axis=None):
    """GNN + BP4 of ``cfg.num_iter2`` iterations + deep-supervision loss.

    Returns (loss, (s_hat, ls_hat)): the 0-d loss, and the residual
    syndromes [mz+mx, B] and logical syndromes [Rx+Rz, B] for monitoring
    (the shard's rows under edge sharding)."""
    noise_x, noise_z = _pad_noise(graph, noise_x), _pad_noise(graph, noise_z)
    syndrome_x, syndrome_z = _syndromes(graph, noise_x, noise_z)
    new_llr = feedback_gnn_apply(params, graph, h_vn, logit_hx, logit_hz, syndrome_x, syndrome_z,
                                 axis)
    res = bp4_decode(graph, new_llr, syndrome_x, syndrome_z, cfg.num_iter2, cfg.cn_type,
                     cfg.factor2, collect_logits=True, axis=axis)
    loss = deep_supervision_loss(res.logit_stack, syndrome_x, syndrome_z, cfg.num_iter2,
                                 cfg.loss_from, row_valid_x=graph.logit_rows_x.row_valid,
                                 row_valid_z=graph.logit_rows_z.row_valid, axis=axis)
    x_diff = noise_x ^ res.x_hat
    z_diff = noise_z ^ res.z_hat
    s_hat = torch.cat([mod2_matmul(graph.hz, x_diff), mod2_matmul(graph.hx, z_diff)])
    ls_hat = torch.cat([mod2_matmul(graph.hx_perp, x_diff), mod2_matmul(graph.hz_perp, z_diff)])
    return loss, (s_hat, ls_hat)


def _one_update(graph, cfg, optimizer: ClipAdam, params, opt_state, noise_x, noise_z):
    """One optimizer update: frozen stage-1 features, then the stage-2
    gradient step.  Returns (params, opt_state, loss, flagged_bler, bler)."""
    h_vn, logit_hx, logit_hz = stage_one_features(graph, cfg, noise_x, noise_z)
    loss, (s_hat, ls_hat) = stage_two_loss(params, graph, cfg, noise_x, noise_z, h_vn,
                                           logit_hx, logit_hz)
    opt_state.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.update(opt_state)
    flagged_bler = (s_hat != 0).any(dim=0).to(torch.float32).mean()
    bler = (ls_hat != 0).any(dim=0).to(torch.float32).mean()
    return params, opt_state, loss.detach(), flagged_bler, bler


def make_train_step(graph, cfg: TrainConfig, optimizer: ClipAdam):
    """Returns a train step
    (params, opt_state, noise_x [n,B], noise_z [n,B]) ->
    (params, opt_state, loss, flagged_bler, bler), 0-d tensors on the
    graph's device; ``params`` are updated in place and returned."""

    def step(params, opt_state, noise_x, noise_z):
        return _one_update(graph, cfg, optimizer, params, opt_state, noise_x, noise_z)

    return step


def make_train_step_multi(graph, cfg: TrainConfig, optimizer: ClipAdam, k: int):
    """``k`` sequential updates per call over a stacked block of minibatches:
    (params, opt_state, noise_x [k,n,B], noise_z [k,n,B]) ->
    (params, opt_state, losses [k], flagged [k], bler [k]).

    The JAX package fuses the k updates into one device program to save
    per-call dispatch latency; here it is a loop of k ``make_train_step``
    updates, kept for the ``--steps-per-call`` interface."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")

    def step(params, opt_state, noise_x, noise_z):
        outs = []
        for nx, nz in zip(noise_x, noise_z):
            params, opt_state, *rest = _one_update(graph, cfg, optimizer, params, opt_state, nx, nz)
            outs.append(rest)
        losses, fb, bl = (torch.stack(v) for v in zip(*outs))
        return params, opt_state, losses, fb, bl

    return step
