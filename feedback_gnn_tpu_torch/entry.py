"""Entry point of the port: the flagship Monte-Carlo evaluation step.

``entry()`` mirrors ``__graft_entry__.entry()`` of the JAX package: the
[[882,24]] sandwich cascade (BP4-64 + 3 x (feedback GNN + BP4-16)) with the
shipped trained weights, every BP run on the fused QC decode.  It runs on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from . import resolve_device
from .codes import QuantumGraph, qc_pair_from_code
from .config import CODE_REGISTRY, build_code
from .decoders import CascadeConfig, load_weights, sandwich_eval_step

__all__ = ["entry", "load_code", "WEIGHTS"]

# the JAX package's shipped trained weights, read in place
WEIGHTS = {name: spec["weights"] for name, spec in CODE_REGISTRY.items()}


def load_code(name: str, device):
    """(graph on ``device``, QCPair, shipped GNN parameters) of a paper code,
    ``"n882"`` or ``"n1270"``."""
    code = build_code(name)
    graph = QuantumGraph.from_code(code, stage_mode=True).to(device)
    return graph, qc_pair_from_code(code), load_weights(WEIGHTS[name], device)


def entry(device=None):
    """Returns (fn, example_args): one Monte-Carlo evaluation step of the
    flagship cascade on the [[882,24]] code at batch 256;
    fn(generator, p) -> (flagged_count, logical_count) as 0-d tensors."""
    device = resolve_device(device)
    graph, qc, params = load_code("n882", device)
    cfg = CascadeConfig(num_iter1=64, num_iter2=16, num_rounds=3, p0=0.05)
    batch = 256

    def fn(generator, p):
        return sandwich_eval_step(graph, [params], cfg, generator, p, batch, qc=qc)

    example_args = (torch.Generator(device=device).manual_seed(0), 0.08)
    return fn, example_args
