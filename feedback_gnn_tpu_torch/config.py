"""Configuration layer: the evaluation config and its command line, as
``feedback_gnn_tpu/config.py`` defines them (code spec, decoder schedule,
cascade depth, batch layout, p-sweep and stopping targets), plus the
device.

The shipped trained weights are the npz files of the JAX package, read in
place by path.  The sharded layouts (``--data-shards``/``--edge-shards`` > 1,
``--multihost``) are parsed but not ported: ``check_unported`` raises for
them.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field

from . import REPO_ROOT
from .decoders.cascade import CascadeConfig

__all__ = ["EvalConfig", "CODE_REGISTRY", "build_code", "make_eval_parser", "config_from_args",
           "check_unported"]

_WEIGHTS_DIR = os.path.join(REPO_ROOT, "feedback_gnn_tpu", "weights")


def _weight_path(stem: str) -> str:
    return os.path.join(_WEIGHTS_DIR, stem + ".npz")


# name -> code constructor, weight file of the shipped trained GNN, default nG
CODE_REGISTRY = {
    "n882": {
        "constructor": "ghp_882_24",
        "weights": _weight_path("feedback_GNN_n882_k24_wt_4_60_iter_64_16_mixed"),
        "coarse_weights": _weight_path("feedback_GNN_n882_k24_wt_4_40_iter_16_16"),
        "nG": 5,
    },
    "n1270": {
        "constructor": "ghp_1270_28",
        "weights": _weight_path("feedback_GNN_n1270_k28_wt_10_80_iter_64_16_mixed"),
        "coarse_weights": _weight_path("feedback_GNN_n1270_k28_wt_10_60_iter_16_16"),
        "nG": 5,
    },
}


def build_code(name: str):
    from . import codes

    return getattr(codes, CODE_REGISTRY[name]["constructor"])()


@dataclass
class EvalConfig:
    code: str = "n882"
    ps: list = field(default_factory=lambda: [0.05])
    batch_size: int = 5000
    max_mc_iter: int = 100000
    num_target_block_errors: int = 100
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
    weights: str | None = None  # None -> registry default
    seed: int = 0
    checkpoint: str | None = None  # MC-state resume file
    data_shards: int = 1  # not ported beyond 1 (ROADMAP A7)
    edge_shards: int = 1
    qc_kernel: bool = False  # fused QC BP backend (the CUDA kernel on the card)
    multihost: bool = False  # not ported (ROADMAP A7)
    device: str | None = None  # None -> the card

    def resolve_weights(self) -> str:
        return self.weights or CODE_REGISTRY[self.code]["weights"]


def check_unported(cfg: EvalConfig):
    """Raise for the layouts the port does not run yet."""
    if cfg.data_shards * cfg.edge_shards > 1 or cfg.multihost:
        raise NotImplementedError(
            "sharded and multi-host evaluation (--data-shards/--edge-shards > 1, "
            "--multihost) is not ported yet: ROADMAP A7")


def make_eval_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Monte-Carlo logical-error-rate evaluation of the "
        "feedback-GNN cascade (PyTorch/CUDA)."
    )
    ap.add_argument("-c", "--code", default="n882", choices=list(CODE_REGISTRY))
    ap.add_argument("-p", "--p", type=float, nargs="+", default=[0.05],
                    help="physical error rate(s) to simulate")
    ap.add_argument("-nG", "--num-rounds", type=int, default=None,
                    help="number of GNN+BP rounds (default per code)")
    ap.add_argument("-bs", "--batch-size", type=int, default=5000)
    ap.add_argument("--max-mc-iter", type=int, default=100000)
    ap.add_argument("--target-errors", type=int, default=100)
    ap.add_argument("--iters1", type=int, default=64)
    ap.add_argument("--iters2", type=int, default=16)
    ap.add_argument("--factor1", type=float, default=1.0)
    ap.add_argument("--factor2", type=float, default=1.0)
    ap.add_argument("--cn-type", default="boxplus-phi",
                    choices=["boxplus-phi", "boxplus", "minsum"])
    ap.add_argument("--p0", type=float, default=0.05)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="MC-state JSON for interrupt/resume")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="not ported beyond 1 (ROADMAP A7)")
    ap.add_argument("--edge-shards", type=int, default=1,
                    help="not ported beyond 1 (ROADMAP A7)")
    ap.add_argument("--multihost", action="store_true",
                    help="not ported (ROADMAP A7)")
    ap.add_argument("--qc-kernel", action="store_true",
                    help="use the fused quasi-cyclic BP decode (the CUDA kernel on the "
                    "card; block-circulant codes)")
    ap.add_argument("--compact", type=float, default=None, metavar="FRAC",
                    help="flagged-sample compaction capacity as a fraction "
                    "of the batch (see CascadeConfig.compact_fraction)")
    ap.add_argument("--prepass", type=int, default=None,
                    help="adaptive stage-1 prepass iterations "
                    "(see CascadeConfig.stage1_prepass; requires --compact)")
    ap.add_argument("--rounds-cap", type=float, default=None, metavar="FRAC",
                    help="second-level compaction for the GNN rounds "
                    "(see CascadeConfig.round_fraction)")
    ap.add_argument("--rescue-phi", default=None, metavar="IMPL[,IMPL...]",
                    help="formulation-ensemble rescue: re-decode samples "
                    "still flagged after the cascade with these phi "
                    "formulations (expm1|tf|accurate, comma-chained) and "
                    "adopt syndrome-consistent rescues "
                    "(see CascadeConfig.rescue_phi)")
    ap.add_argument("--rescue-cap", type=float, default=0.02, metavar="FRAC",
                    help="rescue sub-batch capacity as a fraction of the "
                    "batch (see CascadeConfig.rescue_fraction)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; 'cpu' runs the "
                    "kernels' plain versions)")
    return ap


def config_from_args(args) -> EvalConfig:
    nG = args.num_rounds if args.num_rounds is not None else CODE_REGISTRY[args.code]["nG"]
    return EvalConfig(
        code=args.code,
        ps=list(args.p),
        batch_size=args.batch_size,
        max_mc_iter=args.max_mc_iter,
        num_target_block_errors=args.target_errors,
        cascade=CascadeConfig(
            num_iter1=args.iters1,
            num_iter2=args.iters2,
            factor1=args.factor1,
            factor2=args.factor2,
            cn_type=args.cn_type,
            num_rounds=nG,
            p0=args.p0,
            compact_fraction=args.compact,
            stage1_prepass=args.prepass,
            round_fraction=args.rounds_cap,
            rescue_phi=args.rescue_phi,
            rescue_fraction=args.rescue_cap,
        ),
        weights=args.weights,
        seed=args.seed,
        checkpoint=args.checkpoint,
        data_shards=args.data_shards,
        edge_shards=args.edge_shards,
        qc_kernel=args.qc_kernel,
        multihost=args.multihost,
        device=args.device,
    )
