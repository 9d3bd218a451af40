"""Failure-mining dataset generation, the counterpart of
examples/generate_dataset.py.

Easy set: fixed-weight Pauli errors that plain BP-64 fails to decode, per
weight of a window.  Hard set (with a trained coarse GNN): errors that
survive BP64 -> GNN -> BP64.  Once both exist in --out, the final training
set mixes easy + oversampled hard examples.

    python -m feedback_gnn_tpu_torch.cli.generate_dataset -c n882 --wt 4 20 --out datasets/
    python -m feedback_gnn_tpu_torch.cli.generate_dataset -c n882 --hard --coarse-weights <file>

The miners run the gather decoder, as the JAX example's do.  Runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import resolve_device
from ..codes import QuantumGraph
from ..config import build_code
from ..decoders.gnn_feedback import load_weights
from ..train.data import make_bp_failure_miner, make_cascade_failure_miner, mine_failures, mix_easy_hard

__all__ = ["make_parser", "generate", "main"]


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--code", default="n882")
    ap.add_argument("--wt", type=int, nargs=2, default=[4, 20], metavar=("FROM", "TO"),
                    help="error-weight window")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("-bs", "--batch-size", type=int, default=5000)
    ap.add_argument("--out", default="datasets")
    ap.add_argument("--hard", action="store_true",
                    help="mine cascade survivors (needs --coarse-weights)")
    ap.add_argument("--coarse-weights", default=None)
    ap.add_argument("--oversample", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def generate(args, graph, device):
    """Mine the easy or hard shards into ``args.out``; mix them when both exist."""
    os.makedirs(args.out, exist_ok=True)
    if args.hard:
        if not args.coarse_weights:
            raise SystemExit("--hard requires --coarse-weights")
        miner = make_cascade_failure_miner(graph, load_weights(args.coarse_weights, device))
        prefix = f"{args.code}_hard"
    else:
        miner = make_bp_failure_miner(graph)
        prefix = f"{args.code}_easy"

    weights = list(range(args.wt[0], args.wt[1] + 1, 2))
    shards = mine_failures(miner, args.seed, weights, args.batches, args.batch_size,
                           out_dir=args.out, prefix=prefix)
    x = np.vstack([shards[w][0] for w in weights])
    z = np.vstack([shards[w][1] for w in weights])
    np.save(os.path.join(args.out, f"{prefix}_x_all.npy"), x)
    np.save(os.path.join(args.out, f"{prefix}_z_all.npy"), z)
    print(f"mined {x.shape[0]} failures -> {args.out}/{prefix}_*")

    easy_x = os.path.join(args.out, f"{args.code}_easy_x_all.npy")
    hard_x = os.path.join(args.out, f"{args.code}_hard_x_all.npy")
    if os.path.exists(easy_x) and os.path.exists(hard_x):
        ex, ez = np.load(easy_x), np.load(easy_x.replace("_x_", "_z_"))
        hx, hz = np.load(hard_x), np.load(hard_x.replace("_x_", "_z_"))
        mx, mz = mix_easy_hard((ex, ez), (hx, hz), hard_oversample=args.oversample)
        np.save(os.path.join(args.out, f"{args.code}_x_all.npy"), mx)
        np.save(os.path.join(args.out, f"{args.code}_z_all.npy"), mz)
        print(f"mixed dataset: {mx.shape[0]} samples (hard x{args.oversample})")
    return shards


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    graph = QuantumGraph.from_code(build_code(args.code), stage_mode=True).to(device)
    return generate(args, graph, device)


if __name__ == "__main__":
    main()
