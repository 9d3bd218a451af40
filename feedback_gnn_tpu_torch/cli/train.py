"""Feedback-GNN training CLI, the counterpart of scripts/train.py:

    python -m feedback_gnn_tpu_torch.cli.train -c n882 --data-dir datasets/ --epochs 1
    python -m feedback_gnn_tpu_torch.cli.train -c n882 --mine --weights-out out.pkl

Trains on mined BP-failure datasets with the two-stage step (frozen BP-64
features -> GNN + BP-16 deep-supervision loss) and writes the weights as a
reference pickle.  ``--mine`` mines an easy set first with the gather
decoder's miner, as the JAX script does.  Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..codes import QuantumGraph
from ..config import build_code
from ..decoders.gnn_feedback import init_feedback_gnn, load_weights, save_reference_weights
from ..train import (
    TrainConfig, batch_iterator, make_bp_failure_miner, make_optimizer, make_train_step,
    mine_failures,
)
from ..train.data import shard_seed

__all__ = ["make_parser", "main"]


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--code", default="n882")
    ap.add_argument("--data-dir", default=None, help="dir with *_x_all.npy/_z_all.npy")
    ap.add_argument("--mine", action="store_true",
                    help="mine an 'easy' BP-failure dataset before training")
    ap.add_argument("--mine-weights", type=int, nargs=2, default=[4, 20],
                    metavar=("WT_FROM", "WT_TO"))
    ap.add_argument("--mine-batches", type=int, default=4)
    ap.add_argument("--mine-batch-size", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--iters1", type=int, default=64)
    ap.add_argument("--iters2", type=int, default=16)
    ap.add_argument("--loss-from", type=int, default=8)
    ap.add_argument("--weights-in", default=None)
    ap.add_argument("--weights-out", default="feedback_gnn_trained.npy")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def train(args, graph, device):
    """Mine or load the dataset, train, save; returns the parameters."""
    if args.weights_in:
        params = load_weights(args.weights_in, device)
    else:
        params = init_feedback_gnn(torch.Generator(device=device).manual_seed(shard_seed(args.seed, 0)))

    if args.mine:
        print("mining BP-failure dataset ...")
        miner = make_bp_failure_miner(graph, num_iter=args.iters1)
        shards = mine_failures(miner, shard_seed(args.seed, 1),
                               range(args.mine_weights[0], args.mine_weights[1] + 1),
                               args.mine_batches, args.mine_batch_size)
        x = np.vstack([v[0] for v in shards.values()])
        z = np.vstack([v[1] for v in shards.values()])
        print(f"mined {x.shape[0]} failure samples")
    else:
        if not args.data_dir:
            raise SystemExit("--data-dir or --mine required")
        x = np.load(os.path.join(args.data_dir, f"{args.code}_x_all.npy"))
        z = np.load(os.path.join(args.data_dir, f"{args.code}_z_all.npy"))

    tcfg = TrainConfig(num_iter1=args.iters1, num_iter2=args.iters2, loss_from=args.loss_from,
                       learning_rate=args.lr)
    opt = make_optimizer(tcfg)
    opt_state = opt.init(params)
    step = make_train_step(graph, tcfg, opt)

    it, t0 = 0, time.time()
    for epoch in range(args.epochs):
        shuffle = torch.Generator().manual_seed(shard_seed(args.seed, 100 + epoch))
        for nx, nz in batch_iterator(x, z, args.batch_size, shuffle, device=device):
            params, opt_state, loss, flagged_bler, bler = step(params, opt_state, nx, nz)
            it += 1
            if it % args.log_every == 0:
                print(f"it {it}: loss {float(loss):.4f} bler {float(bler):.4f} "
                      f"flagged {float(flagged_bler):.4f} "
                      f"({it * args.batch_size / (time.time() - t0):.0f} samples/s)")

    save_reference_weights(params, args.weights_out)
    print(f"saved weights to {args.weights_out}")
    return params


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    print(f"building code {args.code} ...")
    graph = QuantumGraph.from_code(build_code(args.code), stage_mode=True).to(device)
    return train(args, graph, device)


if __name__ == "__main__":
    main()
