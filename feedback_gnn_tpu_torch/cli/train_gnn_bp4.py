"""Train and evaluate the fully-learned GNN decoder (GNN_BP4) end to end,
the counterpart of scripts/train_gnn_bp4.py:

    python -m feedback_gnn_tpu_torch.cli.train_gnn_bp4 --code gb48 --steps 2000 \\
        --eval-p 0.02 0.03 0.04 --out runs/gnn_bp4_gb48.json

Trains on i.i.d. depolarizing noise of strength ``--train-p`` (the
deep-supervision BCE of ``gnn_bp4_loss``, each gradient element clipped to
+-10, then Adam), then sweeps the depolarizing channel and records the
LER of the initialisation and of the trained weights.  Each train step's
generator is seeded from ``SeedSequence([seed, 1000 + step])`` and each
evaluation batch's from ``[seed, 5000 + batch, int(p * 1e4)]``, the
structure of the JAX script's key folds (the streams differ).  Runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..channels.pauli import depolarizing_probs, pauli_iid
from ..codes import QuantumGraph, create_generalized_bicycle_codes, create_surface_codes, ghp_882_24
from ..decoders.gnn_full import GNNBP4Config, gnn_bp4_loss, init_gnn_bp4, make_logit_rowsets
from ..io.checkpoint import save_pytree
from ..models import gnn_bp4_eval_step
from ..train.trainer import ClipAdam

__all__ = ["make_parser", "build_code", "seed_of", "train_step", "sweep", "main"]

CODES = {
    "gb48": lambda: create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]),
    "surface3": lambda: create_surface_codes(3),
    "n882": ghp_882_24,
}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train and evaluate GNN_BP4 (PyTorch/CUDA).")
    ap.add_argument("--code", default="gb48", choices=["gb48", "surface3", "n882"])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=120)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train-p", type=float, default=0.05,
                    help="iid depolarizing rate for training noise")
    ap.add_argument("--num-iter", type=int, default=8)
    ap.add_argument("--embed-dims", type=int, default=20)
    ap.add_argument("--eval-p", type=float, nargs="+",
                    default=[0.01, 0.02, 0.03, 0.04, 0.05])
    ap.add_argument("--eval-batches", type=int, default=20)
    ap.add_argument("--eval-batch-size", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/gnn_bp4_eval.json")
    ap.add_argument("--weights-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    return ap


def build_code(name: str):
    return CODES[name]()


def seed_of(*words: int) -> int:
    """A generator seed: a 64-bit word of ``SeedSequence(words)``."""
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])


def train_step(opt: ClipAdam, state, params, graph, lrowsets, cfg, noise_x, noise_z):
    """One update in place: the loss on noise [n, B], its gradients, clip
    and Adam.  Returns the loss, detached."""
    loss = gnn_bp4_loss(params, graph, lrowsets, cfg, noise_x.to(torch.float32), noise_z.to(torch.float32))
    state.zero_grad(set_to_none=True)
    loss.backward()
    opt.update(state)
    return loss.detach()


def sweep(graph, lrowsets, params, cfg, args, tag, device):
    """{p: {flagged, logical, blocks, ler}} over ``args.eval_p``, printing a
    line a point."""
    out = {}
    for p in args.eval_p:
        counts = []
        for b in range(args.eval_batches):
            gen = torch.Generator(device=device).manual_seed(seed_of(args.seed, 5000 + b, int(p * 1e4)))
            counts.append(torch.stack(gnn_bp4_eval_step(graph, lrowsets, params, cfg, gen, p,
                                                        args.eval_batch_size)))
        f, lg = (int(v) for v in torch.stack(counts).sum(dim=0))
        blocks = args.eval_batches * args.eval_batch_size
        out[p] = {"flagged": f, "logical": lg, "blocks": blocks, "ler": lg / blocks}
        print(f"{tag} p={p}: LER {lg / blocks:.4g} ({lg}/{blocks}, flagged {f})", flush=True)
    return out


def main(argv=None):
    """Train, evaluate, write the JSON (and the weights); returns
    (results, the per-step losses as floats, the trained parameters)."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    code = build_code(args.code)
    host_graph = QuantumGraph.from_code(code, stage_mode=True)
    graph = host_graph.to(device)
    lrowsets = make_logit_rowsets(host_graph, device)
    cfg = GNNBP4Config(num_embed_dims=args.embed_dims, num_msg_dims=args.embed_dims,
                       num_iter=args.num_iter)
    params0 = init_gnn_bp4(torch.Generator(device=device).manual_seed(seed_of(args.seed, 0)), cfg, graph)
    params = copy.deepcopy(params0)

    opt = ClipAdam(args.lr, 10.0)
    state = opt.init(params)
    px, py, pz = depolarizing_probs(args.train_p)
    losses = []
    t0 = time.time()
    for it in range(args.steps):
        gen = torch.Generator(device=device).manual_seed(seed_of(args.seed, 1000 + it))
        nx, nz = pauli_iid(gen, px, py, pz, graph.n, args.batch_size)
        losses.append(train_step(opt, state, params, graph, lrowsets, cfg, nx, nz))
        if it % 200 == 0 or it == args.steps - 1:
            print(f"it {it}: loss {float(losses[-1]):.4f} "
                  f"({(it + 1) * args.batch_size / (time.time() - t0):.0f} samples/s)", flush=True)
    losses = torch.stack(losses).tolist() if losses else []

    with torch.no_grad():
        results = {
            "code": args.code, "cfg": cfg._asdict(), "steps": args.steps, "train_p": args.train_p,
            "init": sweep(graph, lrowsets, params0, cfg, args, "init   ", device),
            "trained": sweep(graph, lrowsets, params, cfg, args, "trained", device),
        }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    if args.weights_out:
        save_pytree(params, args.weights_out)
        print(f"saved weights to {args.weights_out}")
    return results, losses, params


if __name__ == "__main__":
    main()
