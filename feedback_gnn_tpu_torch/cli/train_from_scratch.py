"""The from-scratch training curriculum, the counterpart of
scripts/train_from_scratch.py:

  1. mine "easy" BP4-64 failures at fixed weights wt = lo..hi (step 2);
  2. train a COARSE feedback GNN (16/16 schedule) on the easy set
     restricted to wt <= coarse_hi;
  3. mine "hard" failures that survive BP64 -> coarse GNN -> BP64;
  4. train the FINAL model (64/16) on easy + hard x 50 oversampling;
  5. evaluate the trained cascade (nG=3) beside the SHIPPED weights at the
     same p points and seeds.

    python -m feedback_gnn_tpu_torch.cli.train_from_scratch -c n882 --out-dir runs/scratch

Every phase writes its artifact under --out-dir and is skipped when the
artifact exists, so an interrupted run resumes.  The miners run on the
fused QC decode (``--mine-qc``, the default: K1 on the card).  Runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..codes import QuantumGraph, qc_pair_from_code
from ..config import CODE_REGISTRY, build_code
from ..decoders import CascadeConfig, sandwich_eval_step
from ..decoders.gnn_feedback import init_feedback_gnn, load_weights
from ..io.checkpoint import load_pytree, save_pytree
from ..sim import sim_ler
from ..train import (
    TrainConfig, batch_iterator, batch_iterator_stacked, make_bp_failure_miner,
    make_cascade_failure_miner, make_optimizer, make_train_step, make_train_step_multi,
    mix_easy_hard,
)
from ..train.data import shard_seed

__all__ = ["make_parser", "mine_phase", "train_phase", "evaluate", "curriculum", "main"]

# the seed words of the phases (the JAX script folds the same numbers into its key)
EASY, COARSE, HARD, FINAL = 1, 2, 3, 4


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def mine_phase(miner, seed, weights, batches, batch_size, cap, tag, out_dir, ahead=8):
    """Mine failures per weight up to ``cap`` kept each; save one npz.

    The miner must be built with ``compact_cap``: each call returns
    (nx [n,K] uint8, nz, kept) on the device.  ``ahead`` batches are queued
    on the device before the first ``kept`` is read (the only sync), so the
    host's copy of one batch overlaps the device's work on the next; the
    kept-cap early stop lags by up to ``ahead`` batches (a slight over-scan,
    never under-collection).  Batch b of weight wt draws from a generator
    seeded with ``shard_seed(seed, wt, b)``."""
    path = os.path.join(out_dir, f"{tag}.npz")
    if os.path.exists(path):
        with np.load(path) as d:
            log(f"{tag}: reusing {path} ({d['x'].shape[0]} samples)")
            return d["x"], d["z"]
    generator = torch.Generator(device=miner.device)
    xs, zs, report = [], [], {}
    t0 = time.time()
    for wt in weights:
        kept_x, kept_z, pending = [], [], []
        scanned = total_kept = 0

        def drain():
            nonlocal total_kept
            nx, nz, kept = pending.pop(0)
            kept = int(kept)  # the sync point
            kept_x.append(nx[:, :kept].cpu().numpy().T)
            kept_z.append(nz[:, :kept].cpu().numpy().T)
            total_kept += kept

        for b in range(batches):
            generator.manual_seed(shard_seed(seed, wt, b))
            pending.append(miner(generator, wt, int(batch_size)))
            scanned += batch_size
            if len(pending) >= ahead:
                drain()
            if total_kept >= cap:
                break
        while pending:
            drain()
        x = np.vstack(kept_x)[:cap].astype(np.uint8)
        z = np.vstack(kept_z)[:cap].astype(np.uint8)
        xs.append(x)
        zs.append(z)
        report[int(wt)] = x.shape[0]
        log(f"{tag}: wt={wt} kept {x.shape[0]} failures "
            f"({scanned} scanned, {scanned / max(time.time() - t0, 1e-9):.0f}/s)")
        t0 = time.time()
    x, z = np.vstack(xs), np.vstack(zs)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, x=x, z=z, weights=np.asarray(list(report)),
                        kept=np.asarray(list(report.values())))
    os.replace(tmp, path)
    log(f"{tag}: {x.shape[0]} samples -> {path}")
    return x, z


def train_phase(graph, x, z, tcfg, seed, batch_size, tag, out_dir, init_params=None,
                log_every=200, epochs=1, steps_per_call=1):
    """Train from ``init_params`` (else a fresh init seeded by ``seed``) over
    ``epochs`` shuffled epochs; save the parameters as a checkpoint, or
    load them when it exists."""
    device = graph.hx.device
    params = init_params if init_params is not None else init_feedback_gnn(
        torch.Generator(device=device).manual_seed(shard_seed(seed, 0)))
    path = os.path.join(out_dir, f"{tag}.npz")
    if os.path.exists(path):
        log(f"{tag}: reusing {path}")
        return load_pytree(path, like=params)

    opt = make_optimizer(tcfg)
    opt_state = opt.init(params)
    k = max(1, int(steps_per_call))
    step = make_train_step(graph, tcfg, opt) if k == 1 else make_train_step_multi(graph, tcfg, opt, k)
    it, t0, losses = 0, time.time(), []

    def report(ls, fbs, bls, j, ep):
        nonlocal it
        prev = it
        it += j
        losses.extend(ls.reshape(-1).tolist())
        if it // log_every != prev // log_every or prev == 0:
            log(f"{tag}: ep {ep + 1}/{epochs} it {it} loss {losses[-1]:.4f} "
                f"bler {float(bls.reshape(-1)[-1]):.3f} flagged {float(fbs.reshape(-1)[-1]):.3f} "
                f"({it * batch_size / (time.time() - t0):.0f} samples/s)")

    single = None
    for ep in range(epochs):
        shuffle = torch.Generator().manual_seed(shard_seed(seed, 7 + ep))
        if k == 1:
            for nx, nz in batch_iterator(x, z, batch_size, shuffle, device=device):
                params, opt_state, loss, fb, bl = step(params, opt_state, nx, nz)
                report(loss, fb, bl, 1, ep)
            continue
        for nx, nz in batch_iterator_stacked(x, z, batch_size, shuffle, k, device=device):
            if nx.shape[0] == k:
                params, opt_state, ls, fbs, bls = step(params, opt_state, nx, nz)
                report(ls, fbs, bls, k, ep)
            else:
                # the epoch's remainder (< k minibatches) runs one step at a time
                single = single or make_train_step(graph, tcfg, opt)
                for j in range(nx.shape[0]):
                    params, opt_state, loss, fb, bl = single(params, opt_state, nx[j], nz[j])
                    report(loss, fb, bl, 1, ep)
    save_pytree(params, path)
    log(f"{tag}: trained {it} steps ({epochs} epochs), "
        f"final loss {np.mean(losses[-50:]) if losses else float('nan'):.4f} -> {path}")
    return params


def evaluate(graph, qc, params_list, ps, batch, seed, target, tag, max_mc_iter=100000):
    """The cascade's LER (nG=3, BP4-64 + 3 x (GNN + BP4-16)) by ``sim_ler``."""
    cfg = CascadeConfig(num_iter1=64, num_iter2=16, num_rounds=3, p0=0.05)

    def step(generator, p):
        return sandwich_eval_step(graph, params_list, cfg, generator, p, batch, qc=qc)

    log(f"eval {tag}: nG=3 at p={ps}")
    res = sim_ler(step, ps, batch_size=batch, max_mc_iter=max_mc_iter,
                  num_target_block_errors=target, seed=seed, verbose=True,
                  device=graph.hx.device)
    print()
    print(res.summary(), flush=True)
    return res


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--code", default="n882", choices=sorted(CODE_REGISTRY))
    ap.add_argument("--out-dir", default="runs/scratch")
    ap.add_argument("--wt", type=int, nargs=2, default=[4, 60])
    ap.add_argument("--coarse-hi", type=int, default=40)
    ap.add_argument("--mine-batches", type=int, default=60,
                    help="mining batches per weight (x batch-size = samples scanned per wt; "
                    "the reference scans 50 x 50000)")
    ap.add_argument("--mine-batch-size", type=int, default=8192)
    ap.add_argument("--hard-mine-batches", type=int, default=None,
                    help="mining batches per weight for the HARD phase (default: --mine-batches)")
    ap.add_argument("--hard-mine-batch-size", type=int, default=None,
                    help="batch size for the HARD phase (default: --mine-batch-size)")
    ap.add_argument("--mine-compact-cap", type=int, default=2048,
                    help="device-side failure-compaction width per batch")
    ap.add_argument("--easy-cap", type=int, default=12000, help="kept failures per wt")
    ap.add_argument("--hard-cap", type=int, default=3000)
    ap.add_argument("--hard-oversample", type=int, default=50)
    ap.add_argument("--coarse-epochs", type=int, default=4,
                    help="epochs over the easy wt<=coarse-hi set for the coarse 16/16 stage")
    ap.add_argument("--final-epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="optimizer steps per train-step call (a loop of single steps)")
    ap.add_argument("--mine-ahead", type=int, default=8,
                    help="mining batches queued on the device before the first result is read")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--eval-p", type=float, nargs="+", default=[0.10, 0.09])
    ap.add_argument("--eval-batch", type=int, default=20480)
    ap.add_argument("--eval-target-errors", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-shipped-eval", action="store_true")
    ap.add_argument("--mine-qc", action=argparse.BooleanOptionalAction, default=True,
                    help="run the miners' BP on the fused QC decode (K1 on the card)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def _ler_dict(res):
    return {"ps": [float(v) for v in res.ps], "ler": [float(v) for v in res.ler],
            "errors": [int(v) for v in res.logical_errors], "blocks": [int(v) for v in res.num_blocks],
            "overflow": [int(v) for v in res.overflow]}


def curriculum(args, graph, qc, shipped=None):
    """Phases 1-5 on ``graph`` (a QuantumGraph on the training device) with
    ``qc`` its QCPair; ``shipped`` the weights evaluated beside the trained
    ones (None: skipped).  Returns the evaluation summary dict."""
    os.makedirs(args.out_dir, exist_ok=True)
    weights = list(range(args.wt[0], args.wt[1] + 1, 2))
    wt_max = args.wt[1]
    tag = args.code

    # ---- phase 1: easy set (BP4-64 failures) ----
    mine_qc = qc if args.mine_qc else None
    miner = make_bp_failure_miner(graph, num_iter=64, wt_max=wt_max,
                                  compact_cap=args.mine_compact_cap, qc=mine_qc)
    ex, ez = mine_phase(miner, shard_seed(args.seed, EASY), weights, args.mine_batches,
                        args.mine_batch_size, args.easy_cap, f"{tag}_easy", args.out_dir,
                        ahead=args.mine_ahead)

    # the coarse model's subset (wt <= coarse_hi): mined per wt in order,
    # so the per-wt kept counts slice the stack
    with np.load(os.path.join(args.out_dir, f"{tag}_easy.npz")) as d:
        upto = int(np.sum(d["kept"][d["weights"] <= args.coarse_hi]))
    cx, cz = ex[:upto], ez[:upto]
    log(f"coarse subset: {cx.shape[0]} samples (wt <= {args.coarse_hi})")

    # ---- phase 2: coarse GNN, 16/16 schedule ----
    coarse = train_phase(graph, cx, cz,
                         TrainConfig(num_iter1=16, num_iter2=16, loss_from=8, learning_rate=args.lr),
                         shard_seed(args.seed, COARSE), args.batch_size, f"{tag}_coarse_16_16",
                         args.out_dir, epochs=args.coarse_epochs, steps_per_call=args.steps_per_call)

    # ---- phase 3: hard set (survives BP64 -> coarse GNN -> BP64) ----
    hminer = make_cascade_failure_miner(graph, coarse, num_iter1=64, num_iter2=64, wt_max=wt_max,
                                        compact_cap=args.mine_compact_cap, qc=mine_qc)
    hx, hz = mine_phase(hminer, shard_seed(args.seed, HARD), weights,
                        args.hard_mine_batches or args.mine_batches,
                        args.hard_mine_batch_size or args.mine_batch_size, args.hard_cap,
                        f"{tag}_hard", args.out_dir, ahead=args.mine_ahead)

    # ---- phase 4: final model, 64/16 on easy + hard x oversample ----
    mx, mz = mix_easy_hard((ex, ez), (hx, hz), args.hard_oversample)
    log(f"mixed set: {mx.shape[0]} samples "
        f"({ex.shape[0]} easy + {hx.shape[0]} hard x{args.hard_oversample})")
    final = train_phase(graph, mx, mz,
                        TrainConfig(num_iter1=64, num_iter2=16, loss_from=8, learning_rate=args.lr),
                        shard_seed(args.seed, FINAL), args.batch_size,
                        f"{tag}_final_64_16_mixed", args.out_dir, epochs=args.final_epochs,
                        steps_per_call=args.steps_per_call)

    # ---- phase 5: LER of the trained vs the shipped weights, same seeds ----
    evals = {"trained": [final], "shipped": [shipped] if shipped is not None else None}
    out = {}
    for name, params_list in evals.items():
        if params_list is not None:
            res = evaluate(graph, qc, params_list, args.eval_p, args.eval_batch, args.seed,
                           args.eval_target_errors, name)
            out[name] = _ler_dict(res)
    with open(os.path.join(args.out_dir, f"{tag}_scratch_eval.json"), "w") as f:
        json.dump(out, f, indent=1)
    log("done")
    return out


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    log(f"building code {args.code} ...")
    code = build_code(args.code)
    graph = QuantumGraph.from_code(code, stage_mode=True).to(device)
    shipped = None if args.skip_shipped_eval else load_weights(CODE_REGISTRY[args.code]["weights"], device)
    return curriculum(args, graph, qc_pair_from_code(code), shipped)


if __name__ == "__main__":
    main()
