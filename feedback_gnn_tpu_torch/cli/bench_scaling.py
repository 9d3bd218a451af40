"""Multi-device scaling benchmark of the port, the counterpart of
scripts/bench_scaling.py: weak scaling of the data-parallel (and
optionally edge-partitioned) Monte-Carlo cascade.

Each data rank keeps a fixed LOCAL batch, so perfect scaling multiplies
the global syndromes/s by the number of data ranks.  For every data count
of ``--shards`` the CLI spawns ``data x edge`` ranks on this machine
(parallel/launch.py; one per card while there are cards enough, else
sharing them), times ``--iters`` steps after one warm-up step, and prints
one JSON line with the efficiency against the first layout's per-rank
rate.  Ranks that share one card time-slice it, so there the efficiency
measures the sharing, not a speed-up.

    python -m feedback_gnn_tpu_torch.cli.bench_scaling --code n882 --local-batch 10240 \\
        --shards 1 2 --qc-kernel [--edge-shards 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from ..codes import QuantumGraph, create_generalized_bicycle_codes, ghp_1270_28, ghp_882_24
from ..codes import qc_pair_from_code
from ..decoders.cascade import CascadeConfig
from ..decoders.gnn_feedback import init_feedback_gnn
from ..parallel.launch import launch
from ..parallel.workers import run_tasks

__all__ = ["main", "scaling_rows"]

CODES = {
    "gb48": lambda: create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]),
    "n882": ghp_882_24,
    "n1270": ghp_1270_28,
}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="gb48", choices=list(CODES))
    ap.add_argument("--local-batch", type=int, default=512)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2], help="data-axis sizes to sweep")
    ap.add_argument("--edge-shards", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3, help="timed steps per layout")
    ap.add_argument("--iters1", type=int, default=64)
    ap.add_argument("--iters2", type=int, default=16)
    ap.add_argument("-nG", "--num-rounds", type=int, default=3)
    ap.add_argument("-p", type=float, default=0.05)
    ap.add_argument("--qc-kernel", action="store_true",
                    help="every rank decodes through K1 (needs --edge-shards 1)")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions (default: the cards)")
    return ap


def scaling_rows(args):
    """One dict per layout of ``args`` (the parsed flags), in order."""
    code = CODES[args.code]()
    graph = QuantumGraph.from_code(code, stage_mode=True)
    params = init_feedback_gnn(torch.Generator().manual_seed(0))
    cfg = CascadeConfig(num_iter1=args.iters1, num_iter2=args.iters2, num_rounds=args.num_rounds)
    qc = qc_pair_from_code(code) if args.qc_kernel else None
    edges = graph.gx.num_edges + graph.gz.num_edges
    rows, base = [], None
    for d in args.shards:
        world = d * args.edge_shards
        task = dict(mesh_shape=(d, args.edge_shards), graph=graph, params=params, cfg=cfg,
                    local_batch=args.local_batch, seeds=list(range(1, args.iters + 1)), p=args.p,
                    qc=qc, warmup=1)
        res = [r[0] for r in launch(run_tasks, world, args=([("eval_counts", task)], args.device),
                                    device=args.device, threads=1 if args.device == "cpu" else None,
                                    join_timeout_s=None, timeout_s=600.0)]
        seconds = max(r["seconds"] for r in res)
        sps = args.local_batch * d * args.iters / seconds
        if base is None:
            base = sps / d  # per-rank rate of the first layout
        rows.append({
            "metric": f"{args.code}_cascade_scaling_torch",
            "data_shards": d,
            "edge_shards": args.edge_shards,
            "backend": res[0]["backend"],
            "qc_kernel": qc is not None,
            "syndromes_per_s": sps,
            "edges_per_s": sps * edges * (args.iters1 + cfg.num_rounds * args.iters2),
            "weak_scaling_efficiency": sps / (base * d),
            "k1_launches_per_rank": [r["k1_launches"] for r in res],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in res],
        })
    return rows


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    device = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rows = scaling_rows(args)
    for row in rows:
        print(json.dumps(dict(row, device=device)), flush=True)
    return rows


if __name__ == "__main__":
    main()
