"""Logical-error-rate evaluation CLI of the feedback-GNN cascade, the
counterpart of scripts/evaluate.py:

    python -m feedback_gnn_tpu_torch.cli.evaluate -c n882 -p 0.08 --qc-kernel
    python -m feedback_gnn_tpu_torch.cli.evaluate -c n1270 -p 0.12 0.10 -nG 5 -bs 10000

Runs on the CUDA card unless ``--device cpu`` is given.  With
``--data-shards``/``--edge-shards`` of more than one rank in all, the run is
laid out on a ('data', 'edge') grid (parallel/): the CLI spawns the ranks
on this machine, one process each, or, with ``--multihost``, joins the
process group that ``torchrun`` started (``torchrun --nproc-per-node=N -m
feedback_gnn_tpu_torch.cli.evaluate --multihost --data-shards N ...``).
Every rank runs the same sweep on the same batch seeds and returns the
global counts; only rank 0 prints and writes the checkpoint.
"""

from __future__ import annotations

import os

from .. import resolve_device
from ..codes import QuantumGraph, qc_pair_from_code
from ..config import build_code, config_from_args, make_eval_parser
from ..decoders.cascade import sandwich_eval_step
from ..decoders.gnn_feedback import load_weights
from ..sim import PlotLER

__all__ = ["run", "make_step", "main", "run_example"]

# bound on each collective of a sharded sweep (a batch runs between two)
DIST_TIMEOUT_S = 600.0


def make_step(cfg, device, mesh=None):
    """(code, step): the code of ``cfg`` and its Monte-Carlo step
    ``step(generator, p)`` on ``device``, counting compaction and rescue
    overflows when either is on.  With ``mesh`` (parallel.make_mesh) the
    step is the sharded one, over ``cfg.batch_size`` samples in all."""
    code = build_code(cfg.code)
    graph = QuantumGraph.from_code(code, stage_mode=True)
    params = load_weights(cfg.resolve_weights(), device)
    qc = None
    if cfg.qc_kernel:
        qc = qc_pair_from_code(code)
        if qc is None:
            raise ValueError(f"code {cfg.code} has no block-circulant structure")
    track_overflow = bool(cfg.cascade.compact_fraction or cfg.cascade.rescue_phi)
    if mesh is not None:
        from ..parallel import make_sharded_eval_step, shard_quantum_graph

        if cfg.batch_size % mesh.data:
            raise ValueError(f"batch {cfg.batch_size} does not split over {mesh.data} data shards")
        return code, make_sharded_eval_step(mesh, shard_quantum_graph(graph, mesh.edge), [params],
                                            cfg.cascade, cfg.batch_size // mesh.data, qc=qc,
                                            return_overflow=track_overflow)
    graph = graph.to(device)

    def step(generator, p):
        return sandwich_eval_step(graph, [params], cfg.cascade, generator, p, cfg.batch_size,
                                  qc=qc, return_overflow=track_overflow)

    return code, step


def _sweep(cfg):
    """The sweep of ``cfg`` in this process: on the joined process group's
    grid when there is one, else alone."""
    import torch.distributed as dist

    mesh = None
    if dist.is_initialized():
        from ..parallel import make_mesh

        mesh = make_mesh(cfg.data_shards, cfg.edge_shards, device=cfg.device)
        device = mesh.device
    else:
        device = resolve_device(cfg.device)
    rank0 = mesh is None or mesh.rank == 0
    if rank0:
        print(f"building code {cfg.code} ...")
    code, step = make_step(cfg, device, mesh)
    if rank0:
        layout = "" if mesh is None else f" on a data={mesh.data} x edge={mesh.edge} grid"
        print(f"{code}: cascade {cfg.cascade} on {device}{layout}")

    plot = PlotLER(title=f"{code.name} feedback-GNN cascade")
    result = plot.simulate(
        step,
        cfg.ps,
        batch_size=cfg.batch_size,
        max_mc_iter=cfg.max_mc_iter,
        num_target_block_errors=cfg.num_target_block_errors,
        legend=f"nG={cfg.cascade.num_rounds} f={cfg.cascade.factor1}",
        seed=cfg.seed,
        verbose=rank0,
        # every rank reads the checkpoint (the counts are summed inside the
        # step, so restored state and stop decisions agree everywhere, as
        # the collectives need); rank 0 alone writes it
        checkpoint_path=cfg.checkpoint,
        write_checkpoint=rank0,
        # one grid, one batch seed for every rank: each data rank's stream
        # comes from the data index inside the sharded step
        fold_process_key=mesh is None,
        device=device,
    )
    if rank0:
        print()
        print(result.summary())
    return result


def run(cfg):
    """Build the code, graph, weights and step of ``cfg``, run the MC
    sweep, print the summary; returns the SimResult (rank 0's when the run
    is sharded)."""
    world = cfg.data_shards * cfg.edge_shards
    if cfg.multihost:
        from ..parallel import init_distributed

        init_distributed(timeout_s=DIST_TIMEOUT_S, device=cfg.device)
        return _sweep(cfg)
    if world > 1:
        from ..parallel.launch import launch

        threads = max(1, (os.cpu_count() or 1) // world) if cfg.device == "cpu" else None
        return launch(_sweep, world, args=(cfg,), device=cfg.device, timeout_s=DIST_TIMEOUT_S,
                      join_timeout_s=None, threads=threads)[0]
    return _sweep(cfg)


def main(argv=None):
    return run(config_from_args(make_eval_parser().parse_args(argv)))


def run_example(code: str, argv=None):
    """The per-code example CLIs (cli/n882.py, cli/n1270.py): this CLI's
    flags with the reference defaults (bs=5000, nG=5) and a run id ``-id``
    that seeds the generators when ``--seed`` is 0.  Returns the SimResult."""
    ap = make_eval_parser()
    ap.prog = code
    ap.add_argument("-id", type=int, default=0, help="run id (seeds the generators)")
    ap.set_defaults(code=code, batch_size=5000, num_rounds=5)
    args = ap.parse_args(argv)
    args.seed = args.seed or args.id
    return run(config_from_args(args))


if __name__ == "__main__":
    main()
