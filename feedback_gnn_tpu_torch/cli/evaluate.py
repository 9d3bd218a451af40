"""Logical-error-rate evaluation CLI of the feedback-GNN cascade, the
counterpart of scripts/evaluate.py:

    python -m feedback_gnn_tpu_torch.cli.evaluate -c n882 -p 0.08 --qc-kernel
    python -m feedback_gnn_tpu_torch.cli.evaluate -c n1270 -p 0.12 0.10 -nG 5 -bs 10000

Runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

from .. import resolve_device
from ..codes import QuantumGraph, qc_pair_from_code
from ..config import build_code, check_unported, config_from_args, make_eval_parser
from ..decoders.cascade import sandwich_eval_step
from ..decoders.gnn_feedback import load_weights
from ..sim import PlotLER

__all__ = ["run", "make_step", "main", "run_example"]


def make_step(cfg, device):
    """(code, step): the code of ``cfg`` and its Monte-Carlo step
    ``step(generator, p)`` on ``device``, counting compaction and rescue
    overflows when either is on."""
    code = build_code(cfg.code)
    graph = QuantumGraph.from_code(code, stage_mode=True).to(device)
    params = load_weights(cfg.resolve_weights(), device)
    qc = None
    if cfg.qc_kernel:
        qc = qc_pair_from_code(code)
        if qc is None:
            raise ValueError(f"code {cfg.code} has no block-circulant structure")
    track_overflow = bool(cfg.cascade.compact_fraction or cfg.cascade.rescue_phi)

    def step(generator, p):
        return sandwich_eval_step(graph, [params], cfg.cascade, generator, p, cfg.batch_size,
                                  qc=qc, return_overflow=track_overflow)

    return code, step


def run(cfg):
    """Build the code, graph, weights and step of ``cfg``, run the MC
    sweep, print the summary; returns the SimResult."""
    check_unported(cfg)
    device = resolve_device(cfg.device)
    print(f"building code {cfg.code} ...")
    code, step = make_step(cfg, device)
    print(f"{code}: cascade {cfg.cascade} on {device}")

    plot = PlotLER(title=f"{code.name} feedback-GNN cascade")
    result = plot.simulate(
        step,
        cfg.ps,
        batch_size=cfg.batch_size,
        max_mc_iter=cfg.max_mc_iter,
        num_target_block_errors=cfg.num_target_block_errors,
        legend=f"nG={cfg.cascade.num_rounds} f={cfg.cascade.factor1}",
        seed=cfg.seed,
        checkpoint_path=cfg.checkpoint,
        device=device,
    )
    print()
    print(result.summary())
    return result


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
