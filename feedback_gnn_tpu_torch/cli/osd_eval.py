"""Plain BP and BP + OSD-0 evaluation of the [[882,24]] GHP code, the
counterpart of examples/osd_eval.py: (a) plain BP4 and (b) BP4 + OSD-0 on
the depolarizing channel, (c) plain BP2 and (d) BP2 + OSD-0 on the BSC.

    python -m feedback_gnn_tpu_torch.cli.osd_eval -p 0.10 0.09 -bs 2000 --osd-cap 256
    python -m feedback_gnn_tpu_torch.cli.osd_eval --mode bp2-osd -p 0.05 --osd-cap 1536

Runs on the CUDA card unless ``--device cpu`` is given.  The plain BP2 mode
decodes on the fused QC BP2 decode (the CUDA kernel on the card); the OSD
modes decode with the gather decoders, as the JAX package's do.  Without
``--osd-cap`` OSD runs on the whole batch: [B, 441, 883] bytes of
elimination table (B=20480 needs 8 GB).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..codes import QuantumGraph, build_graph, ghp_882_24, qc_pair_from_code, row_basis, row_echelon
from ..sim import PlotLER

__all__ = ["make_parser", "make_step", "main"]


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="plain BP and BP + OSD-0 evaluation of [[882,24]]")
    ap.add_argument("-p", type=float, nargs="+", default=[0.10])
    ap.add_argument("-bs", "--batch-size", type=int, default=2000)
    ap.add_argument("--target-errors", type=int, default=50)
    ap.add_argument("--max-mc-iter", type=int, default=50)
    ap.add_argument("--mode", choices=["bp4", "bp2", "bp4-osd", "bp2-osd"], default="bp4-osd")
    ap.add_argument("--iters", type=int, default=None,
                    help="BP iterations for the plain bp4/bp2 modes (default 64 SP / 100 NMS)")
    ap.add_argument("--cn-type", default=None, choices=["boxplus-phi", "boxplus", "minsum"],
                    help="CN update for the plain bp4/bp2 modes "
                    "(default boxplus-phi; the reference's NMS rows use minsum)")
    ap.add_argument("--factor", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accounting", choices=["all", "undetected"], default="all",
                    help="logical-error convention for the plain bp4/bp2 modes: 'all' counts "
                    "any ls_hat!=0; 'undetected' counts only syndrome-consistent logical "
                    "flips (the convention of the reference OSD notebook's plain-BP tables)")
    ap.add_argument("--checkpoint", default=None, help="MC-state resume file (JSON)")
    ap.add_argument("--osd-cap", type=int, default=None,
                    help="run OSD on a dense flagged-only sub-batch of this size; flagged "
                    "samples beyond it are reported as overflow")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the kernels' "
                    "plain versions)")
    return ap


def make_step(args, code, device):
    """(step, legend) of ``args.mode`` on ``device``."""
    from .. import models

    bs = args.batch_size
    hx = torch.as_tensor(np.asarray(code.hx), dtype=torch.float32, device=device)
    lx = torch.as_tensor(np.asarray(code.lx), dtype=torch.float32, device=device)
    if args.mode == "bp4":
        graph = QuantumGraph.from_code(code, stage_mode=True).to(device)
        iters = args.iters or 64
        cn = args.cn_type or "boxplus-phi"
        factor = args.factor if args.factor is not None else 1.0

        def step(gen, p):
            return models.bp4_plain_eval_step(graph, gen, p, bs, num_iter=iters, cn_type=cn,
                                              normalization_factor=factor,
                                              accounting=args.accounting)

        return step, f"plain BP4-{iters} {cn} f={factor} [{args.accounting}]"
    if args.mode == "bp2":
        hx_graph = build_graph(np.asarray(code.hx)).to(device)
        spec = qc_pair_from_code(code).qx  # the QC structure of hx
        iters = args.iters or 100
        cn = args.cn_type or "minsum"
        factor = args.factor if args.factor is not None else 0.8

        def step(gen, p):
            return models.bp2_bsc_eval_step(hx_graph, hx, lx, gen, p, bs, num_iter=iters,
                                            cn_type=cn, normalization_factor=factor,
                                            qc_spec=spec, accounting=args.accounting)

        return step, f"plain BP2-{iters} {cn} f={factor} (BSC) [{args.accounting}]"
    if args.mode == "bp4-osd":
        graph = QuantumGraph.from_code(code, stage_mode=True).to(device)

        def step(gen, p):
            return models.bp4_osd_eval_step(graph, code, gen, p, bs, num_iter=100, cn_type="minsum",
                                            normalization_factor=0.8, osd_compact_cap=args.osd_cap)

        return step, "BP4 minsum 0.8 x100 + OSD0"
    hx_np = np.asarray(code.hx)
    basis = row_basis(hx_np)
    pivot = row_echelon(hx_np.T)[3]
    hx_graph = build_graph(hx_np).to(device)

    def step(gen, p):
        # logical check = lx, as the reference's BP2_OSD_Model instantiation
        return models.bp2_osd_eval_step(hx_graph, hx, basis, pivot, lx, gen, p, bs, num_iter=100,
                                        cn_type="minsum", normalization_factor=0.8,
                                        osd_compact_cap=args.osd_cap)

    return step, "BP2 minsum 0.8 x100 + OSD0 (BSC)"


def main(argv=None):
    """Run the MC sweep of the chosen mode, print the summary; returns the
    SimResult."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    code = ghp_882_24()
    step, legend = make_step(args, code, device)
    plot = PlotLER(title=f"{code.name} {legend}")
    result = plot.simulate(
        step,
        args.p,
        batch_size=args.batch_size,
        max_mc_iter=args.max_mc_iter,
        num_target_block_errors=args.target_errors,
        legend=legend,
        seed=args.seed,
        checkpoint_path=args.checkpoint,
        device=device,
    )
    print()
    print(result.summary())
    return result


if __name__ == "__main__":
    main()
