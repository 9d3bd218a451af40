"""Plain BP and BP + OSD-0 evaluation of a CSS code, the counterpart of
examples/osd_eval.py: (a) plain BP4 and (b) BP4 + OSD-0 on the
depolarizing channel, (c) plain BP2 and (d) BP2 + OSD-0 on the BSC; and
(e) the fully-learned GNN decoder GNN_BP4 on the depolarizing channel, the
learned baseline beside them.

    python -m feedback_gnn_tpu_torch.cli.osd_eval -p 0.10 0.09 -bs 2000 --osd-cap 256
    python -m feedback_gnn_tpu_torch.cli.osd_eval --mode bp2-osd -p 0.05 --osd-cap 1536
    python -m feedback_gnn_tpu_torch.cli.osd_eval --mode bp4-osd -p 0.10 -bs 20480 --osd-cap 1024
    python -m feedback_gnn_tpu_torch.cli.osd_eval --mode gnn-bp4 -p 0.03 -bs 20480
    python -m feedback_gnn_tpu_torch.cli.osd_eval --code gb48_oc --mode bp4 -p 0.02 -bs 20480

``--code`` names the code (``CODES``): the [[882,24]] QC-GHP code
(``n882``, the default) or the [[48,6,8]] and [[46,2,9]] GB codes with
their overcomplete check matrices (``gb48_oc``: 1,000 rows a side, VN
degree up to 261; ``gb46_oc``: 400).  Plain BP2 needs a block-circulant
code; GNN_BP4's weights must be trained on the code.

Runs on the CUDA card unless ``--device cpu`` is given.  The plain BP2 mode
decodes on the fused QC BP2 decode (the CUDA kernel on the card); the OSD
modes decode with the gather decoders, as the JAX package's do, except
``bp4-osd``, whose BP4 runs on the fused QC decode (K1 on the card, its
plain version on the CPU) wherever the code is block-circulant, as
[[882,24]] is.  Without ``--osd-cap`` OSD runs on the whole batch:
[B, 429, 883] bytes of elimination table (B=20480 needs 7.8 GB).
``gnn-bp4`` decodes with the weights of ``--weights`` (an ``.npz`` with its
configuration in the ``.json`` beside it; by default the shipped n882
weights), 8 iterations from the syndromes alone; B=20480 peaks at about
32 GB on the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import codes, obs, resolve_device
from ..codes import QuantumGraph, build_graph, qc_pair_from_code, row_basis, row_echelon
from ..sim import PlotLER

__all__ = ["CODES", "build_code", "make_parser", "make_step", "main"]

# --code name -> constructor in codes/
CODES = {"n882": "ghp_882_24", "gb48_oc": "gb_n48_k6_d8_oc", "gb46_oc": "gb_n46_k2_d9_oc"}


@obs.setup("code", fn="osd_eval.build_code")
def build_code(name: str):
    """The ``CSSCode`` of a ``--code`` name."""
    return getattr(codes, CODES[name])()


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="plain BP and BP + OSD-0 evaluation of a CSS code")
    ap.add_argument("--code", choices=list(CODES), default="n882",
                    help="the code: [[882,24]] (n882), or a GB code with overcomplete check matrices")
    ap.add_argument("-p", type=float, nargs="+", default=[0.10])
    ap.add_argument("-bs", "--batch-size", type=int, default=2000)
    ap.add_argument("--target-errors", type=int, default=50)
    ap.add_argument("--max-mc-iter", type=int, default=50)
    ap.add_argument("--mode", choices=["bp4", "bp2", "bp4-osd", "bp2-osd", "gnn-bp4"], default="bp4-osd")
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
    ap.add_argument("--weights", default=None,
                    help="GNN_BP4 weights for --mode gnn-bp4: an .npz with its configuration in the "
                    ".json beside it (default: the shipped n882 weights)")
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
        qc = qc_pair_from_code(code)
        if qc is None:
            raise ValueError(f"--mode bp2 decodes on the fused QC BP2 decode: {code.name} is not block-circulant")
        spec = qc.qx  # the QC structure of hx
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
        qc = qc_pair_from_code(code)  # None: no block-circulant structure, the gather decoder

        def step(gen, p):
            return models.bp4_osd_eval_step(graph, code, gen, p, bs, num_iter=100, cn_type="minsum",
                                            normalization_factor=0.8, osd_compact_cap=args.osd_cap, qc=qc)

        return step, "BP4 minsum 0.8 x100 + OSD0" + (" (QC kernel)" if qc is not None else "")
    if args.mode == "gnn-bp4":
        from ..decoders import gnn_full

        host_graph = QuantumGraph.from_code(code, stage_mode=True)
        graph, lrowsets = host_graph.to(device), gnn_full.make_logit_rowsets(host_graph, device)
        params, cfg = (gnn_full.load_with_config(args.weights, device) if args.weights
                       else gnn_full.load_shipped("n882", device))

        def step(gen, p):
            return models.gnn_bp4_eval_step(graph, lrowsets, params, cfg, gen, p, bs)

        return step, f"GNN_BP4 x{cfg.num_iter}"
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
    code = build_code(args.code)
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
