"""Code-construction demo and plain BP4 sweeps over a family of codes, the
counterpart of examples/qldpc_codes.py: construct Steane, surface,
rotated-surface, toric, hypergraph-product, GB and GHP codes, print their
parameters, and with ``--sweep`` run plain BP4 at two p points.

    python -m feedback_gnn_tpu_torch.cli.qldpc_codes            # the table only
    python -m feedback_gnn_tpu_torch.cli.qldpc_codes --sweep    # and the BP4 sweeps

The sweeps run on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import resolve_device
from ..codes import (
    CSSCode,
    QuantumGraph,
    create_checkerboard_toric_codes,
    create_cyclic_permuting_matrix,
    create_generalized_bicycle_codes,
    create_QC_GHP_codes,
    create_rotated_surface_codes,
    create_surface_codes,
    gb_n46_k2_d9_oc,
    gb_n48_k6_d8_oc,
    hamming_code,
    hypergraph_product,
    rep_code,
)
from ..models import bp4_plain_eval_step
from ..sim import PlotLER

__all__ = ["build_zoo", "print_table", "main"]


def build_zoo() -> dict:
    """{row name: CSSCode}, the rows of the JAX example's table."""
    h = hamming_code(3)
    return {
        # Steane code = CSS(Hamming(3), Hamming(3))
        "Steane": CSSCode(h, h, name="Steane"),
        "Surface d=3": create_surface_codes(3),
        "Rotated surface d=3": create_rotated_surface_codes(3),
        "Toric (checkerboard) d=4": create_checkerboard_toric_codes(4),
        "HGP(rep5, rep5)": hypergraph_product(rep_code(5), rep_code(5)),
        "GB [[254,28]]": create_generalized_bicycle_codes(127, [0, 15, 20, 28, 66], [0, 58, 59, 100, 121]),
        # overcomplete check matrices: the redundant rows help BP converge
        "GB [[48,6,8]] overcomplete": gb_n48_k6_d8_oc(),
        "GB [[46,2,9]] overcomplete": gb_n46_k2_d9_oc(),
        "GHP [[882,24]]": create_QC_GHP_codes(63, create_cyclic_permuting_matrix(7, [27, 54, 0]), [0, 1, 6]),
    }


def print_table(zoo):
    print(f"{'code':28s} {'N':>6} {'K':>4} {'mx':>5} {'mz':>5} {'edges':>6}")
    for name, code in zoo.items():
        hx = np.asarray(code.hx)
        print(f"{name:28s} {code.N:6d} {code.K:4d} {hx.shape[0]:5d} "
              f"{np.asarray(code.hz).shape[0]:5d} {int(hx.sum()):6d}")


def main(argv=None):
    """Print the table (and run the sweeps); returns the zoo."""
    ap = argparse.ArgumentParser(description="Code zoo and plain BP4 sweeps (PyTorch/CUDA).")
    ap.add_argument("--sweep", action="store_true", help="run BP sweeps too")
    ap.add_argument("-bs", "--batch-size", type=int, default=2000)
    ap.add_argument("--device", default=None, help="torch device of the sweeps (default: the CUDA card)")
    args = ap.parse_args(argv)

    zoo = build_zoo()
    print_table(zoo)
    if not args.sweep:
        return zoo

    device = resolve_device(args.device)
    for name in ["Surface d=3", "GHP [[882,24]]"]:
        graph = QuantumGraph.from_code(zoo[name], stage_mode=False).to(device)

        def step(generator, p, graph=graph):
            return bp4_plain_eval_step(graph, generator, p, args.batch_size)

        plot = PlotLER(title=f"{name} plain BP4")
        plot.simulate(step, [0.08, 0.06], batch_size=args.batch_size, max_mc_iter=20,
                      num_target_block_errors=50, legend="BP4-64 phi", device=device)
        print()
    return zoo


if __name__ == "__main__":
    main()
