"""Count the shipped [[882,24]] GNN_BP4 weights' logical errors with the JAX
package on the CPU, on the keys runs/gnn_bp4_n882.json's evaluation drew.

scripts/train_gnn_bp4.py evaluated p = 0.03 over 50 batches of 2048, batch b
from fold_in(fold_in(PRNGKey(0), 5000 + b), int(p * 1e4)); the run (on a
TPU) recorded 170 logical errors.  This repeats that evaluation in float32
on the CPU, batch by batch, with the same eval step:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/count_gnn_bp4_n882_jax.py [--batches 50]

About half a minute a batch.  Prints each batch's (flagged, logical) and
the sums.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph
from feedback_gnn_tpu.decoders import gnn_full as jg
from feedback_gnn_tpu.io.checkpoint import load_pytree
from feedback_gnn_tpu.models import gnn_bp4_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(batches=50, p=0.03, batch=2048):
    graph = QuantumGraph.from_code(jc.ghp_882_24(), stage_mode=True)
    rowsets = jg.make_logit_rowsets(graph)
    with open(os.path.join(REPO, "runs", "gnn_bp4_n882.json")) as f:
        cfg = jg.GNNBP4Config(**json.load(f)["cfg"])
    params = load_pytree(os.path.join(REPO, "runs", "gnn_bp4_n882_weights.npz"),
                         jg.init_gnn_bp4(jax.random.PRNGKey(0), cfg, graph))
    step = jax.jit(lambda k: gnn_bp4_eval_step(graph, rowsets, params, cfg, k, jnp.float32(p), batch))
    flagged = logical = 0
    for b in range(batches):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 5000 + b), int(p * 1e4))
        f, lg = (int(v) for v in step(k))
        flagged, logical = flagged + f, logical + lg
        print(f"batch {b}: flagged {f} logical {lg}", flush=True)
    print(f"p={p}: logical {logical}/{batches * batch}, flagged {flagged}", flush=True)
    return flagged, logical


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=50)
    main(ap.parse_args().batches)
