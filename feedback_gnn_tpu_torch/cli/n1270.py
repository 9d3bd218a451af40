"""[[1270,28]] feedback-GNN cascade evaluation, the counterpart of
examples/n1270.py: one p point, bs=5000, nG=5, run until 100 block errors.

    python -m feedback_gnn_tpu_torch.cli.n1270 -p 0.05 -id 0

The run id ``-id`` seeds the generators (when ``--seed`` is 0).  Every
flag of cli/evaluate.py applies, e.g. --qc-kernel [--compact F --prepass K]
for the fused-kernel path.  Runs on the CUDA card unless ``--device cpu``
is given.
"""

from __future__ import annotations

from .evaluate import run_example

__all__ = ["main"]


def main(argv=None):
    """Returns cli/evaluate.py's SimResult."""
    return run_example("n1270", argv)


if __name__ == "__main__":
    main()
