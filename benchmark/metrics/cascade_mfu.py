"""The whole Monte-Carlo step's share of the H100's float32 peak (67
TFLOP/s outside the tensor cores; the configurations state float32 with
TF32 off), in %: the operations a batch needs (K1's at its decodes' shapes,
the feedback GNN's at its sub-batch, each GF(2) product at nnz(H) x batch;
counts.py) over the traced wall time per batch times the peak."""

from benchmark import counts


def read(trace, context):
    ops = context.get("ops")
    if context.get("kind") != "mc" or not ops or not trace.steps or trace.window_s <= 0:
        return None
    per_batch_s = trace.window_s / trace.steps
    return 100.0 * sum(ops.values()) / (per_batch_s * counts.H100_F32_OPS)
