"""Device time of every operation that is not K1 (the cascade's sampling,
GF(2) products, compaction, check logits and feedback GNN) per traced
batch, in ms."""

K1 = "bp4_qc_kernel"


def read(trace, context):
    if context.get("kind") != "mc" or not trace.steps:
        return None
    t = sum(e - s for name, s, e in trace.device_ops if K1 not in name)
    return 1e3 * t / trace.steps
