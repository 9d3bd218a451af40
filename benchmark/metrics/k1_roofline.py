"""K1's share of its roofline, in %: the sum over a batch's K1 decodes of
the least time each could take on an H100 (counts.k1_bound_ms at its batch,
iterations and CN rule, as the benchmark's wrapper recorded them), over K1's
device time per traced batch."""

K1 = "bp4_qc_kernel"


def read(trace, context):
    bound = context.get("k1_bound_ms")
    t = sum(e - s for name, s, e in trace.device_ops if K1 in name)
    if not bound or not t or not trace.steps:
        return None
    return 100.0 * bound / (1e3 * t / trace.steps)
