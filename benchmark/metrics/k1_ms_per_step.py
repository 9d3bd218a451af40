"""Device time of K1 (kernels named bp4_qc_kernel*) per traced batch, in ms."""

K1 = "bp4_qc_kernel"


def read(trace, context):
    t = sum(e - s for name, s, e in trace.device_ops if K1 in name)
    if not t or not trace.steps:
        return None
    return 1e3 * t / trace.steps
