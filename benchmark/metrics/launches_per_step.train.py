"""Device kernels per traced train step, counted in the trace."""


def read(trace, context):
    if context.get("kind") != "train" or not trace.steps:
        return None
    n = sum(1 for name, s, e in trace.device_ops if not name.startswith(("Memcpy", "Memset")))
    return n / trace.steps
