"""The gather BP4 decode's share of its roofline, in %: the least time on
an H100 of a batch's decode (gather_bp4_counts.gather_bp4_bound_ms at its
shape, as the benchmark's wrapper recorded it: float32 operations of the
true edges and nodes at the float32 peak, or the LLRs', syndromes' and
marginals' bytes where they take longer) over the device time of the
program's span bp4.decode per batch it traced.  None without the program's
spans or the recorded decode."""


def read(trace, context):
    bound = context.get("gather_bp4_bound_ms")
    if context.get("kind") != "gather_bp4" or not bound:
        return None
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("bp4.decode")
    if not snap["batches"] or not s or s["device_s"] <= 0:
        return None
    return 100.0 * bound / (1e3 * s["device_s"] / snap["batches"])
