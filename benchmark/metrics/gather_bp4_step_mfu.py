"""The whole gather BP4 step's share of its least time on an H100, in %:
the least time of a batch's decode (gather_bp4_counts.gather_bp4_bound_ms,
as gather_bp4_roofline takes it) plus that of its GF(2) products (the
syndromes and the accounting, at the float32 peak, as gnn_bp4_step_mfu
charges them), over the traced wall time per batch."""


def read(trace, context):
    if context.get("kind") != "gather_bp4" or not context.get("gather_bp4_bound_ms") or not trace.steps \
            or trace.window_s <= 0:
        return None
    bound_ms = context["gather_bp4_bound_ms"] + context.get("gf2_bound_ms", 0.0)
    return 100.0 * bound_ms / (1e3 * trace.window_s / trace.steps)
