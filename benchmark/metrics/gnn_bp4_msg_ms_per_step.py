"""Device time of GNN_BP4's message passing per batch the program traced,
in ms: its spans gnn_bp4.vn and gnn_bp4.cn (every VN and CN update, both
sides: the endpoint gathers, the message MLPs, the means and the embed
MLPs).  None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    spans = [snap["spans"].get(name) for name in ("gnn_bp4.vn", "gnn_bp4.cn")]
    if not snap["batches"] or not all(spans):
        return None
    return 1e3 * sum(s["device_s"] for s in spans) / snap["batches"]
