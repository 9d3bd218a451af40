"""Device time of GNN_BP4's logits per batch the program traced, in ms: its
span gnn_bp4.logits (llr_inv_embed, the binary LLRs and the boxplus over
the [hz; lz] and [hx; lx] rows, every iteration).  None without the
program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("gnn_bp4.logits")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
