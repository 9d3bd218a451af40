"""Device time of the GNN_BP4 decode per batch the program traced, in ms:
its span gnn_bp4.decode (the whole decoder: the first CN update, the VN
updates, logits and CN updates of every iteration, the decisions).  None
without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("gnn_bp4.decode")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
