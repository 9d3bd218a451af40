"""Device time of the feedback GNN per batch the program traced, in ms: its
span cascade.gnn (the stacked marginals and feedback_gnn_apply, every
round).  None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("cascade.gnn")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
