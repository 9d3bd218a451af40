"""Device time of the cascade's compaction per batch the program traced, in
ms: its span cascade.compact (flags, flagged-first orders, takes, the
level-2 selection, masked updates, scatters, the overflow count).  None
without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("cascade.compact")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
