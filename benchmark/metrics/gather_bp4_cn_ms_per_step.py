"""Device time of the gather BP4 decode's CN updates per batch the program
traced, in ms: its span bp4.cn (each iteration's gather into the CN frame,
boxplus-phi update and scatter back, both sides).  None without the
program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("bp4.cn")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
