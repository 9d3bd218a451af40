"""Device time of the gather BP4 decode's VN updates per batch the program
traced, in ms: its span bp4.vn (each iteration's marginals and extrinsic
messages, both sides).  None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("bp4.vn")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
