"""Device time of the gather BP4 decode per batch the program traced, in ms:
its span bp4.decode (the whole decoder: every VN and CN update of both
sides, the final marginals, check logits and decisions).  None without the
program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("bp4.decode")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
