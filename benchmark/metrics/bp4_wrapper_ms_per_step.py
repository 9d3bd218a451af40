"""Device time of K1's wrapper per batch the program traced, in ms: its
span cascade.bp (every BP run: the input layout copies, pads, check logits
and hard decisions) less its child k1.kernel (the launch of K1 alone).
None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    bp = snap["spans"].get("cascade.bp")
    if not snap["batches"] or not bp:
        return None
    k1 = snap["spans"].get("k1.kernel", {"device_s": 0.0})
    return 1e3 * (bp["device_s"] - k1["device_s"]) / snap["batches"]
