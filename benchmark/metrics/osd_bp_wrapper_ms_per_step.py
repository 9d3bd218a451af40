"""Device time of the BP4 + OSD-0 step's BP wrapper per batch the program
traced, in ms: its span osd.bp (the BP decode: the input layout copies,
pads and hard decisions around K1) less its child k1.kernel (the launch of
K1 alone).  None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    bp = snap["spans"].get("osd.bp")
    if not snap["batches"] or not bp:
        return None
    k1 = snap["spans"].get("k1.kernel", {"device_s": 0.0})
    return 1e3 * (bp["device_s"] - k1["device_s"]) / snap["batches"]
