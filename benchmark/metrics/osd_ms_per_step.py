"""Device time of OSD-0's elimination per batch the program traced, in ms:
its span osd.eliminate (each osd0_decode call, both sides: the sort, the
table, the rank steps, the scatter back).  None without the program's
spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("osd.eliminate")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
