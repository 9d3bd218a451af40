"""Device time of OSD's flag test and compaction per batch the program
traced, in ms: its spans osd.flag (the flag test's GF(2) products, the
binary reliabilities, the pivot-reduced syndromes) and osd.compact (the
flagged-first order, the sub-batch's gathers, the scatter back, the
overflow count).  None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    spans = [snap["spans"].get(name) for name in ("osd.flag", "osd.compact")]
    if not snap["batches"] or not all(spans):
        return None
    return 1e3 * sum(s["device_s"] for s in spans) / snap["batches"]
