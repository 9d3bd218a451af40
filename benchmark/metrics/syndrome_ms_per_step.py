"""Device time of the step's sampling and accounting per batch the program
traced, in ms: its spans step.sample (noise, pads, the two syndrome
products, the prior) and step.account (the estimate's syndromes, the four
accounting products, the counts).  None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    spans = [snap["spans"].get(name) for name in ("step.sample", "step.account")]
    if not snap["batches"] or not all(spans):
        return None
    return 1e3 * sum(s["device_s"] for s in spans) / snap["batches"]
