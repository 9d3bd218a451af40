"""OSD-0's elimination's share of its roofline, in %: the least time on an
H100 of eliminating the flagged samples decoded (osd_counts.osd_bound_ms:
the integer operations of forward elimination a sample, as the reference
counted them on the checked batches, at the 32-bit integer issue rate),
over the device time of the program's span osd.eliminate, both over the
batches the program traced.  The samples decoded are min(osd.flagged,
osd.capacity) of the counters, which is the flagged count in every batch
that does not overflow (every correct run).  None without the program's
spans and counters or the reference's count."""

from benchmark import osd_counts


def read(trace, context):
    ops = context.get("osd_ops_per_sample")
    if not ops:
        return None
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s, counters = snap["spans"].get("osd.eliminate"), snap["counters"]
    if not snap["batches"] or not s or s["device_s"] <= 0 or "osd.flagged" not in counters:
        return None
    decoded = min(counters["osd.flagged"], counters.get("osd.capacity", 0))
    return 100.0 * osd_counts.osd_bound_ms(decoded, ops) / (1e3 * s["device_s"])
