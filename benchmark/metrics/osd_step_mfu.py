"""The whole BP4 + OSD-0 step's share of its least time on an H100, in %:
the sum of the least times of a batch's K1 decode (counts.k1_bound_ms at
its shape, as the benchmark's wrapper recorded it), its GF(2) products (at
the float32 peak, as cascade_mfu charges them) and OSD-0's elimination of
the flagged samples decoded (osd_counts.osd_bound_ms, per batch the
program traced), over the traced wall time per batch.  None without the
program's counters."""

from benchmark import osd_counts


def read(trace, context):
    if context.get("kind") != "osd" or not context.get("osd_ops_per_sample") or not trace.steps \
            or trace.window_s <= 0:
        return None
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without counters
        return None
    snap = obs.snapshot()
    counters = snap["counters"]
    if not snap["batches"] or "osd.flagged" not in counters:
        return None
    decoded = min(counters["osd.flagged"], counters.get("osd.capacity", 0)) / snap["batches"]
    bound_ms = (context["k1_bound_ms"] + context["gf2_bound_ms"]
                + osd_counts.osd_bound_ms(decoded, context["osd_ops_per_sample"]))
    return 100.0 * bound_ms / (1e3 * trace.window_s / trace.steps)
