"""Fill of the OSD sub-batch, in %: samples BP flagged, counted on the
device (osd.flagged), over the samples OSD decodes (osd.capacity), over the
batches the program traced.  None without the program's counters."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without counters
        return None
    counters = obs.snapshot()["counters"]
    capacity = counters.get("osd.capacity")
    if not capacity:
        return None
    return 100.0 * counters.get("osd.flagged", 0) / capacity
