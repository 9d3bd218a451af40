"""Fill of the level-2 sub-batch, in %: samples still flagged after the
full stage-1 schedule, counted on the device (cascade.flagged.level2),
over its capacity (cascade.capacity.level2), over the batches the program
traced.  None without the program's counters."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without counters
        return None
    counters = obs.snapshot()["counters"]
    capacity = counters.get("cascade.capacity.level2")
    if not capacity:
        return None
    return 100.0 * counters.get("cascade.flagged.level2", 0) / capacity
