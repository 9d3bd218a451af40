"""Fill of the level-1 sub-batch, in %: samples flagged after stage 1 (the
prepass), counted on the device (cascade.flagged.level1), over its
capacity (cascade.capacity.level1), over the batches the program traced.
None without the program's counters."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without counters
        return None
    counters = obs.snapshot()["counters"]
    capacity = counters.get("cascade.capacity.level1")
    if not capacity:
        return None
    return 100.0 * counters.get("cascade.flagged.level1", 0) / capacity
