"""Fill of the GNN rounds' sub-batch, in %: samples still flagged at the
start of each round, counted on the device (cascade.flagged.round), over
the round's sub-batch (cascade.capacity.round), over every round of the
batches the program traced.  None without the program's counters."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without counters
        return None
    counters = obs.snapshot()["counters"]
    capacity = counters.get("cascade.capacity.round")
    if not capacity:
        return None
    return 100.0 * counters.get("cascade.flagged.round", 0) / capacity
