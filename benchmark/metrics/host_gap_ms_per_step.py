"""The host's work between batches per batch the program traced, in ms: the
host time of sim_ler's span sim.host_gap, from a batch's first count on
the host to the next batch's call (the other count reads, bookkeeping,
checkpoint test, reseed).  None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("sim.host_gap")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["host_s"] / snap["batches"]
