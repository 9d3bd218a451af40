"""The stream's idle stretch between batches per batch the program traced,
in ms: the device time of sim_ler's span sim.between_batches, from the
end of one step's enqueue to the call of the next (CUDA events).  None
without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    snap = obs.snapshot()
    s = snap["spans"].get("sim.between_batches")
    if not snap["batches"] or not s:
        return None
    return 1e3 * s["device_s"] / snap["batches"]
