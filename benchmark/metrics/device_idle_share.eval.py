"""Share of the traced window of Monte-Carlo batches in which no operation
ran on the device: 100 (1 - union of device intervals / window), in %."""


def read(trace, context):
    if context.get("kind") != "mc" or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
