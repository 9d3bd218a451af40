"""Share of the traced window of train steps in which no operation ran on
the device: 100 (1 - union of device intervals / window), in %."""


def read(trace, context):
    if context.get("kind") != "train" or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
