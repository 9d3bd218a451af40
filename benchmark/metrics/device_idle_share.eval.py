"""Share of the traced window of Monte-Carlo evaluation batches in which no
operation ran on the device: 100 (1 - union of device intervals / window),
in %.  Read in every run whose kind marks its window as an evaluation loop
(context "loop" "eval", as the mc kind does)."""


def read(trace, context):
    if context.get("loop") != "eval" or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
