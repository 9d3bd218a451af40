"""Host seconds of code construction in set-up: the program's span
setup.code (config.build_code, QuantumGraph.from_code, qc_pair_from_code),
recorded whether tracing is on or off.  None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    s = obs.snapshot()["spans"].get("setup.code")
    return s["host_s"] if s else None
