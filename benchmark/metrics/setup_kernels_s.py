"""Host seconds of the kernel library's build and load in set-up: the
program's span setup.kernels (nvcc where this source revision has no
library yet, then the dlopen), recorded whether tracing is on or off.
None without the program's spans."""


def read(trace, context):
    try:
        from feedback_gnn_tpu_torch import obs
    except ImportError:  # a program without spans
        return None
    s = obs.snapshot()["spans"].get("setup.kernels")
    return s["host_s"] if s else None
