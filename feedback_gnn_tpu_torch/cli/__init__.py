"""Command-line entry points of the port: ``evaluate`` (the cascade's
Monte-Carlo LER, as scripts/evaluate.py), ``osd_eval`` (plain BP and
BP + OSD-0, as examples/osd_eval.py) and ``bench`` (bench.py's workload),
each run as ``python -m feedback_gnn_tpu_torch.cli.<name>``."""
