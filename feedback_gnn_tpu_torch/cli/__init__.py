"""Command-line entry points of the port: ``evaluate`` (the cascade's
Monte-Carlo LER, as scripts/evaluate.py), ``osd_eval`` (plain BP and
BP + OSD-0, as examples/osd_eval.py), ``bench`` (bench.py's workload),
``train`` and ``train_from_scratch`` (feedback-GNN training, as
scripts/train.py and scripts/train_from_scratch.py) and
``generate_dataset`` (failure mining, as examples/generate_dataset.py),
``train_gnn_bp4`` (GNN_BP4 training and evaluation, as
scripts/train_gnn_bp4.py), ``qldpc_codes`` (the code zoo, as
examples/qldpc_codes.py) and ``n882``/``n1270`` (the per-code cascade
evaluations, as examples/n882.py and n1270.py),
each run as ``python -m feedback_gnn_tpu_torch.cli.<name>``."""
