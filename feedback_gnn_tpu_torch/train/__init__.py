"""Feedback-GNN training: the deep-supervision loss, the two-stage train
step and failure mining (the port of ``feedback_gnn_tpu/train``)."""

from .data import (
    batch_iterator,
    batch_iterator_stacked,
    make_bp_failure_miner,
    make_cascade_failure_miner,
    mine_failures,
    mix_easy_hard,
)
from .loss import bce_with_logits, deep_supervision_loss
from .trainer import (
    TrainConfig,
    make_optimizer,
    make_train_step,
    make_train_step_multi,
    stage_one_features,
)
