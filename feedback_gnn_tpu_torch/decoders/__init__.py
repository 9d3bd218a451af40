from .bp2 import BP2Result, bp2_decode
from .bp2_qc import bp2_qc_logits, bp2_qc_logits_plain
from .bp4 import BP4Result, bp4_decode, hard_decision, quaternary_to_binary_llrs
from .bp4_qc import bp4_decode_qc, bp4_qc_marginals, bp4_qc_marginals_plain
from .cascade import CascadeConfig, prior_llr, sandwich_decode, sandwich_eval_step
from .cn_update import CN_UPDATES, boxplus_rows, cn_update_minsum, cn_update_phi, cn_update_tanh, phi
from .gnn_feedback import (
    feedback_gnn_apply, init_feedback_gnn, load_reference_weights, load_weights, params_from_numpy,
    save_reference_weights,
)
from .gnn_full import (
    GNNBP4Config, gnn_bp4_apply, gnn_bp4_loss, init_gnn_bp4, load_gnn_bp4_weights, load_shipped,
    make_logit_rowsets,
)
from .graph_ops import expand_vn, gather_to_cn, pad_rows_to, scatter_from_cn, vn_sum
