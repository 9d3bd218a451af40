from .bp4 import BP4Result, hard_decision, quaternary_to_binary_llrs
from .bp4_qc import bp4_decode_qc, bp4_qc_marginals, bp4_qc_marginals_plain
from .cascade import CascadeConfig, prior_llr, sandwich_decode, sandwich_eval_step
from .cn_update import boxplus_rows, phi
from .gnn_feedback import feedback_gnn_apply, init_feedback_gnn, load_weights, params_from_numpy
