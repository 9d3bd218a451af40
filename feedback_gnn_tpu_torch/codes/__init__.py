from .css import (
    CSSCode,
    create_circulant_matrix,
    create_cyclic_permuting_matrix,
    create_generalized_bicycle_codes,
    create_QC_GHP_codes,
    create_surface_codes,
    ghp_882_24,
    ghp_1270_28,
    hypergraph_product,
    rep_code,
)
from .gf2 import compute_code_distance, kernel, row_basis, row_echelon
from .graph import QuantumGraph, RowSet, TannerGraph, build_graph, build_rowset
from .qc import QCGraphSpec, QCPair, detect_qc_structure, qc_pair_from_code
