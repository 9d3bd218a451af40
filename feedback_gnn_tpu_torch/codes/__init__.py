from .css import (
    CSSCode,
    create_bivariate_QC_codes,
    create_checkerboard_toric_codes,
    create_circulant_matrix,
    create_cyclic_permuting_matrix,
    create_generalized_bicycle_codes,
    create_QC_GHP_codes,
    create_rotated_surface_codes,
    create_surface_codes,
    gb_n46_k2_d9_oc,
    gb_n48_k6_d8_oc,
    ghp_882_24,
    ghp_1270_28,
    hamming_code,
    hypergraph_product,
    read_alist,
    rep_code,
)
from .gf2 import compute_code_distance, int2bin, inverse, kernel, rank, row_basis, row_echelon
from .graph import QuantumGraph, RowSet, TannerGraph, build_graph, build_rowset
from .qc import QCGraphSpec, QCPair, detect_qc_structure, qc_pair_from_code
