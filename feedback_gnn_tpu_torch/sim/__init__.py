from .metrics import (
    compute_ber,
    compute_bler,
    count_block_errors,
    count_errors,
    hard_decisions,
    llr2mi,
)
