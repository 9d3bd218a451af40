from .bsc import binary_source, bsc_sample, bsc_sample_ste
from .pauli import depolarizing_probs, pauli_fixed_weight, pauli_fixed_weight_traced, pauli_iid
