from .pauli import depolarizing_probs, pauli_fixed_weight, pauli_iid
