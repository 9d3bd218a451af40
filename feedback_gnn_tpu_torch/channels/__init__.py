from .bsc import binary_source, bsc_sample, bsc_sample_ste
from .discrete import (
    binary_erasure_channel,
    binary_memoryless_channel,
    binary_symmetric_channel,
    binary_z_channel,
    erasure_from_uniforms,
    errors_from_uniforms,
    memoryless_from_uniforms,
    sample_errors_gumbel,
    ste_binarize,
    xor_ste,
)
from .pauli import depolarizing_probs, pauli_fixed_weight, pauli_fixed_weight_traced, pauli_iid
