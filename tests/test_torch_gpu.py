"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests carry the ``gpu`` mark and skip where no CUDA card is found.
They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance rtol = atol = 2e-3 on the marginals, the JAX suite's own for
kernel-versus-reference marginals.
"""

import numpy as np
import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.decoders import bp4_qc

CODES = {
    "gb48": lambda: tc.create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]),
    "ghp21": lambda: tc.create_QC_GHP_codes(7, tc.create_cyclic_permuting_matrix(3, [2, 4, 0]), [0, 1, 3]),
    "n882": tc.ghp_882_24,
}
CASES = [
    ("boxplus-phi", None),
    ("boxplus-phi", "tf"),
    ("boxplus-phi", "accurate"),
    ("boxplus", None),
    ("minsum", None),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("cn_type,phi_impl", CASES)
def test_bp4_qc_kernel_matches_plain(card, code, cn_type, phi_impl):
    qc = tc.qc_pair_from_code(CODES[code]())
    g = torch.Generator(device=card).manual_seed(4)
    b = 64
    llr = torch.randn((3, qc.n, b), generator=g, device=card) * 2.0
    sx = torch.randint(0, 2, (qc.qx.mb * qc.l, b), generator=g, device=card).float()
    sz = torch.randint(0, 2, (qc.qz.mb * qc.l, b), generator=g, device=card).float()
    before = bp4_qc.launches
    out = bp4_qc.bp4_qc_marginals(qc, llr, sx, sz, 16, cn_type, 0.9, phi_impl=phi_impl)
    assert bp4_qc.launches == before + 1
    ref = bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, 16, cn_type, 0.9, phi_impl=phi_impl)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.is_cuda and o.shape == (qc.n, b)
        np.testing.assert_allclose(o.cpu().numpy(), r.cpu().numpy(), rtol=2e-3, atol=2e-3)
