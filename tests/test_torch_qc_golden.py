"""The plain version of the port's fused QC BP4 decode against the TF
original's goldens on GB-48 (tests/golden/bp4_gb48_*.npz), held by
tests/test_bp4_parity.py's ``assert_llr_parity`` at its own tolerances:
strict allclose for minsum, and for boxplus / boxplus-phi 98 % of the
informative entries (|llr| < 10) within atol 5e-2 + 1e-3 |ref| and 99.95 %
sign agreement.  The boxplus golden needs the tanh saturated where TF's
float32 tanh saturates (decoders/cn_update.TANH_SAT).

This file imports no JAX: tests/test_torch_gpu.py holds the CUDA kernel
to the same goldens through ``check_qc_golden``.
"""

import pytest
import torch

from feedback_gnn_tpu_torch.codes import QCPair, detect_qc_structure
from feedback_gnn_tpu_torch import obs
from feedback_gnn_tpu_torch.decoders import bp4_qc
from test_bp4_parity import assert_llr_parity, load_case

QC_GOLDENS = ["bp4_gb48_phi8.npz", "bp4_gb48_minsum8.npz", "bp4_gb48_tanh4.npz"]
GB48_LIFT = 24


def check_qc_golden(case, device):
    """Decode the golden's noise with ``bp4_qc_marginals`` on ``device``
    and hold llrx, llry and llrz to the TF original's."""
    d = load_case(case)
    hx, hz = d["hx"].astype(int), d["hz"].astype(int)
    qc = QCPair(l=GB48_LIFT, n=hx.shape[1], qx=detect_qc_structure(hx, GB48_LIFT),
                qz=detect_qc_structure(hz, GB48_LIFT))
    llr = torch.as_tensor(d["llr"], device=device).permute(1, 2, 0)  # [bs,3,n] -> [3,n,B]
    sx = torch.as_tensor(d["syndrome_x"], dtype=torch.float32, device=device)
    sz = torch.as_tensor(d["syndrome_z"], dtype=torch.float32, device=device)
    cn_type = str(d["cn_type"])
    out = bp4_qc.bp4_qc_marginals(qc, llr, sx, sz, int(d["num_iter"]), cn_type, float(d["factor"]))
    for name, o in zip(("llrx", "llry", "llrz"), out):
        assert_llr_parity(o.cpu().numpy(), d[name].T, cn_type == "minsum", f"{case}:{name}")


@pytest.mark.parametrize("case", QC_GOLDENS)
def test_qc_plain_matches_tf_golden(case):
    before = obs.counter("k1.launches")
    check_qc_golden(case, torch.device("cpu"))
    assert obs.counter("k1.launches") == before  # CPU tensors take the plain version
