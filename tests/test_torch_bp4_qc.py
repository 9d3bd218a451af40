"""The port's fused QC BP4 decode (its plain version) against the JAX
package's Pallas kernel run in interpret mode.  The CUDA kernel is held
against the plain version in tests/test_torch_gpu.py.

Tolerance: rtol = atol = 2e-3 on the marginals, the JAX suite's own for
kernel-versus-reference marginals (tests/test_bp4_qc.py).  Inputs are
non-degenerate random LLRs: under exactly uniform priors BP sits on
decision ties that ulp-level differences between math libraries can tip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.codes.qc import qc_pair_from_code as j_qc_pair
from feedback_gnn_tpu.decoders.bp4_qc import bp4_decode_qc as j_bp4_decode_qc
from feedback_gnn_tpu.decoders.bp4_qc import bp4_qc_marginals as j_bp4_qc_marginals

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.decoders import bp4_qc
from feedback_gnn_tpu_torch.decoders.bp4_qc import bp4_decode_qc, bp4_qc_marginals

TOL = dict(rtol=2e-3, atol=2e-3)

CODES = {
    # l=24, asymmetric shifts: a shift applied in the wrong direction shows
    "gb48": lambda m: m.create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]),
    # the small GHP of tests/test_bp4_qc.py, l=7
    "ghp21": lambda m: m.create_QC_GHP_codes(7, m.create_cyclic_permuting_matrix(3, [2, 4, 0]), [0, 1, 3]),
}

CASES = [
    ("boxplus-phi", None),
    ("boxplus-phi", "tf"),
    ("boxplus-phi", "accurate"),
    ("boxplus", None),
    ("minsum", None),
]


def _inputs(code, b, seed):
    rng = np.random.default_rng(seed)
    llr = (rng.standard_normal((3, code.N, b)) * 2.0).astype(np.float32)
    syn_x = rng.integers(0, 2, (code.hx.shape[0], b)).astype(np.float32)
    syn_z = rng.integers(0, 2, (code.hz.shape[0], b)).astype(np.float32)
    return llr, syn_x, syn_z


@pytest.fixture(scope="module", params=sorted(CODES))
def pair(request):
    name = request.param
    jcode, tcode = CODES[name](jc), CODES[name](tc)
    return name, jcode, tcode, j_qc_pair(jcode), tc.qc_pair_from_code(tcode)


@pytest.mark.parametrize("cn_type,phi_impl", CASES)
def test_plain_matches_jax_kernel(pair, cn_type, phi_impl):
    _, jcode, tcode, jqc, tqc = pair
    llr, syn_x, syn_z = _inputs(tcode, 32, 1)
    ref = j_bp4_qc_marginals(
        jqc, jnp.asarray(llr), jnp.asarray(syn_x), jnp.asarray(syn_z), num_iter=8,
        cn_type=cn_type, normalization_factor=0.9, batch_tile=32, interpret=True,
        phi_impl=phi_impl,
    )
    before = bp4_qc.launches
    out = bp4_qc_marginals(
        tqc, torch.as_tensor(llr), torch.as_tensor(syn_x), torch.as_tensor(syn_z), 8,
        cn_type, 0.9, phi_impl=phi_impl,
    )
    assert bp4_qc.launches == before  # the plain version launches no kernel
    for o, r in zip(out, ref):
        assert o.shape == (tcode.N, 32)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_decode_qc_matches_jax(pair):
    """Padded shapes, logits and decisions of bp4_decode_qc equal JAX's."""
    _, jcode, tcode, jqc, tqc = pair
    jg = JQuantumGraph.from_code(jcode, stage_mode=True)
    tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
    b = 32
    llr, syn_x, syn_z = _inputs(tcode, b, 2)
    ref = j_bp4_decode_qc(jg, jqc, jnp.asarray(llr), jnp.asarray(syn_x), jnp.asarray(syn_z),
                          8, batch_tile=32, interpret=True)
    out = bp4_decode_qc(tg, tqc, torch.as_tensor(llr), torch.as_tensor(syn_x),
                        torch.as_tensor(syn_z), 8)
    for name in ("llrx", "llry", "llrz", "x_logit", "z_logit"):
        o, r = getattr(out, name), np.asarray(getattr(ref, name))
        assert tuple(o.shape) == r.shape, name
        np.testing.assert_allclose(o.numpy(), r, err_msg=name, **TOL)
    for name in ("x_hat", "z_hat"):
        o, r = getattr(out, name), np.asarray(getattr(ref, name))
        assert o.dtype == torch.int32 and tuple(o.shape) == r.shape
        np.testing.assert_array_equal(o.numpy(), r, err_msg=name)


def test_rejects_unported_options(pair):
    _, _, tcode, _, tqc = pair
    llr, syn_x, syn_z = (torch.as_tensor(a) for a in _inputs(tcode, 4, 3))
    with pytest.raises(NotImplementedError):
        bp4_qc_marginals(tqc, llr, syn_x, syn_z, 2, msg_dtype="bfloat16")
    with pytest.raises(ValueError):
        bp4_qc_marginals(tqc, llr, syn_x, syn_z, 2, cn_type="sum-product")
    with pytest.raises(ValueError):
        bp4_qc_marginals(tqc, llr[:, :-1], syn_x, syn_z, 2)
