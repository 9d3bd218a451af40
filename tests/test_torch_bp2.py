"""The port's binary and quaternary gather decoders and the plain version of
its fused QC BP2 kernel (K2), against the JAX package and the TF goldens.

Inputs are made with numpy from a seed and given to both packages.
Tolerances:
* gather decoders against JAX: rtol = atol = 2e-3, the JAX suite's own for
  one BP formulation against another (tests/test_bp2_qc.py); the two run
  the same arithmetic and differ only by the libraries' last-ulp rounding;
* K2's plain version against JAX's interpret-mode kernel and against the
  port's gather decoder: rtol = atol = 2e-3 (tests/test_bp2_qc.py);
* TF goldens: ``assert_llr_parity`` and the tolerances of
  tests/test_bp4_parity.py;
* ``edge_weights=ones`` against unweighted: rtol 1e-6, as
  tests/test_discrete_channels.py.
Hard decisions are compared exactly wherever the logit is not within the
tolerance of 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.css import create_circulant_matrix as j_circulant
from feedback_gnn_tpu.codes.css import hamming_code as j_hamming_code
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.codes.graph import build_graph as j_build_graph
from feedback_gnn_tpu.codes.qc import detect_qc_structure as j_detect_qc
from feedback_gnn_tpu.decoders import cn_update as jcn
from feedback_gnn_tpu.decoders.bp2 import bp2_decode as j_bp2_decode
from feedback_gnn_tpu.decoders.bp2_qc import bp2_qc_logits as j_bp2_qc_logits
from feedback_gnn_tpu.decoders.bp4 import bp4_decode as j_bp4_decode
from test_bp4_parity import assert_llr_parity, load_case

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import obs
from feedback_gnn_tpu_torch.codes.graph import build_graph
from feedback_gnn_tpu_torch.codes.qc import detect_qc_structure
from feedback_gnn_tpu_torch.decoders import CN_UPDATES, bp2_decode, bp4_decode, cn_update_phi
from feedback_gnn_tpu_torch.decoders.bp2_qc import bp2_qc_logits, bp2_qc_logits_plain

TOL = dict(rtol=2e-3, atol=2e-3)
CN_TYPES = ["boxplus-phi", "boxplus", "minsum"]
GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
PCMS = {
    "surface3": lambda: np.asarray(jc.create_surface_codes(3).hx),
    "gb48": lambda: np.asarray(jc.create_generalized_bicycle_codes(*GB48).hx),
    "hamming15": lambda: np.asarray(j_hamming_code(4)),
}


def _graphs(name):
    pcm = PCMS[name]()
    return pcm, j_build_graph(pcm), build_graph(pcm).to("cpu")


def _assert_logits(out, ref, err_msg=""):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, err_msg=err_msg, **TOL)
    clear = np.abs(ref) > TOL["atol"] + TOL["rtol"] * np.abs(ref)
    np.testing.assert_array_equal(out[clear] > 0, ref[clear] > 0, err_msg=err_msg)


# ---- slot-major CN updates -------------------------------------------------


@pytest.mark.parametrize("cn_type,phi_impl", [
    ("boxplus-phi", None), ("boxplus-phi", "tf"), ("boxplus-phi", "accurate"),
    ("boxplus", None), ("minsum", None),
])
@pytest.mark.parametrize("code", ["surface3", "gb48"])
def test_cn_update_matches_jax(code, cn_type, phi_impl):
    pcm, jg, tg = _graphs(code)
    rng = np.random.default_rng(0)
    b = 16
    mask = np.asarray(jg.cn_mask)
    msg = (rng.standard_normal((jg.max_cn_deg, jg.c_pad, b)) * 4.0).astype(np.float32)
    msg *= mask[:, :, None]  # pad slots hold 0
    syn = (1.0 - 2.0 * rng.integers(0, 2, (jg.c_pad, b))).astype(np.float32)
    args = (jnp.asarray(msg), jnp.asarray(syn), jnp.asarray(mask))
    targs = (torch.as_tensor(msg), torch.as_tensor(syn), tg.cn_mask)
    if cn_type == "boxplus-phi":
        ref = jcn.cn_update_phi(*args, phi_impl)
        out = cn_update_phi(*targs, phi_impl)
    else:
        ref = jcn.CN_UPDATES[cn_type](*args)
        out = CN_UPDATES[cn_type](*targs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    pad = np.broadcast_to(mask[:, :, None] == 0, out.shape)
    assert pad.any() and (out.numpy()[pad] == 0.0).all()  # pad slots come out as exact zeros


# ---- gather BP2 --------------------------------------------------------------


@pytest.mark.parametrize("cn_type", CN_TYPES)
@pytest.mark.parametrize("mode", ["syndrome", "classical", "weighted"])
@pytest.mark.parametrize("code", ["surface3", "gb48"])
def test_bp2_decode_matches_jax(code, mode, cn_type):
    pcm, jg, tg = _graphs(code)
    rng = np.random.default_rng(1)
    b = 24
    llr = (rng.standard_normal((jg.num_vn, b)) * 3.0).astype(np.float32)
    syn = None if mode == "classical" else rng.integers(0, 2, (jg.num_cn, b)).astype(np.float32)
    w = None
    if mode == "weighted":
        w = (0.5 + rng.random((jg.max_vn_deg, jg.n_pad))).astype(np.float32)
    ref = j_bp2_decode(jg, jnp.asarray(llr), None if syn is None else jnp.asarray(syn), 8, cn_type,
                       0.9, edge_weights=None if w is None else jnp.asarray(w))
    out = bp2_decode(tg, torch.as_tensor(llr), None if syn is None else torch.as_tensor(syn), 8,
                     cn_type, 0.9, edge_weights=None if w is None else torch.as_tensor(w))
    assert out.logits.shape == (tg.n_pad, b) and out.hard.dtype == torch.int32
    _assert_logits(out.logits.numpy(), ref.logits)
    assert (out.logits[tg.num_vn:] == 0).all() and (out.hard[tg.num_vn:] == 0).all()
    assert out.ie_v is None and out.ie_c is None


def test_bp2_edge_weights_ones_match_unweighted():
    pcm, jg, tg = _graphs("hamming15")
    rng = np.random.default_rng(6)
    x = (rng.random((tg.num_vn, 64)) < 0.05).astype(np.float32)
    llr = torch.as_tensor(4.0 * (2.0 * x - 1.0))
    syn = torch.zeros((tg.num_cn, 64))
    base = bp2_decode(tg, llr, syn, 8)
    ones = torch.ones((tg.max_vn_deg, tg.n_pad))
    weighted = bp2_decode(tg, llr, syn, 8, edge_weights=ones)
    np.testing.assert_allclose(base.logits.numpy(), weighted.logits.numpy(), rtol=1e-6)


def test_bp2_edge_weights_carry_gradient():
    pcm, jg, tg = _graphs("hamming15")
    llr = torch.as_tensor(np.random.default_rng(7).standard_normal((tg.num_vn, 16)) * 3.0,
                          dtype=torch.float32)
    w = torch.ones((tg.max_vn_deg, tg.n_pad), requires_grad=True)
    out = bp2_decode(tg, llr, torch.zeros((tg.num_cn, 16)), 8, edge_weights=w)
    (out.logits ** 2).mean().backward()
    assert torch.isfinite(w.grad).all()
    assert float((w.grad.abs() * tg.vn_mask).sum()) > 0.0  # the gradient lives on true edges


@pytest.mark.parametrize("cn_type", CN_TYPES)
def test_bp2_exit_trajectory_matches_jax(cn_type):
    """All-zero syndrome, confident LLRs: the MI trajectories equal JAX's,
    start at 0, and grow towards 1."""
    pcm, jg, tg = _graphs("hamming15")
    llr = -6.0 * np.ones((tg.num_vn, 32), np.float32)
    syn = np.zeros((tg.num_cn, 32), np.float32)
    ref = j_bp2_decode(jg, jnp.asarray(llr), jnp.asarray(syn), 8, cn_type, track_exit=True)
    out = bp2_decode(tg, torch.as_tensor(llr), torch.as_tensor(syn), 8, cn_type, track_exit=True)
    for o, r in ((out.ie_v, ref.ie_v), (out.ie_c, ref.ie_c)):
        assert o.shape == (9,) and float(o[0]) == 0.0
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
        assert (o[1:] > 0.2).all() and (o <= 1.0).all()


@pytest.mark.parametrize("case", ["bp2_surface3_phi8.npz", "bp2_gb48_minsum8.npz"])
def test_bp2_matches_tf_golden(case):
    d = load_case(case)
    tg = build_graph(d["pcm"].astype(int)).to("cpu")
    res = bp2_decode(tg, torch.as_tensor(d["llr"]).T, torch.as_tensor(d["syndrome"], dtype=torch.float32),
                     int(d["num_iter"]), str(d["cn_type"]), float(d["factor"]))
    strict = str(d["cn_type"]) == "minsum"
    assert_llr_parity(res.logits[: tg.num_vn].numpy(), d["logits"].T, strict, case,
                      llr_mask_level=10.0, atol=1e-2)


# ---- gather BP4 --------------------------------------------------------------


def _quantum_graphs(hx, hz):
    jg = JQuantumGraph.from_code(jc.CSSCode(hx.astype(int), hz.astype(int)), stage_mode=True)
    tg = tc.QuantumGraph.from_code(tc.CSSCode(hx.astype(int), hz.astype(int)), stage_mode=True)
    return jg, tg.to("cpu")


@pytest.mark.parametrize("cn_type,phi_impl", [
    ("boxplus-phi", None), ("boxplus-phi", "tf"), ("boxplus-phi", "accurate"),
    ("boxplus", None), ("minsum", None),
])
def test_bp4_decode_matches_jax(cn_type, phi_impl):
    code = jc.create_generalized_bicycle_codes(*GB48)
    jg, tg = _quantum_graphs(np.asarray(code.hx), np.asarray(code.hz))
    rng = np.random.default_rng(2)
    b = 16
    llr = (rng.standard_normal((3, tg.n, b)) * 2.0).astype(np.float32)
    sx = rng.integers(0, 2, (code.hx.shape[0], b)).astype(np.float32)
    sz = rng.integers(0, 2, (code.hz.shape[0], b)).astype(np.float32)
    ref = j_bp4_decode(jg, jnp.asarray(llr), jnp.asarray(sx), jnp.asarray(sz), 8, cn_type, 0.9,
                       collect_logits=True, phi_impl=phi_impl)
    out = bp4_decode(tg, torch.as_tensor(llr), torch.as_tensor(sx), torch.as_tensor(sz), 8, cn_type,
                     0.9, collect_logits=True, phi_impl=phi_impl)
    for name in ("llrx", "llry", "llrz", "x_logit", "z_logit"):
        o, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, r, err_msg=name, **TOL)
    for name in ("x_hat", "z_hat"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    for o, r in zip(out.logit_stack, ref.logit_stack):
        assert o.shape == r.shape
        assert o.shape[0] == 9
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("case", [
    "bp4_surface3_phi8.npz", "bp4_gb48_phi8.npz", "bp4_gb48_minsum8.npz", "bp4_gb48_tanh4.npz",
])
def test_bp4_matches_tf_golden(case):
    d = load_case(case)
    _, tg = _quantum_graphs(d["hx"], d["hz"])
    strict = str(d["cn_type"]) == "minsum"
    res = bp4_decode(tg, torch.as_tensor(d["llr"]).permute(1, 2, 0),
                     torch.as_tensor(d["syndrome_x"], dtype=torch.float32),
                     torch.as_tensor(d["syndrome_z"], dtype=torch.float32),
                     int(d["num_iter"]), str(d["cn_type"]), float(d["factor"]))
    n, rx, rz = tg.n, tg.logit_rows_x.num_rows, tg.logit_rows_z.num_rows
    for name in ("llrx", "llry", "llrz"):
        assert_llr_parity(getattr(res, name)[:n].numpy(), d[name].T, strict, f"{case}:{name}")
    assert_llr_parity(res.x_logit[:rx].numpy(), d["x_logit"], False, f"{case}:x_logit",
                      llr_mask_level=8.0, atol=2e-2)
    assert_llr_parity(res.z_logit[:rz].numpy(), d["z_logit"], False, f"{case}:z_logit",
                      llr_mask_level=8.0, atol=2e-2)
    assert np.mean(res.x_hat[:n].numpy() == d["x_hat"].T) > 0.999
    assert np.mean(res.z_hat[:n].numpy() == d["z_hat"].T) > 0.999


def test_bp4_logit_stack_matches_tf_golden():
    d = load_case("bp4stack_gb48_phi6.npz")
    _, tg = _quantum_graphs(d["hx"], d["hz"])
    num_iter = int(d["num_iter"])
    res = bp4_decode(tg, torch.as_tensor(d["llr"]).permute(1, 2, 0),
                     torch.as_tensor(d["syndrome_x"], dtype=torch.float32),
                     torch.as_tensor(d["syndrome_z"], dtype=torch.float32),
                     num_iter, collect_logits=True)
    xs, zs = res.logit_stack
    assert xs.shape[0] == zs.shape[0] == num_iter + 1
    rx, rz = tg.logit_rows_x.num_rows, tg.logit_rows_z.num_rows
    ref = d["llr_hat"]  # [2*num_iter+2, R, B]: x at 2i, z at 2i+1
    for it in range(num_iter + 1):
        assert_llr_parity(xs[it][:rx].numpy(), ref[2 * it], False, f"x it={it}",
                          llr_mask_level=8.0, atol=2e-2)
        assert_llr_parity(zs[it][:rz].numpy(), ref[2 * it + 1], False, f"z it={it}",
                          llr_mask_level=8.0, atol=2e-2)


# ---- K2's plain version --------------------------------------------------------

QC_PCMS = {
    # [A | B] of 24-circulants: a (3,6)-regular binary QC code
    "lift24": (24, [0, 5, 11], [0, 3, 17]),
    # l=7: a lift that is not a multiple of 8
    "lift7": (7, [0, 2, 3], [0, 1, 5]),
}


def _qc_case(name, seed, b):
    lift, sa, sb = QC_PCMS[name]
    pcm = np.hstack([j_circulant(lift, sa), j_circulant(lift, sb)])
    rng = np.random.default_rng(seed)
    llr = (rng.standard_normal((pcm.shape[1], b)) * 3.0).astype(np.float32)
    syn = rng.integers(0, 2, (pcm.shape[0], b)).astype(np.float32)
    return pcm, lift, llr, syn


@pytest.mark.parametrize("cn_type", CN_TYPES)
@pytest.mark.parametrize("name", sorted(QC_PCMS))
def test_bp2_qc_plain_matches_jax_kernel(name, cn_type):
    pcm, lift, llr, syn = _qc_case(name, 3, 32)
    jspec, spec = j_detect_qc(pcm, lift), detect_qc_structure(pcm, lift)
    assert spec is not None and spec.groups == jspec.groups
    ref = j_bp2_qc_logits(jspec, jnp.asarray(llr), jnp.asarray(syn), num_iter=8, cn_type=cn_type,
                          normalization_factor=0.9, batch_tile=32, interpret=True)
    before = obs.counter("k2.launches")
    out = bp2_qc_logits(spec, torch.as_tensor(llr), torch.as_tensor(syn), 8, cn_type, 0.9)
    assert obs.counter("k2.launches") == before  # the plain version launches no kernel
    assert out.shape == (pcm.shape[1], 32)
    _assert_logits(out.numpy(), ref)


@pytest.mark.parametrize("cn_type", CN_TYPES)
@pytest.mark.parametrize("name", sorted(QC_PCMS))
def test_bp2_qc_plain_matches_gather(name, cn_type):
    """K2's plain version against the port's gather bp2_decode (expm1 phi
    against the kernel's tanh form: the same function)."""
    pcm, lift, llr, syn = _qc_case(name, 4, 16)
    spec = detect_qc_structure(pcm, lift)
    llr_t, syn_t = torch.as_tensor(llr), torch.as_tensor(syn)
    ref = bp2_decode(build_graph(pcm).to("cpu"), llr_t, syn_t, 5, cn_type, 0.9)
    out = bp2_qc_logits_plain(spec, llr_t, syn_t, 5, cn_type, 0.9)
    _assert_logits(out.numpy(), ref.logits[: pcm.shape[1]].numpy())


def test_bp2_qc_plain_matches_tf_golden():
    d = load_case("bp2_gb48_minsum8.npz")
    spec = detect_qc_structure(d["pcm"].astype(int), 24)
    out = bp2_qc_logits(spec, torch.as_tensor(d["llr"].T.copy()),
                        torch.as_tensor(d["syndrome"], dtype=torch.float32), int(d["num_iter"]),
                        str(d["cn_type"]), float(d["factor"]))
    assert_llr_parity(out.numpy(), d["logits"].T, True, "bp2_gb48_minsum8 on K2's plain version",
                      llr_mask_level=10.0, atol=1e-2)


def test_bp2_qc_rejects_bad_inputs():
    pcm, lift, llr, syn = _qc_case("lift7", 5, 4)
    spec = detect_qc_structure(pcm, lift)
    llr_t, syn_t = torch.as_tensor(llr), torch.as_tensor(syn)
    with pytest.raises(ValueError):
        bp2_qc_logits(spec, llr_t, syn_t, 2, cn_type="sum-product")
    with pytest.raises(ValueError):
        bp2_qc_logits(spec, llr_t[:-1], syn_t, 2)
    with pytest.raises(ValueError):
        bp2_qc_logits(spec, llr_t, syn_t[:-1], 2)
