"""The bfloat16 message carry of the port's fused QC BP4 decode (its plain
version) against the JAX package's Pallas kernel with
``msg_dtype=jnp.bfloat16``, run in interpret mode, and the cascade with
``qc_msg_dtype="bfloat16"`` against JAX's.  The CUDA kernel is held bit for
bit against the plain version in tests/test_torch_gpu.py.

The carry rounds each CN output to bfloat16 (nearest even) where it is
stored, and nothing else.  The port's and JAX's float32 CN outputs differ
by a few float32 ulps at most, so a carried message differs only where the
two straddle a bfloat16 rounding boundary, and then by one bfloat16 ulp.
``check_carry`` holds the port to that:

* per sample, equal hard decisions, or the sample is tie-bound (a relative
  change of 1e-6 to its LLRs changes the port's own decision for it);
* at least CLOSE_SHARE of the marginals within 1e-6 relative of JAX's
  (measured on these inputs: 0.986 to 1.000; a carry that also rounds the
  VN extrinsics, rounds the final marginals once more, truncates instead
  of rounding to nearest even, or does not round: 0.001 to 0.344);
* after one iteration, every marginal within one bfloat16 ulp of each
  message it sums (its VN degree of them), plus 1e-6 relative.

The mutation tests run those variants of the plain version through the
same check, which must fail for each.
"""

import functools

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
from feedback_gnn_tpu_torch import obs
from feedback_gnn_tpu_torch.decoders import bp4_qc
from feedback_gnn_tpu_torch.decoders.bp4 import hard_decision
from feedback_gnn_tpu_torch.decoders.bp4_qc import bp4_decode_qc
from test_torch_cascade import SCHEDULE, gb48, one_torch_thread  # noqa: F401  (fixtures)

CODES = {
    # l=24, asymmetric shifts, degrees (8, 4)
    "gb48": lambda m: m.create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]),
    # the small GHP of tests/test_bp4_qc.py, l=7, degrees (6, 3)
    "ghp21": lambda m: m.create_QC_GHP_codes(7, m.create_cyclic_permuting_matrix(3, [2, 4, 0]), [0, 1, 3]),
}
RULES = [("boxplus-phi", None), ("boxplus", None), ("minsum", None)]
RESCUE_FORMS = [("boxplus-phi", "tf"), ("boxplus-phi", "accurate")]
B, FACTOR = 32, 0.9
CLOSE_SHARE, CLOSE_REL = 0.9, 1e-6
TIE_REL = 1e-6


@functools.lru_cache(maxsize=None)
def _pair(name):
    jcode, tcode = CODES[name](jc), CODES[name](tc)
    return jcode, tcode, j_qc_pair(jcode), tc.qc_pair_from_code(tcode)


@functools.lru_cache(maxsize=None)
def _inputs(name, seed=1):
    tcode = _pair(name)[1]
    rng = np.random.default_rng(seed)
    llr = (rng.standard_normal((3, tcode.N, B)) * 2.0).astype(np.float32)
    syn_x = rng.integers(0, 2, (tcode.hx.shape[0], B)).astype(np.float32)
    syn_z = rng.integers(0, 2, (tcode.hz.shape[0], B)).astype(np.float32)
    return llr, syn_x, syn_z


@functools.lru_cache(maxsize=None)
def _jax_marginals(name, iters, cn_type, phi_impl):
    """JAX's interpret-mode kernel with the bfloat16 carry (cached: the
    mutation tests reuse it)."""
    jqc = _pair(name)[2]
    llr, syn_x, syn_z = _inputs(name)
    out = j_bp4_qc_marginals(
        jqc, jnp.asarray(llr), jnp.asarray(syn_x), jnp.asarray(syn_z), num_iter=iters,
        cn_type=cn_type, normalization_factor=FACTOR, batch_tile=B, interpret=True,
        msg_dtype=jnp.bfloat16, phi_impl=phi_impl,
    )
    return tuple(torch.as_tensor(np.array(o)) for o in out)


def _port(name, iters, cn_type, phi_impl, msg_dtype="bfloat16", scale=1.0):
    """The port's marginals (CPU tensors: the plain version) and the
    messages of its last carry, the CN-frame planes (mx, mz)."""
    tqc = _pair(name)[3]
    llr, syn_x, syn_z = (torch.as_tensor(a) for a in _inputs(name))
    carried = []
    carry = bp4_qc._carry

    def recording(msg, dtype):
        out = carry(msg, dtype)
        carried.append(out)
        return out

    bp4_qc._carry = recording
    try:
        out = bp4_qc.bp4_qc_marginals(tqc, llr * scale, syn_x, syn_z, iters, cn_type, FACTOR,
                                      msg_dtype=msg_dtype, phi_impl=phi_impl)
    finally:
        bp4_qc._carry = carry
    return out, carried[-2:]


def bf16_ulp(t):
    """The spacing of bfloat16 numbers at |t| (8 significant bits)."""
    _, e = torch.frexp(t.abs())  # |t| = f * 2**e, f in [0.5, 1)
    return torch.ldexp(torch.ones_like(t), e - 8)


def _ulp_bound(name, carried):
    """Per marginal (x, y, z): the sum of one bfloat16 ulp of each message
    it adds up (x: the Hz side's, z: the Hx side's, y: both)."""
    tqc = _pair(name)[3]
    sides = []
    for msg, spec in zip(carried, (tqc.qx, tqc.qz)):
        idx = bp4_qc._side_index(spec, msg.device)
        sides.append(bp4_qc._vn_sums(bp4_qc._roll(bf16_ulp(msg), idx.to_vn), idx).reshape(tqc.n, -1))
    ux, uz = sides
    return uz, ux + uz, ux


def _decisions(out):
    x, z = hard_decision(*out)
    return torch.cat([x, z])


def check_carry(name, iters, cn_type, phi_impl, out, carried):
    ref = _jax_marginals(name, iters, cn_type, phi_impl)
    # per sample: equal decisions, or tie-bound
    differ = (_decisions(out) != _decisions(ref)).any(0).nonzero().flatten().tolist()
    if differ:
        base = _decisions(out)
        moved = torch.zeros(B, dtype=torch.bool)
        for f in (1.0 + TIE_REL, 1.0 - TIE_REL):
            moved |= (_decisions(_port(name, iters, cn_type, phi_impl, scale=f)[0]) != base).any(0)
        tight = [s for s in differ if not moved[s]]
        assert not tight, f"samples {tight} differ from JAX and are not tie-bound"
    # most marginals within float32 noise of JAX's
    close = torch.cat([((o - r).abs() <= CLOSE_REL * (1.0 + r.abs())).flatten() for o, r in zip(out, ref)])
    share = float(close.float().mean())
    assert share >= CLOSE_SHARE, f"only {share:.3f} of the marginals within {CLOSE_REL} of JAX's"
    if iters == 1:
        for o, r, bound in zip(out, ref, _ulp_bound(name, carried)):
            excess = (o - r).abs() - (bound + CLOSE_REL * (1.0 + r.abs()))
            assert float(excess.max()) <= 0.0, f"a marginal {float(excess.max()):.3e} beyond its ulp bound"
    return share


@pytest.mark.parametrize("iters", [1, 2, 8])
@pytest.mark.parametrize("cn_type,phi_impl", RULES)
@pytest.mark.parametrize("name", sorted(CODES))
def test_plain_carry_matches_jax(name, cn_type, phi_impl, iters):
    before = obs.counter("k1.launches")
    out, carried = _port(name, iters, cn_type, phi_impl)
    assert obs.counter("k1.launches") == before  # CPU tensors: the plain version, no kernel
    assert all(o.shape == (_pair(name)[1].N, B) and o.dtype == torch.float32 for o in out)
    # the carried messages are bfloat16 values in float32 slots
    assert all(torch.equal(m, m.to(torch.bfloat16).float()) for m in carried)
    check_carry(name, iters, cn_type, phi_impl, out, carried)


@pytest.mark.parametrize("cn_type,phi_impl", RESCUE_FORMS)
@pytest.mark.parametrize("name", sorted(CODES))
def test_rescue_forms_carry_matches_jax(name, cn_type, phi_impl):
    """The phi forms the rescue stage decodes with (tf, accurate)."""
    check_carry(name, 8, cn_type, phi_impl, *_port(name, 8, cn_type, phi_impl))


def _round_vn_extrinsics(monkeypatch):
    cn_plain = bp4_qc._cn_plain

    def mutant(msg, *args):
        return cn_plain(msg.to(torch.bfloat16).to(torch.float32), *args)

    monkeypatch.setattr(bp4_qc, "_cn_plain", mutant)


def _truncate(monkeypatch):
    def mutant(msg, dtype):  # toward zero: the low 16 bits dropped
        return (msg.view(torch.int32) & -65536).view(torch.float32)

    monkeypatch.setattr(bp4_qc, "_carry", mutant)


MUTANTS = ["vn_extrinsics_rounded", "marginals_rounded", "truncated", "not_rounded"]


@pytest.mark.parametrize("iters", [1, 8])
@pytest.mark.parametrize("cn_type,phi_impl", RULES)
@pytest.mark.parametrize("mutant", MUTANTS)
def test_check_fails_a_mutated_carry(monkeypatch, mutant, cn_type, phi_impl, iters):
    """A plain version that rounds at another point, rounds another way or
    not at all fails check_carry on GB-48: the check tells the semantics
    apart."""
    name = "gb48"
    if mutant == "vn_extrinsics_rounded":
        _round_vn_extrinsics(monkeypatch)
    elif mutant == "truncated":
        _truncate(monkeypatch)
    out, carried = _port(name, iters, cn_type, phi_impl,
                         msg_dtype="float32" if mutant == "not_rounded" else "bfloat16")
    if mutant == "marginals_rounded":
        out = tuple(o.to(torch.bfloat16).to(torch.float32) for o in out)
    with pytest.raises(AssertionError):
        check_carry(name, iters, cn_type, phi_impl, out, carried)


@pytest.mark.parametrize("name", sorted(CODES))
def test_carry_is_not_a_no_op(name):
    """The bfloat16 carry changes the marginals against float32's on the
    same inputs, and the messages it carries are bfloat16 values."""
    f32, _ = _port(name, 8, "boxplus-phi", None, msg_dtype="float32")
    bf16, carried = _port(name, 8, "boxplus-phi", None)
    moved = torch.cat([(a != b).flatten() for a, b in zip(f32, bf16)]).float().mean()
    assert float(moved) > 0.5
    f32_msgs = _port(name, 1, "boxplus-phi", None, msg_dtype="float32")[1]
    assert any(not torch.equal(m, m.to(torch.bfloat16).float()) for m in f32_msgs)


@pytest.mark.parametrize("name", sorted(CODES))
def test_decode_qc_carry_matches_jax(name):
    """bp4_decode_qc with the carry on the cascade's padded layouts: the
    decisions equal JAX's, the logits within the carry's check."""
    jcode, tcode, jqc, tqc = _pair(name)
    jg = JQuantumGraph.from_code(jcode, stage_mode=True)
    tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
    llr, syn_x, syn_z = _inputs(name, seed=2)
    ref = j_bp4_decode_qc(jg, jqc, jnp.asarray(llr), jnp.asarray(syn_x), jnp.asarray(syn_z), 8,
                          batch_tile=B, interpret=True, msg_dtype=jnp.bfloat16)
    out = bp4_decode_qc(tg, tqc, torch.as_tensor(llr), torch.as_tensor(syn_x), torch.as_tensor(syn_z),
                        8, msg_dtype="bfloat16")
    for field in ("x_hat", "z_hat"):
        np.testing.assert_array_equal(getattr(out, field).numpy(), np.asarray(getattr(ref, field)))
    for field in ("llrx", "llry", "llrz", "x_logit", "z_logit"):
        o, r = getattr(out, field), torch.as_tensor(np.asarray(getattr(ref, field)))
        assert o.shape == r.shape, field
        close = float(((o - r).abs() <= CLOSE_REL * (1.0 + r.abs())).float().mean())
        assert close >= CLOSE_SHARE, (field, close)


def test_rejects_unknown_msg_dtype():
    tqc = _pair("ghp21")[3]
    llr, syn_x, syn_z = (torch.as_tensor(a) for a in _inputs("ghp21"))
    for call in (bp4_qc.bp4_qc_marginals, bp4_qc.bp4_qc_marginals_plain):
        with pytest.raises(ValueError, match="msg_dtype"):
            call(tqc, llr, syn_x, syn_z, 2, msg_dtype="float16")


def test_cascade_carry_with_rescue_matches_jax(gb48):  # noqa: F811
    """The cascade on the QC backend with the carry and the chained rescue
    stage (tf, then accurate, whose K1 runs carry it too), on GB-48's
    injected noise: per-sample decisions equal to JAX's (or tie-bound),
    the same counts, no overflow."""
    cfg = dict(qc_msg_dtype="bfloat16", rescue_phi="tf,accurate", rescue_fraction=1.0, qc_batch_tile=8)
    ref, out = gb48.run_jax(**cfg), gb48.run_port(**cfg)
    gb48.assert_same_or_tie_bound(ref, out, **cfg)
    assert gb48.counts(*out[:2]) == gb48.counts(*ref[:2])
    assert int(out[2]) == int(ref[2]) == 0
    flagged, logical = gb48.counts(*out[:2])
    assert 0 < flagged < 64 and logical > 0


def test_gather_backend_ignores_the_carry(gb48):  # noqa: F811
    """qc=None: the gather decoder, where the field changes nothing (as in
    the JAX package)."""
    a = gb48.run_port(qc=False, qc_msg_dtype="bfloat16", cols=slice(0, 16))
    b = gb48.run_port(qc=False, cols=slice(0, 16))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_eval_step_with_the_carry(gb48):  # noqa: F811
    """sandwich_eval_step with qc_msg_dtype="bfloat16" counts the decode of
    its own noise with the carry."""
    from feedback_gnn_tpu_torch.channels import depolarizing_probs, pauli_iid
    from feedback_gnn_tpu_torch.decoders import cascade as tcas
    from feedback_gnn_tpu_torch.ops import mod2_matmul

    tg, b, p = gb48.tg, 32, 0.1
    cfg = tcas.CascadeConfig(**SCHEDULE, qc_msg_dtype="bfloat16")
    f, lg, ov = tcas.sandwich_eval_step(tg, [gb48.tparams], cfg, torch.Generator().manual_seed(5), p, b,
                                        qc=gb48.tqc, return_overflow=True)
    nx, nz = pauli_iid(torch.Generator().manual_seed(5), *depolarizing_probs(p), tg.n, b)
    pad = (0, 0, 0, tg.n_pad - tg.n)
    nx, nz = (torch.nn.functional.pad(t.to(torch.int32), pad) for t in (nx, nz))
    sx, sz = mod2_matmul(tg.hx, nz), mod2_matmul(tg.hz, nx)
    x, z = tcas.sandwich_decode(tg, [gb48.tparams], cfg, tcas.prior_llr(0.05, tg.n, b, tg.n_pad),
                                sx, sz, sz, sx, qc=gb48.tqc)
    xd, zd = nx ^ x, nz ^ z
    flagged = (torch.cat([mod2_matmul(tg.hz, xd), mod2_matmul(tg.hx, zd)]) != 0).any(0).sum()
    logical = (torch.cat([mod2_matmul(tg.hx_perp, xd), mod2_matmul(tg.hz_perp, zd)]) != 0).any(0).sum()
    assert (int(f), int(lg), int(ov)) == (int(flagged), int(logical), 0)
