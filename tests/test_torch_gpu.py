"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests carry the ``gpu`` mark and skip where no CUDA card is found.
They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance rtol = atol = 2e-3 on the marginals, the JAX suite's own for
kernel-versus-reference marginals; the TF goldens are held at
tests/test_bp4_parity.py's tolerances.  The probe kernels
(feedback_gnn_tpu_torch/probes.py) must equal their plain versions bit for
bit, phi within rtol = atol = 1e-5 (probes.PHI_TOL).
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import obs, probes
from feedback_gnn_tpu_torch.decoders import bp2_qc, bp4_qc
from test_bp4_parity import assert_llr_parity, load_case
from test_torch_qc_golden import QC_GOLDENS, check_qc_golden

CODES = {
    "gb48": lambda: tc.create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]),
    "ghp21": lambda: tc.create_QC_GHP_codes(7, tc.create_cyclic_permuting_matrix(3, [2, 4, 0]), [0, 1, 3]),
    "n882": tc.ghp_882_24,
}
BP2_CODES = {
    "gb48": CODES["gb48"],
    "n882": tc.ghp_882_24,
    "n1270": tc.ghp_1270_28,
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
    before = obs.counter("k1.launches")
    out = bp4_qc.bp4_qc_marginals(qc, llr, sx, sz, 16, cn_type, 0.9, phi_impl=phi_impl)
    assert obs.counter("k1.launches") == before + 1
    ref = bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, 16, cn_type, 0.9, phi_impl=phi_impl)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.is_cuda and o.shape == (qc.n, b)
        np.testing.assert_allclose(o.cpu().numpy(), r.cpu().numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("code", sorted(BP2_CODES))
@pytest.mark.parametrize("cn_type", ["boxplus-phi", "boxplus", "minsum"])
def test_bp2_qc_kernel_matches_plain(card, code, cn_type):
    spec = tc.qc_pair_from_code(BP2_CODES[code]()).qx  # the code's hx
    g = torch.Generator(device=card).manual_seed(5)
    b = 64
    n, m = spec.nb * spec.l, spec.mb * spec.l
    llr = torch.randn((n, b), generator=g, device=card) * 3.0
    syn = torch.randint(0, 2, (m, b), generator=g, device=card).float()
    before = obs.counter("k2.launches")
    out = bp2_qc.bp2_qc_logits(spec, llr, syn, 20, cn_type, 0.8)
    assert obs.counter("k2.launches") == before + 1
    ref = bp2_qc.bp2_qc_logits_plain(spec, llr, syn, 20, cn_type, 0.8)
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == (n, b)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
def test_bp2_qc_kernel_matches_tf_golden(card):
    d = load_case("bp2_gb48_minsum8.npz")
    spec = tc.detect_qc_structure(d["pcm"].astype(int), 24)
    llr = torch.as_tensor(d["llr"].T.copy(), device=card)
    syn = torch.as_tensor(d["syndrome"], dtype=torch.float32, device=card)
    out = bp2_qc.bp2_qc_logits(spec, llr, syn, int(d["num_iter"]), str(d["cn_type"]), float(d["factor"]))
    torch.cuda.synchronize()
    assert_llr_parity(out.cpu().numpy(), d["logits"].T, True, "bp2_gb48_minsum8 on K2",
                      llr_mask_level=10.0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", QC_GOLDENS)
def test_bp4_qc_kernel_matches_tf_golden(card, case):
    before = obs.counter("k1.launches")
    check_qc_golden(case, card)
    assert obs.counter("k1.launches") == before + 1


def _probe_cases(device):
    return {p.key: p for p in probes.probe_cases(probes.probe_inputs(device))}


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(_probe_cases("cpu")))
def test_probe_kernel_matches_plain(card, key):
    p = _probe_cases(card)[key]
    before = obs.counter(f"probe.{p.name}.launches")
    out = p.fn(*p.args)
    assert obs.counter(f"probe.{p.name}.launches") == before + 1
    ref = p.plain(*p.args)
    torch.cuda.synchronize()
    assert out.is_cuda
    probes.compare(p, out, ref)


# ragged shapes: rows not a multiple of a warp, an odd column count, a
# short, wide array (two rows, a block of one warp for each of 300000
# columns); fewer columns than a loop's cluster of 8 (1, 3); 8 k + 1
# columns; rows that do not divide by the loop's threads (1025 rows: 544
# threads x 2, 3001: 768 x 4)
RAGGED = [(1000, 37), (300, 531), (2, 300000), (1000, 1), (1000, 3), (1025, 17), (3001, 9)]


def _ragged_inputs(card, rows, cols, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((rows, cols), generator=g, device=card)
    perm = torch.randperm(rows, generator=g, device=card).to(torch.int32)
    idx = torch.randint(0, rows, (rows, cols), generator=g, device=card).to(torch.int32)
    return x, perm, idx


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", RAGGED)
def test_probe_gather_kernel_ragged(card, rows, cols):
    x, perm, idx = _ragged_inputs(card, rows, cols, 6)
    xt = x.T.contiguous()  # the gathered axis in lanes
    permt = torch.randperm(cols, device=card).to(torch.int32)
    cases = [
        (probes.take_rows, probes.take_rows_plain, (x, perm)),
        (probes.index_rows, probes.index_rows_plain, (x, perm)),
        (probes.take_along_rows, probes.take_along_rows_plain, (x, idx)),
        (probes.take_lanes, probes.take_lanes_plain, (x, permt)),
        (probes.take_along_lanes, probes.take_along_lanes_plain, (xt, idx.T.contiguous())),
        (probes.gather_loop, probes.gather_loop_plain, (x, perm, 5)),
        (probes.gather_loop, probes.gather_loop_plain, (x, perm, 2)),
        (probes.take_along_loop, probes.take_along_loop_plain, (x, idx, 5)),
        (probes.take_along_loop, probes.take_along_loop_plain, (x, idx, 2)),
    ]
    for fn, plain, args in cases:
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (fn.__name__, args[2:])


def _nan_gather(x, idx, axis):
    """The plain gather with an index outside [0, n) giving NaN: the
    kernels' rule (the plain versions refuse such an index)."""
    n = x.shape[axis]
    ok = (idx >= 0) & (idx < n)
    safe = idx.clamp(0, n - 1).long()
    if idx.dim() == 2:
        out = torch.gather(x, axis, safe)
        return torch.where(ok, out, torch.full_like(out, float("nan")))
    out = torch.index_select(x, axis, safe)
    keep = ok[:, None] if axis == 0 else ok[None, :]
    return torch.where(keep, out, torch.full_like(out, float("nan")))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(1000, 37), (3840, 128)])
def test_probe_gather_kernel_out_of_range_index(card, rows, cols):
    """Indices -1 and rows (past the end): NaN where the plain gather of the
    clamped index is masked to NaN, in the single passes and through the
    loops' iterations."""
    x, perm, idx = _ragged_inputs(card, rows, cols, 9)
    perm[[3, 500]] = torch.tensor([-1, rows], dtype=torch.int32, device=card)
    idx[7, 0], idx[9, cols - 1] = -1, rows
    xt, idxt = x.T.contiguous(), idx.T.contiguous()
    permt = torch.randperm(cols, device=card).to(torch.int32)
    permt[0] = cols
    cases = [
        (probes.take_rows, (x, perm), lambda: _nan_gather(x, perm, 0)),
        (probes.index_rows, (x, perm), lambda: _nan_gather(x, perm, 0)),
        (probes.take_along_rows, (x, idx), lambda: _nan_gather(x, idx, 0)),
        (probes.take_lanes, (x, permt), lambda: _nan_gather(x, permt, 1)),
        (probes.take_along_lanes, (xt, idxt), lambda: _nan_gather(xt, idxt, 1)),
    ]
    for fn, table in [(probes.gather_loop, perm), (probes.take_along_loop, idx)]:
        def ref(table=table, iters=3):
            acc = x
            for _ in range(iters):
                acc = _nan_gather(acc, table, 0) * probes.LOOP_SCALE
            return acc
        cases.append((fn, (x, table, 3), ref))
    for fn, args, ref in cases:
        out = fn(*args)
        want = ref()
        torch.cuda.synchronize()
        assert bool(torch.isnan(want).any()), fn.__name__
        torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True, msg=fn.__name__)


def _shift_plain(x, shift, length, iters, scale):
    """out[i] = x[(i + shift) mod length] for i < length, x[i] past it;
    ``iters`` times, each times ``scale``."""
    acc = x
    for _ in range(iters):
        acc = torch.cat([torch.roll(acc[:length], -shift, 0), acc[length:]]) * scale
    return acc


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", RAGGED)
def test_probe_shift_kernel_ragged(card, rows, cols):
    x, _, _ = _ragged_inputs(card, rows, cols, 7)
    cases = [
        (probes.roll_rows, probes.roll_rows_plain, (x,)),
        (probes.roll_loop, probes.roll_loop_plain, (x, 5)),
        (probes.roll_loop, probes.roll_loop_plain, (x, 2)),
    ]
    if rows >= probes.CIRC_LEN:
        cases.append((probes.circulant_copy, probes.circulant_copy_plain, (x,)))
    for fn, plain, args in cases:
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (fn.__name__, args[1:])
    # the shift kernel at other shifts, lengths and scales than the probes'
    for shift, length, iters, scale in [(-(rows + 5), rows, 1, 1.0), (3, max(1, rows // 3), 1, 1.0),
                                        (13, max(1, rows - 1), 1, 1.0), (7, rows, 5, 1.0001),
                                        (5, max(1, rows // 2), 3, 0.5)]:
        out = probes._launch_shift("roll_loop", x, shift, length, iters, scale)
        ref = _shift_plain(x, shift, length, iters, scale)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (shift, length, iters, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", [probes.phi_softplus_expm1, probes.phi_log_tanh, probes.phi_exp_log1p],
                         ids=lambda f: f.__name__)
def test_probe_phi_fast_mode(card, fn):
    """The fast transcendentals run and stay near phi; their error is
    reported by chip_smoke.py, not held to a tolerance."""
    x = probes.probe_inputs(card)["x_sub"]
    before = obs.counter(f"probe.{fn.__name__}.launches")
    out = fn(x, fast=True)
    torch.cuda.synchronize()
    assert obs.counter(f"probe.{fn.__name__}.launches") == before + 1
    assert bool(torch.isfinite(out).all())
    assert float((out.double() - probes.phi_reference(x)).abs().max()) < 1.0



PHI_FNS = [probes.phi_softplus_expm1, probes.phi_log_tanh, probes.phi_exp_log1p]
# (rows, cols, offset in floats into a flat buffer): fewer floats than a
# float4, one float4 and a tail, n % 4 = 1 and 3, a short, wide array; and
# contiguous views 4, 8 and 12 bytes into their buffer (not 16-byte
# aligned: a float at a time)
PHI_RAGGED = [(1, 1, 0), (1, 3, 0), (1, 4, 0), (1, 5, 0), (517, 17, 0), (2, 300001, 0), (3840, 128, 1),
              (3840, 128, 2), (1000, 37, 3), (1, 4, 1)]


def _phi_input(card, rows, cols, offset, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(rows * cols + offset, generator=g, device=card)[offset:].view(rows, cols)


def _check_phi(fn, x, plan):
    """fn's accurate kernel launched ``plan`` and is within PHI_TOL of the
    plain version; the fast one stays near float64 phi."""
    out = fn(x)
    assert probes.phi_last_launch() == plan
    ref = getattr(probes, fn.__name__ + "_plain")(x)
    fast = fn(x, fast=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **probes.PHI_TOL)
    assert bool(torch.isfinite(fast).all())
    assert float((fast.double() - probes.phi_reference(x)).abs().max()) < 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("fn", PHI_FNS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("rows,cols,offset", PHI_RAGGED)
def test_probe_phi_kernel_ragged_and_misaligned(card, fn, rows, cols, offset):
    x = _phi_input(card, rows, cols, offset, rows + cols + offset)
    aligned = x.data_ptr() % 16 == 0
    assert aligned == (offset == 0)
    _check_phi(fn, x, probes._phi_plan(x.numel(), probes._sms(x.device.index), aligned))


@pytest.mark.gpu
@pytest.mark.parametrize("fn", PHI_FNS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("rows,cols", [(3840, 128), (3840, 8192)])
def test_probe_phi_kernel_runs_its_plan(card, fn, rows, cols):
    """The probe and the throughput shape launch _phi_plan's shape; every
    other shape of the card's plan grid, and a one-block grid, agree too."""
    x = _phi_input(card, rows, cols, 0, 5)
    sms = probes._sms(x.device.index)
    _check_phi(fn, x, probes._phi_plan(x.numel(), sms))
    form = fn.__name__[len("phi_"):]
    ref = getattr(probes, fn.__name__ + "_plain")(x)
    for pt in probes.PHI_PER_THREAD:
        for threads in (32, 128, 512):
            for plan in (probes._phi_plan(x.numel(), sms, True, pt, threads),
                         probes.PhiPlan(True, pt, threads, 1)):
                out = probes._launch_phi(fn.__name__, x, form, False, plan)
                assert probes.phi_last_launch() == plan
                torch.cuda.synchronize()
                torch.testing.assert_close(out, ref, **probes.PHI_TOL)


@pytest.mark.gpu
def test_probe_phi_kernel_refuses_a_misaligned_float4_plan(card):
    x = _phi_input(card, 4, 4, 1, 3)
    with pytest.raises(RuntimeError, match="launch failed"):
        probes._launch_phi("phi_log_tanh", x, "log_tanh", False, probes.PhiPlan(True, 1, 256, 1))


# The redesigned K1/K2: bit for bit against their plain versions on the
# specialised instances ((6, 3): the GHP codes; (8, 4): GB-48) and on the
# generic one (reached through the launch plan's instance override), in
# both launch regimes (n882 at B=3 small, B=2000 large) and on ragged
# batches (B=1, 5, 257: not a multiple of the samples per block).
EXACT_SHAPES = [("n882", 3), ("n882", 2000), ("n882", 1), ("n882", 257), ("gb48", 257), ("ghp21", 5)]


def _qc_inputs(qc, b, card, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    llr = torch.randn((3, qc.n, b), generator=g, device=card) * 2.0
    sx = torch.randint(0, 2, (qc.qx.mb * qc.l, b), generator=g, device=card).float()
    sz = torch.randint(0, 2, (qc.qz.mb * qc.l, b), generator=g, device=card).float()
    return llr, sx, sz


def _k1_exact(qc, llr, sx, sz, iters, plan, cases, msg_dtype="float32"):
    for cn_type, phi_impl in cases:
        before = obs.counter("k1.launches")
        out = bp4_qc._launch_kernel(qc, llr, sx, sz, iters, cn_type, 0.9, phi_impl, plan, msg_dtype)
        assert obs.counter("k1.launches") == before + 1
        ref = bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, iters, cn_type, 0.9, phi_impl=phi_impl,
                                            msg_dtype=msg_dtype)
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            assert torch.equal(o, r), (cn_type, phi_impl, msg_dtype, plan, float((o - r).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("generic", [False, True], ids=["specialised", "generic"])
@pytest.mark.parametrize("code,batch", EXACT_SHAPES)
def test_bp4_qc_kernel_bit_exact(card, code, batch, generic):
    qc = tc.qc_pair_from_code(CODES[code]())
    plan = bp4_qc._launch_plan(qc, batch, instance=(0, 0) if generic else None)
    assert (plan.instance == (0, 0)) == generic
    if code == "n882":
        assert plan.regime == ("large" if batch == 2000 else "small")
    _k1_exact(qc, *_qc_inputs(qc, batch, card, 8), 12, plan, CASES)


@pytest.mark.gpu
def test_bp4_qc_kernel_bit_exact_bench_prepass(card):
    """[[1270,28]] at the bench prepass's B=20480 x 12, large regime."""
    qc = tc.qc_pair_from_code(tc.ghp_1270_28())
    plan = bp4_qc._launch_plan(qc, 20480)
    assert plan.regime == "large"
    _k1_exact(qc, *_qc_inputs(qc, 20480, card, 9), 12, plan, CASES[:1])


# The bfloat16 message carry: every instance (CN rule, phi form, degree
# pair) bit for bit against the plain version with msg_dtype="bfloat16", in
# both launch regimes and on ragged batches, as the float32 carry above.
@pytest.mark.gpu
@pytest.mark.parametrize("generic", [False, True], ids=["specialised", "generic"])
@pytest.mark.parametrize("code,batch", EXACT_SHAPES)
def test_bp4_qc_bf16_carry_bit_exact(card, code, batch, generic):
    qc = tc.qc_pair_from_code(CODES[code]())
    plan = bp4_qc._launch_plan(qc, batch, instance=(0, 0) if generic else None)
    assert (plan.instance == (0, 0)) == generic
    _k1_exact(qc, *_qc_inputs(qc, batch, card, 13), 12, plan, CASES, msg_dtype="bfloat16")


@pytest.mark.gpu
def test_bp4_qc_bf16_carry_through_the_wrapper(card):
    """bp4_qc_marginals with the carry on the card: one launch, the plain
    version's bits, and other bits than the float32 carry's."""
    qc = tc.qc_pair_from_code(tc.ghp_882_24())
    llr, sx, sz = _qc_inputs(qc, 256, card, 14)
    before = obs.counter("k1.launches")
    out = bp4_qc.bp4_qc_marginals(qc, llr, sx, sz, 16, msg_dtype="bfloat16")
    assert obs.counter("k1.launches") == before + 1
    ref = bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, 16, msg_dtype="bfloat16")
    f32 = bp4_qc.bp4_qc_marginals(qc, llr, sx, sz, 16)
    torch.cuda.synchronize()
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert not all(torch.equal(o, r) for o, r in zip(out, f32))


@pytest.mark.gpu
@pytest.mark.parametrize("phi_impl", [None, "tf", "accurate"])
def test_bp4_qc_bf16_carry_bit_exact_large(card, phi_impl):
    """The carry at the bench prepass's [[1270,28]] B=20480 x 12 (large
    regime) and the rescue's tf and accurate instances at [[882,24]] B=512."""
    if phi_impl is None:
        qc = tc.qc_pair_from_code(tc.ghp_1270_28())
        batch = 20480
    else:
        qc, batch = tc.qc_pair_from_code(tc.ghp_882_24()), 512
    plan = bp4_qc._launch_plan(qc, batch)
    _k1_exact(qc, *_qc_inputs(qc, batch, card, 15), 12, plan, [("boxplus-phi", phi_impl)],
              msg_dtype="bfloat16")


def _k2_exact(spec, llr, syn, iters, plan, cn_types):
    for cn_type in cn_types:
        before = obs.counter("k2.launches")
        out = bp2_qc._launch_kernel(spec, llr, syn, iters, cn_type, 0.8, plan)
        assert obs.counter("k2.launches") == before + 1
        ref = bp2_qc.bp2_qc_logits_plain(spec, llr, syn, iters, cn_type, 0.8)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (cn_type, plan, float((out - ref).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("generic", [False, True], ids=["specialised", "generic"])
@pytest.mark.parametrize("code,batch", EXACT_SHAPES)
def test_bp2_qc_kernel_bit_exact(card, code, batch, generic):
    spec = tc.qc_pair_from_code(CODES[code]()).qx
    g = torch.Generator(device=card).manual_seed(10)
    n, m = spec.nb * spec.l, spec.mb * spec.l
    llr = torch.randn((n, batch), generator=g, device=card) * 3.0
    syn = torch.randint(0, 2, (m, batch), generator=g, device=card).float()
    for cn_type in ("boxplus-phi", "boxplus", "minsum"):
        plan = bp2_qc._launch_plan(spec, batch, cn_type, instance=(0, 0) if generic else None)
        _k2_exact(spec, llr, syn, 30, plan, [cn_type])


@pytest.mark.gpu
def test_bp2_qc_kernel_bit_exact_bp2_path(card):
    """[[882,24]]'s hx at the bp2_path's B=20480 x 100 minsum, large regime."""
    spec = tc.qc_pair_from_code(tc.ghp_882_24()).qx
    g = torch.Generator(device=card).manual_seed(11)
    llr = torch.randn((spec.nb * spec.l, 20480), generator=g, device=card) * 3.0
    syn = torch.randint(0, 2, (spec.mb * spec.l, 20480), generator=g, device=card).float()
    plan = bp2_qc._launch_plan(spec, 20480, "minsum")
    assert plan.regime == "large"
    _k2_exact(spec, llr, syn, 100, plan, ["minsum"])


@pytest.mark.gpu
def test_qc_occupancy_reported(card):
    """The runtime's occupancy of the main path's and the bench's K1 plans
    and the bp2_path's K2 plan: at least one block resident, no spills."""
    for make, batch in [(tc.ghp_882_24, 256), (tc.ghp_1270_28, 20480)]:
        qc = tc.qc_pair_from_code(make())
        plan = bp4_qc._launch_plan(qc, batch)
        blocks, regs, spill = bp4_qc._occupancy(qc, "boxplus-phi", None, plan)
        assert blocks >= 1 and regs <= bp4_qc.K1_REGS and spill == 0, (batch, blocks, regs, spill)
    spec = tc.qc_pair_from_code(tc.ghp_882_24()).qx
    plan = bp2_qc._launch_plan(spec, 20480, "minsum")
    blocks, regs, spill = bp2_qc._occupancy(spec, "minsum", plan)
    assert blocks >= 1 and regs <= 40 and spill == 0, (blocks, regs, spill)


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [64, 16])
@pytest.mark.parametrize("phi_impl", ["tf", "accurate"])
def test_bp4_qc_rescue_instances_bit_exact(card, phi_impl, iters):
    """K1's tf and accurate instances at the rescue stage's shape: [[882,24]]
    at B=512 (rescue_fraction 0.02 of 20480, tile-rounded), the stage's
    64- and 16-iteration runs."""
    qc = tc.qc_pair_from_code(tc.ghp_882_24())
    plan = bp4_qc._launch_plan(qc, 512)
    _k1_exact(qc, *_qc_inputs(qc, 512, card, 12), iters, plan, [("boxplus-phi", phi_impl)])


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [3, 0], ids=["tied", "continuous"])
@pytest.mark.parametrize("side", ["hx_basis", "hz_basis"])
def test_osd0_on_card_equals_cpu(card, side, levels):
    """osd0_decode on the card equals osd0_decode on the CPU bit for bit on
    [[882,24]]'s bases, with LLRs drawn from a few values (mostly tied) or
    continuous."""
    from feedback_gnn_tpu_torch.decoders.osd import osd0_decode

    basis = np.asarray(getattr(tc.ghp_882_24(), side))
    rank, n = basis.shape
    rng = np.random.default_rng(13 + levels)
    b = 48
    if levels:
        llr = rng.normal(size=levels).astype(np.float32)[rng.integers(0, levels, (b, n))]
    else:
        llr = rng.normal(size=(b, n)).astype(np.float32)
    syn = torch.as_tensor(basis @ rng.integers(0, 2, (n, b)) % 2)
    cpu = osd0_decode(torch.as_tensor(llr), basis, syn)
    out = osd0_decode(torch.as_tensor(llr, device=card), basis, syn.to(card))
    assert out.is_cuda and torch.equal(out.cpu(), cpu)
    assert np.array_equal(basis @ cpu.numpy().T % 2, syn.numpy())


OSD_BASES = [("n882", "hx_basis"), ("n882", "hz_basis"), ("n1270", "hx_basis")]
OSD_CODES = {"n882": tc.ghp_882_24, "n1270": tc.ghp_1270_28}
_OSD_POOLS = {}


def _osd_code(name):
    key = ("code", name)
    if key not in _OSD_POOLS:
        _OSD_POOLS[key] = OSD_CODES[name]()
    return _OSD_POOLS[key]


def _k1_reliabilities(code, side, b, card, seed):
    """BP4 min-sum 0.8 x 100 on K1 at p = 0.10, as the BP+OSD cell decodes:
    the binary reliabilities [b, n] and pivot-reduced syndromes [rank, b]
    that OSD takes on ``side``'s basis."""
    from feedback_gnn_tpu_torch.channels.pauli import depolarizing_probs, pauli_iid
    from feedback_gnn_tpu_torch.decoders.bp4 import quaternary_to_binary_llrs
    from feedback_gnn_tpu_torch.decoders.cascade import prior_llr
    from feedback_gnn_tpu_torch.ops.gf2mat import mod2_matmul

    qc = tc.qc_pair_from_code(code)
    n = code.hx.shape[1]
    noise_x, noise_z = pauli_iid(torch.Generator(device=card).manual_seed(seed), *depolarizing_probs(0.10), n, b)
    sx = mod2_matmul(torch.as_tensor(code.hx, device=card), noise_z)
    sz = mod2_matmul(torch.as_tensor(code.hz, device=card), noise_x)
    llrx, llry, llrz = bp4_qc.bp4_qc_marginals(qc, prior_llr(0.10, n, b, device=card), sx, sz, 100, "minsum", 0.8)
    rel_x, rel_z = quaternary_to_binary_llrs(llrx, llry, llrz)
    if side == "hx_basis":
        return rel_z.T.contiguous(), sx[torch.as_tensor(code.pivot_hx, device=card)]
    return rel_x.T.contiguous(), sz[torch.as_tensor(code.pivot_hz, device=card)]


def _osd_pool(name, side, kind, b, card):
    """``b`` samples of one kind on the card (cached), and the plain
    version's solutions on the CPU of the samples ``_osd_checked`` names
    for any batch up to ``b``: reliabilities tied at three levels with
    -0.0 and +0.0 both at the middle one, continuous, or K1's at p = 0.10."""
    key = (name, side, kind, b)
    if key not in _OSD_POOLS:
        from feedback_gnn_tpu_torch.decoders.osd import osd0_decode_plain

        code = _osd_code(name)
        basis = np.asarray(getattr(code, side))
        rank, n = basis.shape
        rng = np.random.default_rng([ord(c) for c in f"{name}{side}{kind}{b}"])
        if kind == "k1":
            llr, syn = _k1_reliabilities(code, side, b, card, seed=21)
        else:
            if kind == "tied":
                llr = np.asarray([-0.0, 0.0, 1.5, -2.0], np.float32)[rng.choice(4, (b, n), p=[.25, .25, .3, .2])]
            else:
                llr = rng.normal(size=(b, n)).astype(np.float32)
            syn = torch.as_tensor((basis @ rng.integers(0, 2, (n, b)) % 2).astype(np.int32), device=card)
            llr = torch.as_tensor(llr, device=card)
        idx = _osd_checked(b)
        cpu = osd0_decode_plain(llr[idx].cpu(), basis, syn[:, idx].cpu())
        _OSD_POOLS[key] = (basis, llr, syn, idx, cpu)
    return _OSD_POOLS[key]


def _osd_checked(b):
    """The samples of a batch of ``b`` held to the CPU: the first 37 and 27
    spread to the last (each sample's elimination is its own)."""
    return np.unique(np.concatenate([np.arange(min(b, 37)), np.linspace(0, b - 1, 27).astype(np.int64)]))


def _osd_kernel_vs_cpu(basis, llr, syn, idx, cpu, call=None):
    """One kernel call on the card against the CPU's plain solutions of
    ``idx``; every solution of the call against the basis; one launch."""
    from feedback_gnn_tpu_torch.decoders.osd import osd0_decode
    from feedback_gnn_tpu_torch.ops.gf2mat import mod2_matmul

    b = llr.shape[0]
    obs.reset()
    out = (call or osd0_decode)(llr, basis, syn)
    torch.cuda.synchronize()
    assert obs.snapshot()["keys"].get("osd.launches") == {("kernel", b): 1}
    assert out.is_cuda and out.shape == (b, basis.shape[1]) and out.dtype == torch.int32
    keep = idx[idx < b]
    assert torch.equal(out[torch.as_tensor(keep, device=out.device)].cpu(), cpu[:keep.size])
    assert torch.equal(mod2_matmul(torch.as_tensor(basis, device=out.device), out.T), syn.to(torch.int32))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["tied", "continuous", "k1"])
@pytest.mark.parametrize("b", [1, 37, 1024])
@pytest.mark.parametrize("name,side", OSD_BASES)
def test_osd0_kernel_equals_plain(card, name, side, b, kind):
    """The OSD-0 kernel (csrc/osd0.cu) equals osd0_decode_plain on the CPU
    bit for bit on both [[882,24]] bases and a [[1270,28]] basis, at 1, 37
    and 1024 samples (the BP+OSD cell's sub-batch), on tied, continuous and
    K1's reliabilities; every solution meets its syndrome."""
    basis, llr, syn, idx, cpu = _osd_pool(name, side, kind, 1024, card)
    _osd_kernel_vs_cpu(basis, llr[:b], syn[:, :b], idx, cpu)


@pytest.mark.gpu
def test_osd0_kernel_equals_plain_on_the_whole_batch(card):
    """B = 20480, the BP2 path's call without a cap (a block a sample)."""
    basis, llr, syn, idx, cpu = _osd_pool("n882", "hx_basis", "tied", 20480, card)
    _osd_kernel_vs_cpu(basis, llr, syn, idx, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("name,side", OSD_BASES[1:])
def test_osd0_kernel_takes_transposed_reliabilities(card, name, side):
    """``models.py`` hands OSD the transpose of its [n, B] reliabilities."""
    basis, llr, syn, idx, cpu = _osd_pool(name, side, "k1", 1024, card)
    flipped = llr.T.contiguous().T
    assert not flipped.is_contiguous()
    _osd_kernel_vs_cpu(basis, flipped, syn, idx, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["tied", "k1"])
def test_osd0_kernel_under_the_unstable_sort_fault(card, kind):
    """The benchmark's fault ``unstable_sort``: the columns flipped, a card
    basis, solved and flipped back, against the same call on the CPU."""
    from feedback_gnn_tpu_torch.decoders.osd import osd0_decode, osd0_decode_plain

    basis, llr, syn, idx, _ = _osd_pool("n882", "hz_basis", kind, 1024, card)

    def flipped(fn, l, s):
        pcm = torch.as_tensor(basis, device=l.device)
        return fn(l.flip(-1), pcm.flip(-1), s).flip(-1)

    cpu = flipped(osd0_decode_plain, llr[idx].cpu(), syn[:, idx].cpu())
    _osd_kernel_vs_cpu(basis, llr, syn, idx, cpu, call=lambda l, b_, s: flipped(osd0_decode, l, s))
    plain = osd0_decode_plain(llr[idx].cpu(), basis, syn[:, idx].cpu())
    if kind == "tied":  # reversed ties change some solutions: the fault shows
        assert not torch.equal(cpu, plain)


@pytest.mark.gpu
def test_osd0_kernel_shape_and_occupancy(card):
    """The library's shared-memory bytes equal the wrapper's; [[882,24]]
    keeps 4 blocks an SM, [[1270,28]] 2, without spills; a shape above
    227 KB raises before any launch."""
    from feedback_gnn_tpu_torch._build import load_kernels
    from feedback_gnn_tpu_torch.decoders.osd import osd0_decode, shared_bytes

    lib = load_kernels()
    for rank, n in [(429, 882), (621, 1270), (20, 48), (1, 1), (1000, 2047), (1100, 1500)]:
        want = shared_bytes(rank, n) if shared_bytes(rank, n) <= 232448 and (n + 32) // 32 <= 64 else -3
        assert lib.fgt_osd0_shared_bytes(n, rank) == want, (rank, n)
    for (rank, n), blocks in [((429, 882), 4), ((621, 1270), 2)]:
        occ = (ctypes.c_int * 3)()
        assert lib.fgt_osd0_occupancy(n, rank, occ) == 0
        assert (occ[0], occ[2]) == (blocks, 0), list(occ)
    big = np.zeros((1400, 1270), np.int32)
    obs.reset()
    with pytest.raises(ValueError, match="shared memory"):
        osd0_decode(torch.zeros((2, 1270), device=card), big, torch.zeros((1400, 2), dtype=torch.int32, device=card))
    assert obs.snapshot()["keys"].get("osd.launches") is None


# ---- training: the K1 miners and the train step --------------------------------


@pytest.fixture(scope="module")
def n882_training():
    from feedback_gnn_tpu_torch.entry import load_code

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return load_code("n882", torch.device("cuda")), tc.ghp_882_24()


def _plain_k1(monkeypatch):
    """K1's wrapper replaced by its plain version on the card's tensors."""
    def plain(qc, llr, sx, sz, num_iter, cn_type="boxplus-phi", factor=1.0, msg_dtype="float32",
              phi_impl=None):
        return bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, num_iter, cn_type, factor, phi_impl)

    monkeypatch.setattr(bp4_qc, "bp4_qc_marginals", plain)


def _miner(kind, graph, qc, device):
    from feedback_gnn_tpu_torch.config import CODE_REGISTRY
    from feedback_gnn_tpu_torch.decoders import load_weights
    from feedback_gnn_tpu_torch.train import make_bp_failure_miner, make_cascade_failure_miner

    if kind == "easy":
        return make_bp_failure_miner(graph, num_iter=64, wt_max=60, compact_cap=2048, qc=qc)
    coarse = load_weights(CODE_REGISTRY["n882"]["coarse_weights"], device)
    return make_cascade_failure_miner(graph, coarse, num_iter1=64, num_iter2=64, wt_max=60, compact_cap=2048,
                                      qc=qc)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,batch,launches", [("easy", 2048, 1), ("hard", 1024, 2)])
def test_k1_miner_matches_plain(card, n882_training, monkeypatch, kind, batch, launches):
    """The K1 miners of the curriculum (wt 40, 64 iterations, compacted to
    2048 columns) keep the same samples and columns as on K1's plain
    version, bit for bit, with one K1 launch per BP run."""
    (graph, qc, _), _ = n882_training
    miner = _miner(kind, graph, qc, card)
    nx, nz = miner.sample(torch.Generator(device=card).manual_seed(21), 40, batch)
    before = obs.counter("k1.launches")
    out = miner.body(nx, nz)
    assert obs.counter("k1.launches") == before + launches
    _plain_k1(monkeypatch)
    ref = miner.body(nx, nz)
    torch.cuda.synchronize()
    assert out[0].is_cuda and out[0].dtype == torch.uint8
    assert int(out[2]) == int(ref[2])
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(card, n882_training):
    """One train step's loss (rtol 1e-4) and gradient leaves (relative L2
    error <= 1e-3) on the card against the CPU, at tests/test_training.py's
    16/8 schedule on B=100 failures mined at wt 60, from the shipped
    weights.  Stage 2 on the CPU is fed the card's stage-1 features: the
    mined samples are those BP does not converge on, and from the uniform
    prior their stage-1 trajectories carry ulp differences between the two
    devices' math libraries to O(1) differences in saturated marginals,
    and to other hard decisions (ROADMAP C)."""
    from feedback_gnn_tpu_torch.codes import QuantumGraph
    from feedback_gnn_tpu_torch.config import CODE_REGISTRY
    from feedback_gnn_tpu_torch.decoders import load_weights, params_from_numpy
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
    from feedback_gnn_tpu_torch.train import TrainConfig
    from feedback_gnn_tpu_torch.train.trainer import stage_one_features, stage_two_loss

    (graph, qc, _), code = n882_training
    out = _miner("easy", graph, qc, card)(torch.Generator(device=card).manual_seed(21), 60, 8192)
    assert int(out[2]) >= 100
    nx, nz = (t[:, :100].to(torch.float32) for t in out[:2])
    cfg = TrainConfig(num_iter1=16, num_iter2=8, loss_from=4)
    shipped = load_weights(CODE_REGISTRY["n882"]["weights"], "cpu")
    cpu_graph = QuantumGraph.from_code(code, stage_mode=True).to("cpu")

    def grads(g, device, x, z, feats=None):
        params = params_from_numpy(shipped, device)
        for leaf in flatten_with_paths(params).values():
            leaf.requires_grad_(True)
        feats = feats if feats is not None else stage_one_features(g, cfg, x, z)
        loss, _ = stage_two_loss(params, g, cfg, x, z, *feats)
        loss.backward()
        return loss.item(), {k: v.grad.cpu() for k, v in flatten_with_paths(params).items()}, feats

    on_card = grads(graph, card, nx, nz)
    assert all(f.is_cuda and bool(torch.isfinite(f).all()) for f in on_card[2])
    on_cpu = grads(cpu_graph, "cpu", nx.cpu(), nz.cpu(), [f.cpu() for f in on_card[2]])
    np.testing.assert_allclose(on_card[0], on_cpu[0], rtol=1e-4)
    for key, g in on_cpu[1].items():
        assert float((on_card[1][key] - g).norm() / g.norm()) <= 1e-3, key


# ---- GNN_BP4: card against CPU at full width ------------------------------------


@pytest.fixture(scope="module")
def gnn_bp4_n882():
    """{device: (graph, row sets, shipped trained params, cfg)} for [[882,24]]."""
    from feedback_gnn_tpu_torch.decoders.gnn_full import load_shipped, make_logit_rowsets

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    host = tc.QuantumGraph.from_code(tc.ghp_882_24(), stage_mode=True)
    return {dev: (host.to(dev), make_logit_rowsets(host, dev), *load_shipped("n882", dev))
            for dev in ("cuda", "cpu")}


def _pauli(n, batch, p, seed):
    from feedback_gnn_tpu_torch.channels.pauli import depolarizing_probs, pauli_iid

    return pauli_iid(torch.Generator().manual_seed(seed), *depolarizing_probs(p), n, batch)


def _ulp_moved(params, seed):
    """A copy of the parameter tree with each entry moved by -1, 0 or +1 ulp."""
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths

    gen = torch.Generator().manual_seed(seed)
    moved = copy.deepcopy(params)
    with torch.no_grad():
        for leaf in flatten_with_paths(moved).values():
            leaf.mul_(1 + (torch.randint(0, 3, leaf.shape, generator=gen) - 1).to(leaf.device) * 2.0 ** -23)
    return moved


def _rel_l2(a, ref):
    ref = ref.cpu()
    return float((a.cpu() - ref).norm() / ref.norm())


def _limit(fixed, card_pair, cpu_pair):
    """The larger of ``fixed`` and twice the float32 floor: the relative L2
    that a one-ulp move of the weights gives on the card and on the CPU
    ((moved, unmoved) pairs), added in quadrature."""
    return max(fixed, 2.0 * float(np.hypot(_rel_l2(*card_pair), _rel_l2(*cpu_pair))))


@pytest.mark.gpu
def test_gnn_bp4_forward_on_card_matches_cpu(card, gnn_bp4_n882):
    """The shipped trained weights on one B=256 batch at p=0.03, syndromes
    computed once: each iteration's check/logical logits within a relative
    L2 error of the larger of 1e-3 and twice their float32 floor (phi's
    staircase at large arguments turns ulps into logit differences that the
    CN embeddings carry on), the hard decisions equal on >= 0.9999 of the
    entries."""
    from feedback_gnn_tpu_torch.decoders.gnn_full import gnn_bp4_apply
    from feedback_gnn_tpu_torch.ops import mod2_matmul

    graph, rs, params, cfg = gnn_bp4_n882["cpu"]
    n = graph.n
    nx, nz = (torch.nn.functional.pad(t.to(torch.int32), (0, 0, 0, graph.n_pad - n)) for t in _pauli(n, 256, 0.03, 31))
    sx, sz = mod2_matmul(graph.hx, nz), mod2_matmul(graph.hz, nx)
    cg, crs, cparams, _ = gnn_bp4_n882["cuda"]
    with torch.no_grad():
        ref = gnn_bp4_apply(params, graph, rs, sx, sz, cfg, collect_logits=True)
        ref_moved = gnn_bp4_apply(_ulp_moved(params, 5), graph, rs, sx, sz, cfg, collect_logits=True)
        out = gnn_bp4_apply(cparams, cg, crs, sx.to(card), sz.to(card), cfg, collect_logits=True)
        moved = gnn_bp4_apply(_ulp_moved(cparams, 5), cg, crs, sx.to(card), sz.to(card), cfg, collect_logits=True)
    assert out[0].is_cuda and len(out[2]) == cfg.num_iter
    for i, stacks in enumerate(zip(out[2], ref[2], moved[2], ref_moved[2])):
        for u, v, w, x in zip(*stacks):
            assert _rel_l2(u, v) <= _limit(1e-3, (w, u), (x, v)), i
    differ = ((out[0].cpu() != ref[0]) | (out[1].cpu() != ref[1]))[:n]
    assert 1.0 - float(differ.float().mean()) >= 0.9999


@pytest.mark.gpu
def test_gnn_bp4_loss_on_card_matches_cpu(card, gnn_bp4_n882):
    """gnn_bp4_loss and its gradients on one shared B=120 batch at p=0.03
    from the shipped trained weights: the loss at rtol 1e-4, each gradient
    leaf within a relative L2 error of the larger of 1e-3 and twice its
    float32 floor (the index gathers' backward adds atomically on the card,
    in no fixed order)."""
    from feedback_gnn_tpu_torch.decoders.gnn_full import gnn_bp4_loss, load_shipped
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths

    nx, nz = (t.to(torch.float32) for t in _pauli(882, 120, 0.03, 32))

    def loss_grads(dev, moved):
        graph, rs, _, cfg = gnn_bp4_n882[dev]
        params = load_shipped("n882", dev)[0]
        if moved:
            params = _ulp_moved(params, 5)
        leaves = flatten_with_paths(params)
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        loss = gnn_bp4_loss(params, graph, rs, cfg, nx.to(dev), nz.to(dev))
        loss.backward()
        return loss.item(), {k: v.grad.cpu() for k, v in leaves.items()}

    (on_card, card_moved), (on_cpu, cpu_moved) = ((loss_grads(dev, False), loss_grads(dev, True))
                                                  for dev in ("cuda", "cpu"))
    np.testing.assert_allclose(on_card[0], on_cpu[0], rtol=1e-4)
    for key, g in on_cpu[1].items():
        limit = _limit(1e-3, (card_moved[1][key], on_card[1][key]), (cpu_moved[1][key], g))
        assert _rel_l2(on_card[1][key], g) <= limit, key


# ---- the GF(2) product (csrc/gf2mat.cu) ------------------------------------------

GF2_BATCHES = [1, 31, 32, 33, 100, 1024, 1664, 3072, 8192, 20480]
_GF2_GRAPHS = {}


def _gf2_graph(name, card):
    """A paper code's QuantumGraph on the card, built once a module."""
    if name not in _GF2_GRAPHS:
        from feedback_gnn_tpu_torch.codes import QuantumGraph

        _GF2_GRAPHS[name] = QuantumGraph.from_code(OSD_CODES[name](), stage_mode=True).to(card)
    return _GF2_GRAPHS[name]


def _gf2_batch(n, b, card, seed):
    """A [n, b] int32 0/1 batch: noise-like, with an all-ones sample (each
    row sums its weight, up to 346) where b > 1."""
    g = torch.Generator(device=card).manual_seed(seed)
    v = (torch.rand((n, b), generator=g, device=card) < 0.1).to(torch.int32)
    if b > 1:
        v[:, b // 2] = 1
    return v


def _gf2_check(graph, v, expect_launch=True):
    """Every dense matrix of the graph: the kernel equals the plain version
    bit for bit and counts one launch a call, path kernel."""
    from feedback_gnn_tpu_torch.ops.gf2mat import mod2_matmul, mod2_matmul_plain

    b = v.shape[1]
    for mat in graph.DENSE:
        h = getattr(graph, mat)
        obs.reset()
        out = mod2_matmul(h, v)
        keys = obs.snapshot()["keys"].get("gf2.launches", {})
        assert keys == ({("kernel", h.shape[0], h.shape[1], b): 1} if expect_launch and b else {}), mat
        assert out.is_cuda and out.dtype == torch.int32 and out.shape == (h.shape[0], b), mat
        assert torch.equal(out, mod2_matmul_plain(h, v.to(torch.int32))), mat


@pytest.mark.gpu
@pytest.mark.parametrize("b", GF2_BATCHES)
@pytest.mark.parametrize("name", ["n882", "n1270"])
def test_gf2_kernel_equals_plain(card, name, b):
    """The GF(2) product's kernel equals mod2_matmul_plain bit for bit for
    hx, hz, hx_perp, hz_perp, lx and lz, at the batches of the cells, their
    sub-batches, the miners and the trainer, and ragged ones."""
    graph = _gf2_graph(name, card)
    _gf2_check(graph, _gf2_batch(graph.n_pad, b, card, b))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uint8", "bool", "column slice", "transposed", "int64", "empty"])
@pytest.mark.parametrize("name", ["n882", "n1270"])
def test_gf2_kernel_inputs(card, name, case):
    """v as uint8 and bool (read as bytes), a column slice (read through its
    row stride), a transposed batch, int64 (converted) and B = 0 (an empty
    result, no launch)."""
    graph = _gf2_graph(name, card)
    full = _gf2_batch(graph.n_pad, 1100, card, 3)
    v = {"uint8": full.to(torch.uint8), "bool": full.bool(), "column slice": full[:, 37:1061],
         "transposed": full.T.contiguous().T, "int64": full.long(), "empty": full[:, :0]}[case]
    _gf2_check(graph, v, expect_launch=case != "empty")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["not 0/1", "too wide", "devices"])
def test_gf2_kernel_refuses_what_it_cannot_take(card, case):
    from feedback_gnn_tpu_torch.ops import gf2mat

    graph = _gf2_graph("n882", card)
    h, v = graph.hx, _gf2_batch(graph.n_pad, 64, card, 4)
    if case == "not 0/1":
        h = 2 * h
    elif case == "too wide":
        n = gf2mat.MAX_COLUMNS + 1
        h, v = torch.zeros((1, n), device=card), torch.zeros((n, 8), dtype=torch.int32, device=card)
    else:
        h = h.cpu()
    obs.reset()
    with pytest.raises(ValueError):
        gf2mat.mod2_matmul(h, v)
    assert obs.snapshot()["keys"].get("gf2.launches", {}) == {}


# ---- the program's spans and counters ------------------------------------------


@pytest.mark.gpu
def test_k1_shape_record_matches_the_benchmark_recorder(card, n882_training):
    """The program's record of K1's launch shapes (obs's k1.launches keys)
    equals, batch by batch, what the benchmark's Recorder sees at K1's
    entry, on the compacted [[882,24]] cascade of the mc_p08 cell; the
    spans' in-program K1 time is positive."""
    from collections import Counter

    from benchmark.mc import Recorder
    from feedback_gnn_tpu_torch.decoders.cascade import CascadeConfig, sandwich_eval_step

    (graph, qc, params), _ = n882_training
    cfg = CascadeConfig(num_rounds=3, compact_fraction=0.4, stage1_prepass=12, round_fraction=0.08)
    rec = Recorder()
    rec.install({})
    try:
        step = rec.wrap(lambda gen, p: sandwich_eval_step(graph, [params], cfg, gen, p, 4096, qc=qc,
                                                           return_overflow=True))
        rec.reset([], None)
        gen = torch.Generator(device=card)
        obs.enable()
        for i in range(3):
            obs.reset()
            int(step(gen.manual_seed(i), 0.08)[0])
            snap = obs.snapshot()
            seen = Counter((r["batch"], r["iters"], r["cn_type"], r["phi_impl"], r["msg_dtype"])
                           for r in rec.k1[i])
            assert snap["keys"]["k1.launches"] == seen and sum(seen.values()) == 2 + cfg.num_rounds
            assert snap["spans"]["k1.kernel"]["count"] == 2 + cfg.num_rounds
            assert 0 < snap["spans"]["k1.kernel"]["device_s"] < snap["spans"]["cascade.bp"]["device_s"]
    finally:
        obs.enable(False)
        obs.reset()
        rec.uninstall()


# ---- GNN_BP4's CN and VN update kernels (csrc/gnn_bp4.cu) ----------------------------

GNN_BP4_SHAPES = [("n882", 1), ("n882", 31), ("n882", 128), ("n882", 2048), ("n882", 20480), ("gb48", 1),
                  ("gb48", 64)]
GNN_BP4_TOL = 1e-5
_GNN_BP4_GRAPHS = {}


def _gnn_bp4_graph(name, card):
    if name not in _GNN_BP4_GRAPHS:
        code = tc.ghp_882_24() if name == "n882" else CODES["gb48"]()
        _GNN_BP4_GRAPHS[name] = tc.QuantumGraph.from_code(code, stage_mode=True).to(card)
    return _GNN_BP4_GRAPHS[name]


def _gnn_bp4_params(weights, card):
    """(params, cfg): a shipped trained set, or a seeded glorot init."""
    from feedback_gnn_tpu_torch.decoders import gnn_full

    if weights == "fresh":
        cfg = gnn_full.GNNBP4Config()
        return gnn_full.init_gnn_bp4(torch.Generator(device=card).manual_seed(11), cfg), cfg
    return gnn_full.load_shipped(weights, card)


def _gnn_bp4_states(graph, b, card, seed):
    """(h_vn, h_cn_x, h_cn_z, logit_x, logit_z, sign_x, sign_z) with every
    row drawn, pad rows included."""
    g = torch.Generator(device=card).manual_seed(seed)
    gx, gz = graph.gx, graph.gz
    h_vn = torch.randn((20, gx.n_pad, b), generator=g, device=card)
    h_cn_x, h_cn_z = (torch.randn((20, s.c_pad, b), generator=g, device=card) for s in (gx, gz))
    logit_x, logit_z = (torch.randn((s.c_pad, b), generator=g, device=card) * 3.0 for s in (gx, gz))
    sign_x, sign_z = (1.0 - 2.0 * torch.randint(0, 2, (s.c_pad, b), generator=g, device=card).float()
                      for s in (gx, gz))
    return h_vn, h_cn_x, h_cn_z, logit_x, logit_z, sign_x, sign_z


def _gnn_bp4_gap(out, ref):
    return float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("logits", ["drawn", "zero"])
@pytest.mark.parametrize("reduce_op", ["mean", "sum"])
@pytest.mark.parametrize("weights", ["n882", "gb48", "fresh"])
@pytest.mark.parametrize("code,b", GNN_BP4_SHAPES)
def test_gnn_bp4_cn_kernel_matches_plain(card, code, b, weights, reduce_op, logits):
    """Both sides' CN update, one launch: every row, pad rows included,
    within |kernel - plain| / max(|plain|, 1) <= 1e-5 (the same products,
    summed in the plain version's order except the embed product's); two
    calls give the same bits; one ``kernel`` launch counted a call.  Zero
    logits are iteration 0's."""
    from feedback_gnn_tpu_torch.decoders import gnn_full

    torch.backends.cuda.matmul.allow_tf32 = False
    graph = _gnn_bp4_graph(code, card)
    params, cfg = _gnn_bp4_params(weights, card)
    cfg = cfg._replace(reduce_op=reduce_op)
    h_vn, hx, hz, lx, lz, _, _ = _gnn_bp4_states(graph, b, card, seed=b)
    if logits == "zero":
        lx, lz = torch.zeros_like(lx), torch.zeros_like(lz)
    with torch.no_grad():
        obs.reset()
        out = gnn_full._update_cn(params, graph, cfg, h_vn, hx, hz, lx, lz)
        again = gnn_full._update_cn(params, graph, cfg, h_vn, hx, hz, lx, lz)
        keys = obs.snapshot()["keys"].get("gnn_bp4.launches", {})
        ref = gnn_full._update_cn_plain(params, graph, cfg, h_vn, hx, hz, lx, lz)
    assert keys == {("kernel", "cn", b): 2}
    for o, a, r in zip(out, again, ref):
        assert o.shape == r.shape and o.dtype == torch.float32 and torch.equal(o, a)
        assert _gnn_bp4_gap(o, r) <= GNN_BP4_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("reduce_op", ["mean", "sum"])
@pytest.mark.parametrize("weights", ["n882", "gb48", "fresh"])
@pytest.mark.parametrize("code,b", GNN_BP4_SHAPES)
def test_gnn_bp4_vn_kernel_matches_plain(card, code, b, weights, reduce_op):
    """The VN update, one launch: every row within 1e-5 of the plain
    version (its sums are taken in the plain version's order), two calls
    the same bits, one ``kernel`` launch a call."""
    from feedback_gnn_tpu_torch.decoders import gnn_full

    torch.backends.cuda.matmul.allow_tf32 = False
    graph = _gnn_bp4_graph(code, card)
    params, cfg = _gnn_bp4_params(weights, card)
    cfg = cfg._replace(reduce_op=reduce_op)
    h_vn, hx, hz, _, _, sx, sz = _gnn_bp4_states(graph, b, card, seed=b + 1)
    with torch.no_grad():
        obs.reset()
        out = gnn_full._update_vn(params, graph, cfg, hx, hz, h_vn, sx, sz)
        again = gnn_full._update_vn(params, graph, cfg, hx, hz, h_vn, sx, sz)
        keys = obs.snapshot()["keys"].get("gnn_bp4.launches", {})
        ref = gnn_full._update_vn_plain(params, graph, cfg, hx, hz, h_vn, sx, sz)
    assert keys == {("kernel", "vn", b): 2}
    assert out.shape == ref.shape and torch.equal(out, again)
    assert _gnn_bp4_gap(out, ref) <= GNN_BP4_TOL


@pytest.mark.gpu
def test_gnn_bp4_decode_on_the_kernels_matches_plain(card, monkeypatch):
    """A whole decode on [[882,24]] at B = 2048, p = 0.03 through the
    kernels: each sample's decisions equal the plain decode's on >= 99 % of
    the samples (the network runs 8 iterations, where float32's last bits
    move a marginal sample; PERF.md section 2), and every update of the
    eval step's decode counts a ``kernel`` launch."""
    from feedback_gnn_tpu_torch.decoders import gnn_full
    from feedback_gnn_tpu_torch.models import gnn_bp4_count
    from feedback_gnn_tpu_torch.ops import mod2_matmul

    host = tc.QuantumGraph.from_code(tc.ghp_882_24(), stage_mode=True)
    graph, rs = host.to(card), gnn_full.make_logit_rowsets(host, card)
    params, cfg = gnn_full.load_shipped("n882", card)
    nx, nz = (torch.nn.functional.pad(t.to(torch.int32), (0, 0, 0, graph.n_pad - graph.n)).to(card)
              for t in _pauli(graph.n, 2048, 0.03, 33))
    sx, sz = mod2_matmul(graph.hx, nz), mod2_matmul(graph.hz, nx)
    with torch.no_grad():
        out = gnn_full.gnn_bp4_apply(params, graph, rs, sx, sz, cfg)
        monkeypatch.setattr(gnn_full, "takes_kernel", lambda *args, **kw: False)
        ref = gnn_full.gnn_bp4_apply(params, graph, rs, sx, sz, cfg)
        monkeypatch.undo()
        obs.reset()
        gnn_bp4_count(graph, rs, params, cfg, nx[:graph.n, :256], nz[:graph.n, :256])
        keys = obs.snapshot()["keys"].get("gnn_bp4.launches", {})
    differ = ((out[0] != ref[0]) | (out[1] != ref[1]))[:graph.n].any(dim=0)
    assert 1.0 - float(differ.float().mean()) >= 0.99
    assert keys == {("kernel", "cn", 256): cfg.num_iter, ("kernel", "vn", 256): cfg.num_iter}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["float64", "devices", "bias"])
def test_gnn_bp4_kernel_path_refuses_what_it_cannot_take(card, case):
    """A card call on the kernel path with inputs or parameters the kernel
    cannot read raises ValueError; nothing falls back to the plain version."""
    from feedback_gnn_tpu_torch.decoders import gnn_full

    graph = _gnn_bp4_graph("gb48", card)
    params, cfg = _gnn_bp4_params("gb48", card)
    h_vn, hx, hz, lx, lz, _, _ = _gnn_bp4_states(graph, 8, card, seed=3)
    if case == "float64":
        hx = hx.double()
    elif case == "devices":
        lz = lz.cpu()
    else:
        params = copy.deepcopy(params)
        params["cn_msg_mlp_z"][0]["bias"] = torch.zeros(40, device=card)
    obs.reset()
    with torch.no_grad(), pytest.raises(ValueError):
        gnn_full._update_cn(params, graph, cfg, h_vn, hx, hz, lx, lz)
    assert obs.snapshot()["keys"].get("gnn_bp4.launches", {}) == {}
