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

import numpy as np
import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import probes
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
    before = bp4_qc.launches
    out = bp4_qc.bp4_qc_marginals(qc, llr, sx, sz, 16, cn_type, 0.9, phi_impl=phi_impl)
    assert bp4_qc.launches == before + 1
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
    before = bp2_qc.launches
    out = bp2_qc.bp2_qc_logits(spec, llr, syn, 20, cn_type, 0.8)
    assert bp2_qc.launches == before + 1
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
    before = bp4_qc.launches
    check_qc_golden(case, card)
    assert bp4_qc.launches == before + 1


def _probe_cases(device):
    return {p.key: p for p in probes.probe_cases(probes.probe_inputs(device))}


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(_probe_cases("cpu")))
def test_probe_kernel_matches_plain(card, key):
    p = _probe_cases(card)[key]
    before = probes.launches[p.name]
    out = p.fn(*p.args)
    assert probes.launches[p.name] == before + 1
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
    before = probes.launches[fn.__name__]
    out = fn(x, fast=True)
    torch.cuda.synchronize()
    assert probes.launches[fn.__name__] == before + 1
    assert bool(torch.isfinite(out).all())
    assert float((out.double() - probes.phi_reference(x)).abs().max()) < 1.0


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


def _k1_exact(qc, llr, sx, sz, iters, plan, cases):
    for cn_type, phi_impl in cases:
        before = bp4_qc.launches
        out = bp4_qc._launch_kernel(qc, llr, sx, sz, iters, cn_type, 0.9, phi_impl, plan)
        assert bp4_qc.launches == before + 1
        ref = bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, iters, cn_type, 0.9, phi_impl=phi_impl)
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            assert torch.equal(o, r), (cn_type, phi_impl, plan, float((o - r).abs().max()))


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


def _k2_exact(spec, llr, syn, iters, plan, cn_types):
    for cn_type in cn_types:
        before = bp2_qc.launches
        out = bp2_qc._launch_kernel(spec, llr, syn, iters, cn_type, 0.8, plan)
        assert bp2_qc.launches == before + 1
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
    before = bp4_qc.launches
    out = miner.body(nx, nz)
    assert bp4_qc.launches == before + launches
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
