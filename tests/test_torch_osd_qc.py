"""BP4 + OSD-0 with BP on the fused QC decode (``bp4_osd_count(...,
qc=...)``, K1's plain version on the CPU) against the gather path and the
JAX package, on a small QC-GHP code and on [[882,24]] at a few dozen
samples of seeded noise.

The two BP decoders sum in different orders, so a sample that BP does not
converge may end elsewhere on each; where both decodes meet the syndrome
their estimates are equal, and where both leave it unmet on equal
marginals, so are their OSD-0 estimates.
OSD-0 is integer only: given the QC decode's marginals, the port's and the
JAX package's OSD and accounting agree bit for bit.  Also: the step ends
the batch once and records its spans and counters, and the CLI's bp4-osd
decodes on the QC decode wherever the code is block-circulant.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu import models as jmodels
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders.bp4 import BP4Result as JBP4Result
from feedback_gnn_tpu.decoders.osd import bp_osd_correct as j_bp_osd_correct

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import models, obs
from feedback_gnn_tpu_torch.decoders.bp4 import bp4_decode
from feedback_gnn_tpu_torch.decoders.bp4_qc import bp4_decode_qc
from feedback_gnn_tpu_torch.decoders.cascade import prior_llr
from feedback_gnn_tpu_torch.decoders.graph_ops import pad_rows_to
from feedback_gnn_tpu_torch.decoders.osd import bp_osd_correct
from feedback_gnn_tpu_torch.ops.gf2mat import mod2_matmul

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

P = 0.10
# (code, batch, BP iterations, OSD caps): few iterations leave many samples flagged
CASES = {
    "ghp21": (lambda m: m.create_QC_GHP_codes(7, m.create_cyclic_permuting_matrix(3, [2, 4, 0]), [0, 1, 3]),
              48, 20, (None, 16, 4)),
    "n882": (lambda m: m.ghp_882_24(), 24, 12, (8, 2)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, b, iters, caps = CASES[request.param]
    jcode, tcode = make(jc), make(tc)
    tg = tc.QuantumGraph.from_code(tcode, stage_mode=True).to("cpu")
    jg = JQuantumGraph.from_code(jcode, stage_mode=True)
    rng = np.random.default_rng(len(request.param) + 20)
    u = rng.random((tcode.N, b))
    nx, nz = u < 2 * P / 3, (u >= P / 3) & (u < P)
    return dict(name=request.param, jcode=jcode, tcode=tcode, tg=tg, jg=jg, qc=tc.qc_pair_from_code(tcode),
                b=b, iters=iters, caps=caps, nx=nx, nz=nz)


def _decodes(c):
    """(padded noise x, z, QC decode, gather decode) of the case's noise."""
    tg, n, b = c["tg"], c["tg"].n, c["b"]
    nx = pad_rows_to(torch.as_tensor(c["nx"]).to(torch.int32), tg.n_pad)
    nz = pad_rows_to(torch.as_tensor(c["nz"]).to(torch.int32), tg.n_pad)
    sx, sz = mod2_matmul(tg.hx, nz), mod2_matmul(tg.hz, nx)
    llr0 = prior_llr(P, n, b, n_pad=tg.n_pad)
    qres = bp4_decode_qc(tg, c["qc"], llr0, sx, sz, c["iters"], "minsum", 0.8, need_logits=False)
    gres = bp4_decode(tg, llr0, sx, sz, c["iters"], "minsum", 0.8)
    return nx, nz, qres, gres


def _osd_args(code):
    return code.pivot_hx, code.pivot_hz, code.hx_basis, code.hz_basis


def test_osd_on_the_qc_decode_matches_jax_bit_for_bit(case):
    """Given the QC decode's marginals, the port's and the JAX package's
    flagged sets, OSD-0 estimates and overflow are equal, with and without
    a sub-batch and where it overflows."""
    nx, nz, qres, _ = _decodes(case)
    jres = JBP4Result(*[jnp.asarray(f.numpy()) if f is not None else None for f in qres])
    for cap in case["caps"]:
        out = bp_osd_correct(case["tg"], qres, nx, nz, *_osd_args(case["tcode"]), compact_cap=cap)
        ref = j_bp_osd_correct(case["jg"], jres, jnp.asarray(nx.numpy()), jnp.asarray(nz.numpy()),
                               *_osd_args(case["jcode"]), compact_cap=cap)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=f"cap {cap}")
        flagged = int(out[2].sum())
        assert flagged > 2
        assert int(out[3]) == (max(0, flagged - cap) if cap is not None else 0)


def test_qc_and_gather_paths_agree_where_both_decodes_meet_the_syndrome(case):
    """Samples that both BP decoders bring to the syndrome have equal
    estimates; where both leave it unmet and their marginals are equal,
    OSD-0 gives both the same estimate."""
    tg = case["tg"]
    nx, nz, qres, gres = _decodes(case)
    n = tg.n
    cap = case["caps"][0]
    outs = [bp_osd_correct(tg, r, nx, nz, *_osd_args(case["tcode"]), compact_cap=cap) for r in (qres, gres)]
    (qx, qz, qflag, _), (gx, gz, gflag, _) = outs
    same_marg = torch.ones(case["b"], dtype=torch.bool)
    for f in ("llrx", "llry", "llrz"):
        same_marg &= (getattr(qres, f)[:n] == getattr(gres, f)[:n]).all(dim=0)
    both_met = ~qflag & ~gflag
    assert both_met.sum() > 0
    same_est = (qx == gx).all(dim=0) & (qz == gz).all(dim=0)
    assert same_est[both_met].all()
    both_flagged = qflag & gflag & same_marg
    assert same_est[both_flagged].all()
    # the decoders part on few samples
    assert int((qflag != gflag).sum()) <= max(2, case["b"] // 8)


def test_qc_step_counts_match_jax_step_on_the_same_decode(case, monkeypatch):
    """``bp4_osd_count(..., qc=...)`` against the JAX package's
    ``bp4_osd_eval_step`` on the same noise, its BP replaced by the port's
    QC decode: the counts (flagged, logical, overflow) are equal."""
    _, _, qres, _ = _decodes(case)
    jres = JBP4Result(*[jnp.asarray(f.numpy()) if f is not None else None for f in qres])
    monkeypatch.setattr(jmodels, "pauli_iid", lambda *a: (jnp.asarray(case["nx"]), jnp.asarray(case["nz"])))
    monkeypatch.setattr(jmodels, "bp4_decode", lambda *a, **k: jres)
    for cap in case["caps"]:
        ref = jmodels.bp4_osd_eval_step(case["jg"], case["jcode"], jax.random.PRNGKey(0), P, case["b"],
                                        num_iter=case["iters"], osd_compact_cap=cap)
        out = models.bp4_osd_count(case["tg"], case["tcode"], torch.as_tensor(case["nx"]),
                                   torch.as_tensor(case["nz"]), P, num_iter=case["iters"], osd_compact_cap=cap,
                                   qc=case["qc"])
        assert [int(o) for o in out] == [int(r) for r in ref], cap
        assert len(out) == (2 if cap is None else 3)


def test_qc_step_counts_match_the_gather_step_where_the_flags_agree(case):
    """The QC and gather steps' counts differ by at most the samples whose
    BP decodes part (flags or marginals)."""
    nx, nz, qres, gres = _decodes(case)
    n = case["tg"].n
    parted = torch.zeros(case["b"], dtype=torch.bool)
    for f in ("llrx", "llry", "llrz"):
        parted |= (getattr(qres, f)[:n] != getattr(gres, f)[:n]).any(dim=0)
    cap = case["caps"][0]
    args = (case["tg"], case["tcode"], torch.as_tensor(case["nx"]), torch.as_tensor(case["nz"]), P)
    kw = dict(num_iter=case["iters"], osd_compact_cap=cap)
    q = [int(v) for v in models.bp4_osd_count(*args, qc=case["qc"], **kw)]
    g = [int(v) for v in models.bp4_osd_count(*args, **kw)]
    assert all(abs(a - b) <= int(parted.sum()) for a, b in zip(q, g)), (q, g, int(parted.sum()))


def test_bfloat16_carry_needs_the_qc_decode(case):
    with pytest.raises(ValueError, match="fused QC decode"):
        models.bp4_osd_count(case["tg"], case["tcode"], torch.as_tensor(case["nx"]), torch.as_tensor(case["nz"]),
                             P, num_iter=2, msg_dtype="bfloat16")


@pytest.fixture
def traced():
    obs.enable(False)
    obs.reset()
    yield
    obs.enable(False)
    obs.reset()


def _ghp21_step(qc=True):
    code = CASES["ghp21"][0](tc)
    tg = tc.QuantumGraph.from_code(code, stage_mode=True).to("cpu")
    qc = tc.qc_pair_from_code(code) if qc else None

    def step(gen, cap):
        return models.bp4_osd_eval_step(tg, code, gen, P, 48, num_iter=8, osd_compact_cap=cap, qc=qc)

    return step


def test_step_ends_the_batch_once(traced, monkeypatch):
    calls = []
    end = obs.end_batch
    monkeypatch.setattr(obs, "end_batch", lambda: (calls.append(1), end()))
    step = _ghp21_step()
    gen = torch.Generator().manual_seed(5)
    obs.enable()
    for i in range(3):
        step(gen, 16)
        assert len(calls) == i + 1
    assert obs.snapshot()["batches"] == 3


@pytest.mark.parametrize("cap", [None, 16])
def test_step_records_its_spans_and_counters(traced, cap):
    step = _ghp21_step()
    obs.reset()  # the code's set-up spans
    gen = torch.Generator().manual_seed(6)
    flagged = 0
    step(gen, cap)  # tracing off: nothing recorded
    snap = obs.snapshot()
    assert snap["spans"] == {} and "osd.flagged" not in snap["counters"]
    obs.enable()
    for _ in range(2):
        flagged += int(step(gen, cap)[0])
    snap = obs.snapshot()
    spans = snap["spans"]
    assert {"step.sample", "step.account", "osd.bp", "osd.flag", "osd.compact", "osd.eliminate"} <= set(spans)
    assert spans["osd.eliminate"]["count"] == 4
    assert set(spans["osd.eliminate"]["by"]["side"]) == {"x", "z"}
    assert spans["osd.flag"]["count"] == 2 and spans["step.account"]["count"] == 2
    assert spans["osd.bp"]["count"] == 2
    assert snap["counters"]["osd.flagged"] == flagged > 0
    assert snap["counters"]["osd.capacity"] == 2 * (48 if cap is None else cap)


def test_gather_step_records_the_bp_span(traced):
    """The gather decode is the step's span osd.bp too, with no K1 launch
    inside it."""
    step = _ghp21_step(qc=False)
    obs.reset()
    obs.enable()
    step(torch.Generator().manual_seed(7), 16)
    spans = obs.snapshot()["spans"]
    assert spans["osd.bp"]["count"] == 1 and "k1.kernel" not in spans


@pytest.mark.parametrize("qc_kernel", [True, False], ids=["qc_kernel", "gather"])
def test_osd_eval_qc_kernel_selects_the_qc_decode(monkeypatch, qc_kernel):
    """``cli/osd_eval.py --mode bp4-osd`` decodes BP4 on the QC decode and
    names it in the legend; on a code without block-circulant structure
    (``qc_pair_from_code`` finds none), on the gather decoder."""
    from feedback_gnn_tpu_torch.cli import osd_eval

    calls = []
    for name in ("bp4_decode_qc", "bp4_decode"):
        orig = getattr(models, name)
        monkeypatch.setattr(models, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n), _o(*a, **k))[1])
    if not qc_kernel:
        monkeypatch.setattr(osd_eval, "qc_pair_from_code", lambda code: None)
    argv = ["-bs", "8", "--max-mc-iter", "1", "-p", "0.1", "--mode", "bp4-osd", "--osd-cap", "4", "--device", "cpu"]
    _, legend = osd_eval.make_step(osd_eval.make_parser().parse_args(argv), tc.ghp_882_24(), torch.device("cpu"))
    assert ("QC kernel" in legend) == qc_kernel
    res = osd_eval.main(argv)
    assert calls == ["bp4_decode_qc" if qc_kernel else "bp4_decode"]
    assert res.num_blocks.tolist() == [8]

