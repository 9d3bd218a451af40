"""What surrounds the fused QC kernels K1 (csrc/bp4_qc.cu) and K2
(csrc/bp2_qc.cu), checked on the CPU: the launch plan, the per-node slot
tables and the kernel instances the launchers dispatch to.

The slot tables are what the card alone would otherwise see: an emulation
walks them in the kernels' order (VN pass: sums in table-row order, the
extrinsics written back into the slots read; CN pass: each CN's row gathered
into the CN rule and scattered back) and must equal the plain versions bit
for bit.  The CN rule itself is the plain version's ``_cn_plain``, applied
to planes gathered through the CN table: the same tensor shapes as the
plain version's, since torch's CPU atanh rounds differently in its
vectorised and scalar paths.  Imports no CUDA, no triton and no JAX.
"""

import os
import re

import numpy as np
import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.decoders import bp2_qc, bp4_qc
from feedback_gnn_tpu_torch.decoders.bp4_qc import (
    MAX_DEG, NO_SLOT, SM_BLOCK_RESERVED, SM_SMEM, SMEM_LIMIT, _cn_plain, _lse_neg, _side_index,
)
from feedback_gnn_tpu_torch.decoders.cn_update import LLR_MAX, softplus

CODES = {
    "gb48": lambda: tc.create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]),
    "ghp21": lambda: tc.create_QC_GHP_codes(7, tc.create_cyclic_permuting_matrix(3, [2, 4, 0]), [0, 1, 3]),
    "n882": tc.ghp_882_24,
    "n1270": tc.ghp_1270_28,
}
INSTANCE = {"gb48": (8, 4), "ghp21": (6, 3), "n882": (6, 3), "n1270": (6, 3)}
BATCHES = [1, 5, 256, 257, 1024, 3072, 20480]
CASES = [
    ("boxplus-phi", None),
    ("boxplus-phi", "tf"),
    ("boxplus-phi", "accurate"),
    ("boxplus", None),
    ("minsum", None),
]
CSRC = os.path.join(os.path.dirname(bp4_qc.__file__), os.pardir, "csrc")


_QC = {}


def _qc(name):
    if name not in _QC:
        _QC[name] = tc.qc_pair_from_code(CODES[name]())
    return _QC[name]


def _check_plan(plan, nodes, max_threads):
    assert plan.threads % 32 == 0 and 32 <= plan.block_threads <= max_threads
    assert plan.threads * plan.nodes_per_thread >= nodes
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.blocks_per_sm >= 1
    assert plan.blocks_per_sm * (plan.smem_bytes + SM_BLOCK_RESERVED) <= SM_SMEM
    assert plan.blocks_per_sm * plan.block_threads <= 2048


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", sorted(CODES))
def test_launch_plan(name, batch):
    qc = _qc(name)
    k1 = bp4_qc._launch_plan(qc, batch)
    assert k1.instance == INSTANCE[name]
    _check_plan(k1, max(qc.n, (qc.qx.mb + qc.qz.mb) * qc.l), bp4_qc.K1_MAX_THREADS)
    for cn_type in ("minsum", "boxplus-phi"):
        k2 = bp2_qc._launch_plan(qc.qx, batch, cn_type)
        assert k2.instance == INSTANCE[name]
        _check_plan(k2, max(qc.n, qc.qx.mb * qc.l), bp2_qc.K2_MAX_THREADS)
    if batch <= 132:  # one sample per block, about one node per thread
        assert k1.regime == "small" and k1.samples_per_block == 1
        assert k1.threads == min(1024, -(-max(qc.n, (qc.qx.mb + qc.qz.mb) * qc.l) // 32) * 32)
    if batch == 256:
        assert k1.regime == "small" and k1.samples_per_block == 2
    if batch == 20480:
        assert k1.regime == "large" and k2.regime == "large"
    if name == "n882" and batch == 256:  # the main path: two samples per block, one wave
        assert k1.threads == 512 and k1.nodes_per_thread == 2 and k1.blocks(batch) == 128
    if name == "n1270" and batch == 20480:  # the bench prepass: the SM full of samples
        assert k1.threads == 256 and k1.samples_per_block == 4 and k1.nodes_per_thread == 5
    if name == "n882" and batch == 20480:  # the bp2_path: 12 samples per SM
        k2 = bp2_qc._launch_plan(qc.qx, batch, "minsum")
        assert (k2.threads, k2.samples_per_block, k2.blocks_per_sm) == (64, 6, 2)


def test_launch_plan_rejects():
    qc = _qc("n882")
    with pytest.raises(ValueError, match="whole warps"):
        bp4_qc._launch_plan(qc, 64, threads=100)
    with pytest.raises(ValueError, match="whole warps"):
        bp4_qc._launch_plan(qc, 64, threads=512, samples_per_block=3)
    with pytest.raises(ValueError, match="shared memory"):
        bp4_qc._launch_plan(qc, 64, threads=128, samples_per_block=7)
    with pytest.raises(ValueError, match="exceeds a block's shared memory"):
        bp4_qc._plan((6, 3), 882, 1000, SMEM_LIMIT, 64, 64, 1024)


def test_generic_instance_for_other_degrees():
    """A code whose degrees have no instance of their own takes the
    generic one; degrees above MAX_DEG are refused."""
    surface = tc.create_surface_codes(3)
    spec = tc.detect_qc_structure(np.asarray(surface.hx), 1)
    assert bp4_qc._instance((spec,)) == (0, 0)
    wide = tc.detect_qc_structure(np.ones((1, MAX_DEG + 1), dtype=int), 1)
    with pytest.raises(ValueError, match="MAX_DEG"):
        bp4_qc._instance((wide,))


def _gather_planes(msg, ctab_side, spec):
    """CN-frame planes [G, l, B] of one side, each (CN (i, r), k) read
    through the CN table's row."""
    l, b = spec.l, msg.shape[-1]
    planes = torch.empty((spec.num_groups, l, b), dtype=msg.dtype)
    for i, gs in enumerate(spec.cn_groups):
        rows = ctab_side[i * l:(i + 1) * l]
        for k, g in enumerate(gs):
            planes[g] = msg[rows[:, k]]
    return planes


def _scatter_planes(msg, planes, ctab_side, spec):
    l = spec.l
    for i, gs in enumerate(spec.cn_groups):
        rows = ctab_side[i * l:(i + 1) * l]
        for k, g in enumerate(gs):
            msg[rows[:, k]] = planes[g]


def _vn_sum(msg, slots):
    """Sums over each VN's table row in row order, and the values read."""
    vals, acc = [], None
    for k in range(slots.shape[1]):
        ok = torch.as_tensor(slots[:, k] != NO_SLOT)[:, None]
        v = msg[torch.as_tensor(np.where(slots[:, k] != NO_SLOT, slots[:, k], 0))]
        acc = torch.where(ok, v, 0.0) if acc is None else torch.where(ok, acc + v, acc)
        vals.append(v)
    return acc, vals


def _emulate_k1(qc, instance, llr, sx, sz, iters, cn_type, factor, phi_impl):
    vtab, ctab = bp4_qc._slot_tables(qc, instance)
    vw = instance[1] or MAX_DEG
    mx = qc.qx.mb * qc.l
    msgs = qc.qx.num_edges + qc.qz.num_edges
    b = llr.shape[-1]
    msg = torch.zeros((msgs, b))
    syn = {"x": 1.0 - 2.0 * sx.reshape(qc.qx.mb, qc.l, b), "z": 1.0 - 2.0 * sz.reshape(qc.qz.mb, qc.l, b)}
    sides = {"x": (qc.qx, ctab[:mx]), "z": (qc.qz, ctab[mx:])}
    xs, zs = vtab[:, :vw], vtab[:, vw:2 * vw]

    def marginals():
        s_x, vx = _vn_sum(msg, xs)
        s_z, vz = _vn_sum(msg, zs)
        return s_z + llr[0], s_x + s_z + llr[1], s_x + llr[2], vx, vz

    for _ in range(iters):
        llrx, llry, llrz, vx, vz = marginals()
        num_x, num_z = softplus(-llrx), softplus(-llrz)
        for k in range(vw):
            new = num_x - _lse_neg(llrz - vx[k], llry - vx[k])
            keep = xs[:, k] != NO_SLOT
            msg[torch.as_tensor(xs[keep, k])] = new[torch.as_tensor(keep)]
        for k in range(vw):
            new = num_z - _lse_neg(llrx - vz[k], llry - vz[k])
            keep = zs[:, k] != NO_SLOT
            msg[torch.as_tensor(zs[keep, k])] = new[torch.as_tensor(keep)]
        for side, (spec, rows) in sides.items():
            planes = _gather_planes(msg, torch.as_tensor(rows), spec)
            out = _cn_plain(planes, syn[side], _side_index(spec, torch.device("cpu")), cn_type,
                            factor, phi_impl)
            _scatter_planes(msg, out, torch.as_tensor(rows), spec)
    llrx, llry, llrz, _, _ = marginals()
    return llrx, llry, llrz


def _inputs(qc, b, seed):
    rng = np.random.default_rng(seed)
    llr = torch.as_tensor((rng.standard_normal((3, qc.n, b)) * 2.0).astype(np.float32))
    sx = torch.as_tensor(rng.integers(0, 2, (qc.qx.mb * qc.l, b)).astype(np.float32))
    sz = torch.as_tensor(rng.integers(0, 2, (qc.qz.mb * qc.l, b)).astype(np.float32))
    return llr, sx, sz


@pytest.mark.parametrize("cn_type,phi_impl", CASES)
@pytest.mark.parametrize("name", ["gb48", "ghp21"])
def test_k1_slot_tables_walk_to_plain(name, cn_type, phi_impl):
    """The emulation over the specialised and the generic instance's tables
    equals bp4_qc_marginals_plain bit for bit."""
    qc = _qc(name)
    llr, sx, sz = _inputs(qc, 6, 11)
    ref = bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, 6, cn_type, 0.9, phi_impl)
    for instance in (INSTANCE[name], (0, 0)):
        out = _emulate_k1(qc, instance, llr, sx, sz, 6, cn_type, 0.9, phi_impl)
        for o, r in zip(out, ref):
            assert torch.equal(o, r), instance


def _emulate_k2(spec, instance, logits, syn, iters, cn_type, factor):
    vtab, ctab = bp2_qc._slot_tables(spec, instance)
    vw = instance[1] or MAX_DEG
    slots = vtab[:, :vw]
    llr = -logits.clamp(-LLR_MAX, LLR_MAX)
    syn_pm = 1.0 - 2.0 * syn.reshape(spec.mb, spec.l, -1)
    msg = torch.zeros((spec.num_edges, logits.shape[-1]))
    side = _side_index(spec, torch.device("cpu"))
    rows = torch.as_tensor(ctab)

    def totals():
        tot, vals = llr, []
        for k in range(vw):
            ok = torch.as_tensor(slots[:, k] != NO_SLOT)[:, None]
            v = msg[torch.as_tensor(np.where(slots[:, k] != NO_SLOT, slots[:, k], 0))]
            tot = torch.where(ok, tot + v, tot)
            vals.append(v)
        return tot, vals

    for _ in range(iters):
        tot, vals = totals()
        for k in range(vw):
            keep = slots[:, k] != NO_SLOT
            msg[torch.as_tensor(slots[keep, k])] = (tot - vals[k])[torch.as_tensor(keep)]
        planes = _gather_planes(msg, rows, spec)
        _scatter_planes(msg, _cn_plain(planes, syn_pm, side, cn_type, factor, None), rows, spec)
    return -totals()[0]


@pytest.mark.parametrize("cn_type", ["boxplus-phi", "boxplus", "minsum"])
@pytest.mark.parametrize("name", ["gb48", "ghp21"])
def test_k2_slot_tables_walk_to_plain(name, cn_type):
    spec = _qc(name).qx
    rng = np.random.default_rng(12)
    n, m = spec.nb * spec.l, spec.mb * spec.l
    logits = torch.as_tensor((rng.standard_normal((n, 6)) * 3.0).astype(np.float32))
    syn = torch.as_tensor(rng.integers(0, 2, (m, 6)).astype(np.float32))
    ref = bp2_qc.bp2_qc_logits_plain(spec, logits, syn, 6, cn_type, 0.8)
    for instance in (INSTANCE[name], (0, 0)):
        out = _emulate_k2(spec, instance, logits, syn, 6, cn_type, 0.8)
        assert torch.equal(out, ref), instance


def _instances(source, pattern):
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    return set(re.findall(pattern, text))


def test_k1_dispatch_has_instances():
    """Every (CN rule, phi form, DC, DV, message carry) K1's launcher can be
    asked for is instantiated in csrc/bp4_qc.cu."""
    names = {0: "CN_PHI", 1: "CN_TANH", 2: "CN_MINSUM"}
    phis = {0: "PHI_TANH", 1: "PHI_TF", 2: "PHI_ACCURATE"}
    msgs = {0: "MSG_F32", 1: "MSG_BF16"}
    found = _instances(
        "bp4_qc.cu",
        r"\{(CN_\w+), (PHI_\w+), (\d), (\d), (MSG_\w+), bp4_qc_kernel<\1, \2, \3, \4, \5>\}")
    wanted = set()
    for cn_type, phi_impl in CASES:
        for instance in bp4_qc.SPECIALISED + ((0, 0),):
            for msg_dtype in bp4_qc.MSG_DTYPES:
                cn, phi, dc, dv, msg = bp4_qc._kernel_codes(cn_type, phi_impl, instance, msg_dtype)
                wanted.add((names[cn], phis[phi], str(dc), str(dv), msgs[msg]))
    assert len(wanted) == 30 and wanted <= found


def test_k2_dispatch_has_instances():
    names = {0: "CN_PHI", 1: "CN_TANH", 2: "CN_MINSUM"}
    found = _instances("bp2_qc.cu", r"\{(CN_\w+), (\d), (\d), bp2_qc_kernel<\1, \2, \3>\}")
    wanted = {(names[bp2_qc.CN_TYPES.index(cn)], str(dc), str(dv))
              for cn in bp2_qc.CN_TYPES for dc, dv in bp4_qc.SPECIALISED + ((0, 0),)}
    assert len(wanted) == 9 and wanted <= found


def test_packed_table_layout():
    """The packed table: VN rows, zero padding to 16 bytes, CN rows; its
    size is the slot-table bytes the plan counts."""
    qc = _qc("ghp21")
    for instance in (INSTANCE["ghp21"], (0, 0)):
        vtab, ctab = bp4_qc._slot_tables(qc, instance)
        packed = bp4_qc._pack_tables(vtab, ctab).view(np.uint16)
        vbytes = -(-vtab.size * 2 // 16) * 16
        assert packed.size * 2 == vbytes + 2 * ctab.size
        assert np.array_equal(packed[:vtab.size], vtab.reshape(-1))
        assert np.array_equal(packed[vbytes // 2:], ctab.reshape(-1))
        assert (vtab.shape[1] * 2) % 16 == 0 and (ctab.shape[1] * 2) % 16 == 0
    spec = qc.qx
    vtab, ctab = bp2_qc._slot_tables(spec, (6, 3))
    assert vtab.shape == (spec.nb * spec.l, 4) and ctab.shape == (spec.mb * spec.l, 8)
