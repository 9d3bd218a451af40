"""The port's flagged-first compaction (decoders/compact.py) against the
JAX package's own expressions, and OSD-0 on the flagged samples through
its one path.

The JAX package writes the sub-batch decision inline
(``feedback_gnn_tpu/decoders/cascade.py``): the capacity rounding, the
stable argsort over ``logical_not(flags)``, the ``covered`` mask of the
overflow and the ``.at[:, idx].set(where(...))`` merge.  The port's helpers
must put every sample in the same slot.  Without a cap, BP + OSD-0 runs the
whole batch in flagged-first order; OSD-0 decides each sample alone, so
that equals the capped path at cap = B and the uncompacted decode.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import models
from feedback_gnn_tpu_torch.decoders.bp4 import bp4_decode, quaternary_to_binary_llrs
from feedback_gnn_tpu_torch.decoders.cascade import prior_llr
from feedback_gnn_tpu_torch.decoders.compact import capacity, flagged_first, merge, overflow
from feedback_gnn_tpu_torch.decoders.graph_ops import pad_rows_to
from feedback_gnn_tpu_torch.decoders.osd import bp_osd_correct, osd0_decode
from feedback_gnn_tpu_torch.ops.gf2mat import mod2_matmul

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "feedback_gnn_tpu_torch"


def jax_sub_batch(flags, cap):
    """The JAX package's decision (cascade.py, level 1): (idx, valid, overflow mask)."""
    f = jnp.asarray(flags)
    idx = jnp.argsort(jnp.logical_not(f), stable=True)[:cap]
    valid = f[idx]
    covered = jnp.zeros(f.shape[0], bool).at[idx].set(valid)
    return np.asarray(idx), np.asarray(valid), np.asarray(jnp.logical_and(f, jnp.logical_not(covered)))


@pytest.mark.parametrize("batch,cap,share", [
    (64, 16, 0.3), (64, 64, 0.3), (100, 37, 0.5), (257, 128, 0.1), (48, 48, 0.9), (33, 8, 0.0), (40, 40, 1.0),
])
def test_flagged_first_and_overflow_match_jax(batch, cap, share):
    flags = np.random.default_rng(batch + cap).random(batch) < share
    want_idx, want_valid, want_over = jax_sub_batch(flags, cap)
    idx, valid = flagged_first(torch.as_tensor(flags), cap)
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    over = overflow(torch.as_tensor(flags), idx, valid)
    np.testing.assert_array_equal(over.numpy(), want_over)
    assert int(over.sum()) == max(0, int(flags.sum()) - cap)


@pytest.mark.parametrize("tile", [8, 16, 128])
def test_capacity_matches_jax_rounding(tile):
    for batch in (1, 7, 64, 100, 1000, 20480):
        for fraction in (1 / batch, 0.01, 0.02, 0.05, 0.08, 0.15, 0.4, 0.999, 1.0):
            want = min(batch, -(-int(np.ceil(fraction * batch)) // tile) * tile)
            assert capacity(fraction, batch, tile) == want, (batch, fraction)


@pytest.mark.parametrize("cap", [5, 12])
def test_merge_matches_jax_scatter(cap):
    rng = np.random.default_rng(cap)
    full = rng.integers(0, 2, (9, 12)).astype(np.int32)
    sub = rng.integers(0, 2, (9, cap)).astype(np.int32)
    flags = rng.random(12) < 0.5
    idx, valid, _ = jax_sub_batch(flags, cap)
    want = jnp.asarray(full).at[:, idx].set(jnp.where(valid[None, :], sub, jnp.asarray(full)[:, idx]))
    out = merge(torch.as_tensor(full), torch.as_tensor(idx.astype(np.int64)), torch.as_tensor(sub),
                torch.as_tensor(np.array(valid)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def gb48():
    code = tc.create_generalized_bicycle_codes(*GB48)
    return code, tc.QuantumGraph.from_code(code, stage_mode=True).to("cpu")


@pytest.mark.parametrize("seed", [3, 5])
def test_bp_osd_correct_without_a_cap_is_the_cap_of_the_batch(gb48, seed):
    code, graph = gb48
    n, n_pad, b, p = graph.n, graph.n_pad, 48, 0.12
    u = np.random.default_rng(seed).random((n, b))
    nx = pad_rows_to(torch.as_tensor(u < 2 * p / 3, dtype=torch.int32), n_pad)
    nz = pad_rows_to(torch.as_tensor((u >= p / 3) & (u < p), dtype=torch.int32), n_pad)
    res = bp4_decode(graph, prior_llr(p, n, b, n_pad=n_pad), mod2_matmul(graph.hx, nz), mod2_matmul(graph.hz, nx),
                     6, "minsum", 0.8)
    args = (code.pivot_hx, code.pivot_hz, code.hx_basis, code.hz_basis)
    whole = bp_osd_correct(graph, res, nx, nz, *args)
    capped = bp_osd_correct(graph, res, nx, nz, *args, compact_cap=b)
    for w, c in zip(whole, capped):
        assert torch.equal(w, c)
    flagged = whole[2]
    assert 0 < int(flagged.sum()) < b and int(whole[3]) == 0
    # the decode without compaction: OSD-0 on every sample, kept where flagged
    llrx, llrz = quaternary_to_binary_llrs(res.llrx[:n], res.llry[:n], res.llrz[:n])
    red_sx = mod2_matmul(graph.hx, nz)[torch.as_tensor(code.pivot_hx)]
    red_sz = mod2_matmul(graph.hz, nx)[torch.as_tensor(code.pivot_hz)]
    z_all = pad_rows_to(osd0_decode(llrz.T, code.hx_basis, red_sx).T, n_pad)
    x_all = pad_rows_to(osd0_decode(llrx.T, code.hz_basis, red_sz).T, n_pad)
    assert torch.equal(whole[0], torch.where(flagged[None, :], x_all, res.x_hat))
    assert torch.equal(whole[1], torch.where(flagged[None, :], z_all, res.z_hat))


@pytest.mark.parametrize("seed", [22, 23])
def test_bp2_osd_count_without_a_cap_is_the_cap_of_the_batch(gb48, seed):
    code, _ = gb48
    hx, lx = np.asarray(code.hx), np.asarray(code.lx)
    basis, pivot = tc.row_basis(hx), tc.row_echelon(hx.T)[3]
    p, b = 0.08, 64
    noise = torch.as_tensor(np.random.default_rng(seed).random((hx.shape[1], b)) < p)
    args = (tc.build_graph(hx).to("cpu"), torch.as_tensor(hx), basis, pivot, lx, noise, p)
    whole = models.bp2_osd_count(*args, num_iter=6)
    capped = models.bp2_osd_count(*args, num_iter=6, osd_compact_cap=b)
    assert len(whole) == 2 and len(capped) == 3
    assert [int(o) for o in whole] == [int(o) for o in capped[:2]] and int(capped[2]) == 0
    assert int(whole[0]) > 0


def test_only_compact_decides_sub_batches():
    """The flagged-first sort is written in compact.py alone, and nothing
    imports the cascade's private names."""
    sort_at, private = [], []
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        if "argsort(torch.logical_not" in text:
            sort_at.append(path.relative_to(PACKAGE).as_posix())
        if "from .cascade import _" in text or "from .decoders.cascade import _" in text:
            private.append(path.name)
    assert sort_at == ["decoders/compact.py"] and private == []
