"""The port's probes (feedback_gnn_tpu_torch/probes.py, their plain
versions) against the Pallas probes of scripts/probe_pallas.py and
scripts/probe_pallas2.py, run as they are in interpret mode on the CPU.

The scripts are loaded from their files and their ``main()`` run with
``pallas_call`` wrapped so that it adds ``interpret=True`` and records each
kernel's inputs and output (through a debug callback, since three of the
calls run under ``jax.jit``).  Each recorded call's numpy inputs then go
through the port's plain version of that probe.

Tolerances: the gathers, shifts, the circulant copy and the three
64-iteration loops must be equal bit for bit (each loop iteration is one
float32 multiply, in the same order).  The three phi forms are held at
rtol = atol = 1e-5: XLA's and PyTorch's math libraries round differently,
and the forms amplify it where they cancel (softplus(a) - log(expm1(a))
near a = 5 leaves ~1e-6 of absolute float32 noise; exp(a) - 1 near
a = 1e-3 keeps ~4 significant digits, a few 1e-5 on phi ~ 7.6).  The CUDA kernels are held against the plain versions
in tests/test_torch_gpu.py.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from feedback_gnn_tpu_torch import obs, probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("probe_pallas", "probe_pallas2")
PHI_TOL = dict(rtol=1e-5, atol=1e-5)


def probe_launches():
    """Each probe wrapper's kernel launches so far."""
    return {name: obs.counter(f"probe.{name}.launches") for name in probes.WRAPPERS}


# Pallas kernel -> the port's plain version (with its default arguments,
# the scripts' constants)
PORT = {
    "k1": probes.take_rows_plain,
    "k2": probes.take_lanes_plain,
    "k2b": probes.take_along_lanes_plain,
    "k3": probes.roll_rows_plain,
    "k4": probes.circulant_copy_plain,
    "k5": probes.phi_softplus_expm1_plain,
    "k6": probes.gather_loop_plain,
    "ka": probes.take_along_rows_plain,
    "kb": probes.index_rows_plain,
    "kc": probes.phi_log_tanh_plain,
    "kd": probes.phi_exp_log1p_plain,
    "ke": probes.take_along_loop_plain,
    "kf": probes.roll_loop_plain,
}
PHI = {"k5", "kc", "kd"}


@pytest.fixture(scope="module")
def recorded():
    """{kernel name: (numpy inputs, numpy output)} of both scripts' first
    call of each Pallas kernel, in interpret mode."""
    rec = {}
    orig = pl.pallas_call

    def pallas_call(kernel, *args, **kwargs):
        call = orig(kernel, *args, interpret=True, **kwargs)
        name = kernel.__name__

        def run(*xs):
            out = call(*xs)

            def keep(*arrays):  # copies: the callback's arrays may alias buffers JAX reuses
                if name not in rec:
                    rec[name] = ([np.array(a) for a in arrays[:-1]], np.array(arrays[-1]))

            jax.debug.callback(keep, *xs, out)
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", pallas_call)
        for script in SCRIPTS:
            spec = importlib.util.spec_from_file_location(
                script, os.path.join(REPO, "scripts", f"{script}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.main()
    return rec


def test_every_pallas_probe_ran(recorded):
    assert sorted(recorded) == sorted(PORT)


@pytest.mark.parametrize("kernel", sorted(PORT))
def test_plain_matches_pallas_probe(recorded, kernel):
    inputs, ref = recorded[kernel]
    before = probe_launches()
    out = PORT[kernel](*(torch.from_numpy(a) for a in inputs)).numpy()
    assert probe_launches() == before
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if kernel in PHI:
        np.testing.assert_allclose(out, ref, **PHI_TOL)
    else:
        np.testing.assert_array_equal(out, ref)


# The plain phi forms and cn_update's softplus and phi, each the first
# transcendental call of a fresh process, called again on fresh copies of
# the scripts' input: every call must give the first call's bits, within
# PHI_TOL of JAX.  The first parallel call of PyTorch's CPU exp, log or
# tanh used to race MKL's one-time set-up and, in about one process in
# five, gave one thread's chunk other values (up to 1e-4 off) on that call
# alone; the package now sets MKL up at import (feedback_gnn_tpu_torch's
# _init_cpu_vml).  A process shows the race only on its first call, so each
# case runs DETERMINISM_PROCESSES of them, one after another: side by side
# they keep the cores busy, and the race rarely shows under load.
DETERMINISM_PROCESSES, DETERMINISM_CALLS = 2, 4
DETERMINISM_SCRIPT = """
import sys
import numpy as np
import torch
from feedback_gnn_tpu_torch import probes
from feedback_gnn_tpu_torch.decoders import cn_update
fns = {
    "k5": probes.phi_softplus_expm1_plain,
    "kc": probes.phi_log_tanh_plain,
    "kd": probes.phi_exp_log1p_plain,
    "softplus": cn_update.softplus,
    "phi": lambda t: cn_update.phi(t.abs() * 4.0, "expm1"),
}
x = np.load(sys.argv[1])
fn = fns[sys.argv[2]]
np.save(sys.argv[4], np.stack([fn(torch.from_numpy(np.array(x))).numpy() for _ in range(int(sys.argv[3]))]))
"""


def _jax_reference(recorded, case):
    from feedback_gnn_tpu.decoders import cn_update as jcn

    if case in PHI:
        return recorded[case][1]
    x = jax.numpy.asarray(recorded["k5"][0][0])
    if case == "softplus":
        return np.asarray(jax.nn.softplus(x))
    return np.asarray(jcn.phi(jax.numpy.abs(x) * 4.0, "expm1"))


@pytest.mark.parametrize("case", ["k5", "kc", "kd", "softplus", "phi"])
def test_cpu_phi_is_deterministic_in_fresh_processes(recorded, case, tmp_path):
    """Fault C4: the same bits on every call of a fresh process."""
    x_path = tmp_path / "x.npy"
    np.save(x_path, recorded["k5"][0][0])
    ref = _jax_reference(recorded, case)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    for k in range(DETERMINISM_PROCESSES):
        out_path = tmp_path / f"out{k}.npy"
        subprocess.run([sys.executable, "-c", DETERMINISM_SCRIPT, str(x_path), case, str(DETERMINISM_CALLS),
                        str(out_path)], check=True, env=env, timeout=120)
        outs = np.load(out_path)
        assert outs.shape == (DETERMINISM_CALLS, *ref.shape)
        for i, out in enumerate(outs):
            moved = int((out != outs[0]).sum())
            assert moved == 0, f"process {k}: call {i} moved {moved} elements from the first call's bits"
        np.testing.assert_allclose(outs[0], ref, **PHI_TOL)


def test_probe_inputs_are_the_scripts(recorded):
    """probe_inputs rebuilds the scripts' arrays from the same seed."""
    inp = {k: v.numpy() for k, v in probes.probe_inputs("cpu").items()}
    np.testing.assert_array_equal(inp["x_sub"], recorded["k1"][0][0])
    np.testing.assert_array_equal(inp["perm"], recorded["k1"][0][1])
    np.testing.assert_array_equal(inp["x_lane"], recorded["k2"][0][0])
    np.testing.assert_array_equal(inp["idx2"], recorded["k2b"][0][1])
    np.testing.assert_array_equal(inp["idx_full"], recorded["ka"][0][1])


@pytest.mark.parametrize("probe", probes.probe_cases(probes.probe_inputs("cpu")), ids=lambda p: p.key)
def test_wrapper_takes_plain_on_cpu(probe):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    before = probe_launches()
    out = probe.fn(*probe.args)
    assert probe_launches() == before
    assert probes.compare(probe, out, probe.plain(*probe.args)) == 0.0


@pytest.mark.parametrize("probe", probes.probe_cases(probes.probe_inputs("cpu")), ids=lambda p: p.key)
def test_wrapper_rejects_bad_inputs(probe):
    x, rest = probe.args[0], probe.args[1:]
    with pytest.raises(TypeError):
        probe.fn(x.double(), *rest)
    with pytest.raises(ValueError):
        probe.fn(x[None], *rest)
    if rest:
        with pytest.raises(TypeError):
            probe.fn(x, rest[0].long())
        with pytest.raises(ValueError):
            probe.fn(x, rest[0][:-1])


def test_phi_fast_mode_is_card_only():
    x = probes.probe_inputs("cpu")["x_sub"]
    for fn in (probes.phi_softplus_expm1, probes.phi_log_tanh, probes.phi_exp_log1p):
        with pytest.raises(ValueError, match="only in the CUDA kernel"):
            fn(x, fast=True)


def test_main_on_cpu(capsys):
    errs = probes.main("cpu", reps=1)
    assert sorted(errs) == sorted(PORT)
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("PASS ") for line in lines) == len(PORT)
    assert sum(line.startswith("TIME ") for line in lines) == 3


def test_cols_per_block():
    """One column per block for the loops, in clusters of 2 adjacent
    columns; a single pass a warp per (row, chunk) item."""
    cl = probes.LOOP_CLUSTER
    assert cl == 2
    # the scripts' [3840, 128]: 64 pairs, 960 threads x 4 rows, two buffers
    # of 3840 rows
    assert probes._loop_plan(3840, 128) == probes.LoopPlan(2, 128, 960, 4, 8 * 3840)
    # a short, wide column: one warp, a cluster for every 2 of 300000 columns
    assert probes._loop_plan(2, 300000) == probes.LoopPlan(2, 300000, 32, 1, 16)
    assert probes._loop_plan(33, 3) == probes.LoopPlan(2, 4, 64, 1, 8 * 33)
    # a single pass along rows of [3840, 128]: 3840 items of 128 floats,
    # 8 warps a block
    assert probes._pass_plan(3840, 128, 0, 132, True) == probes.PassPlan((480, 1), True)
    with pytest.raises(ValueError, match="does not fit"):
        probes._loop_plan(40000, 64)


# (rows, cols): the scripts' shape, the ragged shapes of the card's tests,
# fewer columns than a cluster, 8 k + 1 columns, rows that do not divide
# by the threads
PLAN_SHAPES = [(3840, 128), (1000, 37), (300, 531), (2, 300000), (1000, 1), (1000, 3),
               (1000, 8), (517, 17), (1025, 9), (3001, 5)]


@pytest.mark.parametrize("rows,cols", PLAN_SHAPES)
def test_loop_plan(rows, cols):
    """Clusters of 8 whole columns, the last masked; rows per thread the
    fewest instance that fits 1024 threads; whole warps; every row owned
    once; the slabs partition the rows."""
    plan = probes._loop_plan(rows, cols)
    cl = plan.cluster
    assert cl == probes.LOOP_CLUSTER
    assert plan.blocks % cl == 0 and plan.blocks - cl < cols <= plan.blocks
    masked = plan.blocks - cols  # blocks of the last cluster that own no column
    assert masked == (-cols) % cl
    assert plan.rows_per_thread in probes.LOOP_RPT
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= probes.MAX_THREADS
    assert plan.threads * plan.rows_per_thread >= rows
    smaller = [r for r in probes.LOOP_RPT if r < plan.rows_per_thread]
    assert all(-(-rows // r) > probes.MAX_THREADS for r in smaller)
    assert plan.threads - 32 < -(-rows // plan.rows_per_thread) <= plan.threads
    assert plan.smem_bytes == 8 * rows
    owned = np.sort(_owned_rows(plan, rows))
    np.testing.assert_array_equal(owned, np.arange(rows))
    bounds = [probes._slab(k, rows, cl) for k in range(cl)]
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(bounds[k][1] == bounds[k + 1][0] for k in range(cl - 1))


def test_loop_plan_at_the_shared_memory_limit():
    """Two buffers of 29056 rows are all a block's shared memory: 32 rows
    a thread, 928 threads; one row more is refused."""
    rows = probes.SMEM_LIMIT // 8
    assert rows == 29056
    assert probes._loop_plan(rows, 128) == probes.LoopPlan(2, 128, 928, 32, probes.SMEM_LIMIT)
    with pytest.raises(ValueError, match="does not fit"):
        probes._loop_plan(rows + 1, 128)


@pytest.mark.parametrize("rows,cols", PLAN_SHAPES + [(8, 3840), (1, 1)])
@pytest.mark.parametrize("axis", [0, 1])
def test_pass_plan(rows, cols, axis):
    """At most 8 blocks an SM; along rows one warp an item where the cap
    allows, float4s only where the columns come in fours; along lanes a
    row a block along y (capped at 65535)."""
    vec = cols % 4 == 0
    plan = probes._pass_plan(rows, cols, axis, 132, vec)
    gx, gy = plan.grid
    assert 1 <= gx <= probes.PASS_BLOCKS_PER_SM * 132
    if axis == 0:
        items = rows * -(-cols // (128 if vec else 32))
        assert gy == 1 and plan.vec == vec
        assert gx == min(-(-items // 8), probes.PASS_BLOCKS_PER_SM * 132)
    else:
        assert gy == min(rows, 65535) and not plan.vec
        assert gx * probes.PASS_THREADS >= min(cols, probes.PASS_BLOCKS_PER_SM * 132 * probes.PASS_THREADS)


# ------------------------------------------ the kernels' layout, emulated
#
# A numpy walk of csrc/probes.cu's loops and single passes in the launch
# plans' layout: which cluster rank loads and stores which slab of rows for
# which columns, which thread owns which rows (and so which indices it
# holds in registers), which warp takes which (row, chunk) item, and which
# lanes take which columns.  Every value starts as NaN, so a row, a column
# or an element that the layout misses shows; it must equal the plain
# versions bit for bit, and differ from them when the layout is mutated.


def _owned_rows(plan, rows):
    """Rows of thread t: t + q * threads for q < rows_per_thread, in
    (q, t) order; those past the last row are idle."""
    r = (np.arange(plan.threads)[None, :]
         + plan.threads * np.arange(plan.rows_per_thread)[:, None]).ravel()
    return r[r < rows]


class Layout:
    """The kernels' index layout; a test's mutation overrides one method."""

    def slab(self, rank, rows, cluster):
        return probes._slab(rank, rows, cluster)

    def cluster_columns(self, rank, plan, cols):
        """Columns whose owner is cluster rank ``rank``: the last cluster's
        missing columns masked."""
        c = np.arange(rank, plan.blocks, plan.cluster)
        return c[c < cols]

    def owned_rows(self, plan, rows):
        return _owned_rows(plan, rows)

    def result_buffer(self, iters):
        return iters % 2

    def lane_floats(self, vec):
        return 4 if vec else 1


def _emulate_loop(x, index, iters, scale, layout=None, plan=None):
    """resident_loop: x [R, C] float32; ``index`` the source rows, [R] (a
    table shared by every column, or the shift) or [R, C] (a full table,
    staged through the owner's second buffer); ``plan`` _loop_plan's
    unless given."""
    layout = layout or Layout()
    rows, cols = x.shape
    plan = plan or probes._loop_plan(rows, cols)
    buf = np.full((plan.blocks, 2, rows), np.nan, np.float32)
    full = index.ndim == 2
    staged = np.full((plan.blocks, rows), np.iinfo(np.int32).min, np.int64)
    for rank in range(plan.cluster):  # the load: rank's slab of every column
        lo, hi = layout.slab(rank, rows, plan.cluster)
        for j in range(plan.cluster):
            c = layout.cluster_columns(j, plan, cols)
            buf[c, 0, lo:hi] = x[lo:hi, c].T
            if full:
                staged[c, lo:hi] = index[lo:hi, c].T
    owners = np.arange(cols)
    r = layout.owned_rows(plan, rows)
    ix = staged[owners][:, r] if full else np.broadcast_to(index[r], (cols, len(r)))
    ok = (ix >= 0) & (ix < rows)
    a = 0
    for _ in range(iters):
        src = buf[owners, a]
        v = np.where(ok, np.take_along_axis(src, np.where(ok, ix, 0), 1), np.float32(np.nan))
        buf[owners[:, None], 1 - a, r[None, :]] = v * np.float32(scale)
        a = 1 - a
    res = buf[:, layout.result_buffer(iters)]
    out = np.full((rows, cols), np.nan, np.float32)
    for rank in range(plan.cluster):  # the store mirrors the load
        lo, hi = layout.slab(rank, rows, plan.cluster)
        for j in range(plan.cluster):
            c = layout.cluster_columns(j, plan, cols)
            out[lo:hi, c] = res[c, lo:hi].T
    return out


def _emulate_rows_pass(x, index, scale, layout=None):
    """probe_rows_pass_kernel: warps over (row, chunk) items in the grid's
    stride; ``index`` [R] (one source row a row) or [R, C] (a full table)."""
    layout = layout or Layout()
    rows, cols = x.shape
    vec = cols % 4 == 0
    plan = probes._pass_plan(rows, cols, 0, 132, vec)
    w = layout.lane_floats(vec)
    span = 32 * (4 if vec else 1)
    chunks = -(-cols // span)
    warps = plan.grid[0] * probes.PASS_THREADS // 32
    items = np.concatenate([np.arange(k, rows * chunks, warps) for k in range(warps)])
    r = items // chunks
    c0 = (items - r * chunks) * span
    c = (c0[:, None, None] + w * np.arange(32)[None, :, None] + np.arange(w)[None, None, :]).reshape(len(items), -1)
    r = np.broadcast_to(r[:, None], c.shape)
    keep = c < cols
    r, c = r[keep], c[keep]
    j = index[r, c] if index.ndim == 2 else index[r]
    ok = (j >= 0) & (j < rows)
    out = np.full((rows, cols), np.nan, np.float32)
    out[r, c] = np.where(ok, x[np.where(ok, j, 0), c], np.float32(np.nan)) * np.float32(scale)
    return out


def _emulate_lanes_pass(x, index, scale):
    """probe_lanes_pass_kernel: rows along the grid's y, a thread an element
    of the row along x, both striding; ``index`` [C] or [R, C]."""
    rows, cols = x.shape
    gx, gy = probes._pass_plan(rows, cols, 1, 132).grid
    out = np.full((rows, cols), np.nan, np.float32)
    ms = np.concatenate([np.arange(y, rows, gy) for y in range(gy)])
    ks = np.concatenate([np.arange(t, cols, gx * probes.PASS_THREADS)
                         for t in range(gx * probes.PASS_THREADS)])
    j = index[np.ix_(ms, ks)] if index.ndim == 2 else np.broadcast_to(index[ks], (len(ms), len(ks)))
    ok = (j >= 0) & (j < cols)
    out[np.ix_(ms, ks)] = np.where(ok, np.take_along_axis(x[ms], np.where(ok, j, 0), 1),
                                   np.float32(np.nan)) * np.float32(scale)
    return out


def _shift_rows(rows, shift, length):
    r = np.arange(rows)
    return np.where(r < length, (r + shift % length) % length, r)


def _emulated(key, x, idx, iters, layout=None, plan=None):
    """Probe ``key`` through the emulated kernel, as its wrapper launches it
    (a loop by ``plan`` if given)."""
    x = x.numpy()
    idx = None if idx is None else idx.numpy()
    rows = x.shape[0]
    scale = probes.LOOP_SCALE if key in ("k6", "ke", "kf") else 1.0
    if key in ("k6", "ke", "kf"):
        index = _shift_rows(rows, -probes.ROLL_SHIFT, rows) if key == "kf" else idx
        return _emulate_loop(x, index, iters, scale, layout, plan)
    if key in ("k2", "k2b"):
        return _emulate_lanes_pass(x, idx, scale)
    if key == "k3":
        idx = _shift_rows(rows, -probes.ROLL_SHIFT, rows)
    elif key == "k4":
        idx = _shift_rows(rows, probes.ROLL_SHIFT, probes.CIRC_LEN)
    return _emulate_rows_pass(x, idx, scale, layout)


EMULATED = ["k1", "k2", "k2b", "k3", "k4", "k6", "ka", "kb", "ke", "kf"]


@pytest.mark.parametrize("key", EMULATED)
def test_emulated_kernels_equal_plain_on_the_scripts_inputs(key):
    p = {q.key: q for q in probes.probe_cases(probes.probe_inputs("cpu"))}[key]
    idx = p.args[1] if len(p.args) > 1 else None
    out = _emulated(key, p.args[0], idx, p.iters)
    np.testing.assert_array_equal(out, p.plain(*p.args).numpy())


def _ragged(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(rows).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, rows, (rows, cols)).astype(np.int32))
    return x, perm, idx


@pytest.mark.parametrize("rows,cols", [(1000, 37), (300, 531), (2, 3000), (1000, 1), (1000, 3),
                                       (517, 17), (1025, 9), (3001, 5)])
def test_emulated_kernels_equal_plain_on_ragged_shapes(rows, cols):
    x, perm, idx = _ragged(rows, cols, 3)
    xt, permt = x.T.contiguous(), torch.from_numpy(np.random.default_rng(4).permutation(cols).astype(np.int32))
    cases = [
        ("k1", x, perm, 1, probes.take_rows_plain(x, perm)),
        ("ka", x, idx, 1, probes.take_along_rows_plain(x, idx)),
        ("k2", x, permt, 1, probes.take_lanes_plain(x, permt)),
        ("k2b", xt, idx.T.contiguous(), 1, probes.take_along_lanes_plain(xt, idx.T.contiguous())),
        ("k3", x, None, 1, probes.roll_rows_plain(x)),
        ("k6", x, perm, 5, probes.gather_loop_plain(x, perm, 5)),
        ("k6", x, perm, 2, probes.gather_loop_plain(x, perm, 2)),
        ("ke", x, idx, 5, probes.take_along_loop_plain(x, idx, 5)),
        ("kf", x, None, 3, probes.roll_loop_plain(x, 3)),
    ]
    if rows >= probes.CIRC_LEN:
        cases.append(("k4", x, None, 1, probes.circulant_copy_plain(x)))
    for key, a, i, iters, ref in cases:
        np.testing.assert_array_equal(_emulated(key, a, i, iters), ref.numpy(), err_msg=key)


@pytest.mark.parametrize("cluster", [1, 4, 8])
@pytest.mark.parametrize("rows,cols", [(3840, 128), (1000, 37), (300, 3)])
def test_emulated_loops_in_other_clusters(cluster, rows, cols):
    """The layout holds for the other cluster sizes the card's plan grid
    launches: slabs of rows / cluster, the last cluster masked."""
    x, perm, idx = _ragged(rows, cols, 10)
    base = probes._loop_plan(rows, cols)
    plan = probes.LoopPlan(cluster, -(-cols // cluster) * cluster, base.threads, base.rows_per_thread,
                           base.smem_bytes)
    for key, i, ref in [("k6", perm, probes.gather_loop_plain(x, perm, 3)),
                        ("ke", idx, probes.take_along_loop_plain(x, idx, 3)),
                        ("kf", None, probes.roll_loop_plain(x, 3))]:
        np.testing.assert_array_equal(_emulated(key, x, i, 3, plan=plan), ref.numpy(), err_msg=key)


def test_emulated_out_of_range_index_gives_nan():
    """An index outside [0, rows) reads no row: NaN there, and through the
    loop's iterations wherever that row's value travels."""
    x, perm, _ = _ragged(300, 37, 5)
    bad = perm.clone()
    bad[7], bad[100] = -1, 300
    out = _emulated("k1", x, bad, 1)
    assert np.isnan(out[[7, 100]]).all() and not np.isnan(np.delete(out, [7, 100], 0)).any()
    ref = x.numpy().copy()
    for _ in range(3):
        nxt = ref[np.clip(bad.numpy(), 0, 299)] * np.float32(probes.LOOP_SCALE)
        nxt[[7, 100]] = np.nan
        ref = nxt
    np.testing.assert_array_equal(_emulated("k6", x, bad, 3), ref)


class _SlabGap(Layout):
    def slab(self, rank, rows, cluster):
        lo, hi = probes._slab(rank, rows, cluster)
        return lo, hi - (rank == cluster - 1)


class _SlabShifted(Layout):
    def slab(self, rank, rows, cluster):
        lo, hi = probes._slab(rank, rows, cluster)
        return min(lo + 1, rows), min(hi + 1, rows)


class _MaskOneShort(Layout):  # the last cluster masks one column too many
    def cluster_columns(self, rank, plan, cols):
        c = np.arange(rank, plan.blocks, plan.cluster)
        return c[c < cols - 1]


class _RowsByThread(Layout):  # thread t owns rows t * rpt + q: one thread short
    def owned_rows(self, plan, rows):
        r = np.arange(plan.threads - 1)[:, None] * plan.rows_per_thread + np.arange(plan.rows_per_thread)
        r = r.ravel()
        return r[r < rows]


class _WrongBuffer(Layout):
    def result_buffer(self, iters):
        return 1 - iters % 2


class _OneFloatALane(Layout):  # a lane of a float4 chunk moves one float
    def lane_floats(self, vec):
        return 1


@pytest.mark.parametrize("layout,key,shape", [
    (_SlabGap, "k6", (1000, 37)),
    (_SlabShifted, "ke", (300, 531)),
    (_MaskOneShort, "k6", (1000, 37)),
    (_RowsByThread, "kf", (3840, 16)),
    (_WrongBuffer, "kf", (1000, 37)),
    (_OneFloatALane, "k1", (300, 128)),
], ids=["slab_gap", "slab_shifted", "mask_one_short", "rows_by_thread", "wrong_buffer",
        "one_float_a_lane"])
def test_emulation_fails_on_a_mutated_layout(layout, key, shape):
    x, perm, idx = _ragged(*shape, 8)
    i = {"k6": perm, "k1": perm, "ke": idx, "kf": None}[key]
    iters = {"k1": 1}.get(key, 4)
    ref = _emulated(key, x, i, iters)
    assert not np.isnan(ref).any()
    out = _emulated(key, x, i, iters, layout())
    assert not np.array_equal(out, ref, equal_nan=True)


def test_circulant_copy_needs_its_rows():
    x = probes.probe_inputs("cpu")["x_sub"]
    assert probes.circulant_copy(x[:probes.CIRC_LEN]).shape == (probes.CIRC_LEN, probes.B)
    with pytest.raises(ValueError, match="fewer than"):
        probes.circulant_copy(x[:probes.CIRC_LEN - 1])


@pytest.mark.parametrize("fn,args", [
    (probes.gather_loop, ("x", "perm")),
    (probes.take_along_loop, ("x", "idx_full")),
    (probes.roll_loop, ("x",)),
], ids=lambda v: getattr(v, "__name__", ""))
def test_loops_reject_no_iterations(fn, args):
    inp = dict(probes.probe_inputs("cpu"), x=probes.probe_inputs("cpu")["x_sub"])
    with pytest.raises(ValueError, match="iteration count"):
        fn(*(inp[a] for a in args), iters=0)


# ------------------------------------------------- phi's launch, emulated
#
# csrc/probes.cu's probe_phi_kernel in the layout of _phi_plan: block b's
# thread t takes, at grid-stride step s, the units (s * grid + b) *
# threads * per_thread + j * threads + t for j < per_thread (float4s where
# the plan says vec, else floats), and with vec the n % 4 floats past the
# last float4 go one to each of the grid's first threads.  Every float of
# [0, n) must be read and written exactly once, and none past n.

PHI_NS = [0, 1, 3, 4, 5, 127, 128, 491519, 491520, 491523]


class PhiLayout:
    """The kernel's element-to-thread layout; a mutation overrides one
    method."""

    def step(self, plan):  # units between a thread's grid-stride steps
        return plan.grid * plan.threads * plan.per_thread

    def tail(self, n, units, plan):  # floats past the last float4
        t = np.arange(plan.grid * plan.threads)
        k = 4 * units + t
        return k[k < n]


def _emulate_phi(n, plan, layout=None):
    """The float indices each thread of ``plan``'s launch reads and writes,
    in one array (a float4 unit as its four floats)."""
    layout = layout or PhiLayout()
    w = 4 if plan.vec else 1
    units = n // w
    span = plan.threads * plan.per_thread
    base0 = (np.arange(plan.grid)[:, None] * span + np.arange(plan.threads)[None, :]).ravel()
    steps = -(-units // layout.step(plan)) if units else 0
    base = (base0[None, :] + layout.step(plan) * np.arange(steps)[:, None]).ravel()
    base = base[base < units]
    u = (base[:, None] + plan.threads * np.arange(plan.per_thread)[None, :]).ravel()
    u = u[u < units]
    floats = (w * u[:, None] + np.arange(w)[None, :]).ravel()
    if plan.vec:
        floats = np.concatenate([floats, layout.tail(n, units, plan)])
    return floats


def _covered_once(n, floats):
    return bool(((floats >= 0) & (floats < n)).all()) and bool((np.bincount(floats, minlength=n) == 1).all())


@pytest.mark.parametrize("n", PHI_NS)
@pytest.mark.parametrize("sms", [132, 2])
def test_phi_plan(n, sms):
    """float4 units only on aligned pointers and from 4 floats on; one a
    thread; at most the resident blocks; whole warps, the fewer while the
    units leave resident threads idle."""
    for aligned in (True, False):
        plan = probes._phi_plan(n, sms, aligned)
        assert plan.vec == (aligned and n >= 4)
        units = n // 4 if plan.vec else n
        few = units < sms * probes.PHI_RESIDENT_THREADS
        assert plan.threads == (probes.PHI_THREADS_FEW if few else probes.PHI_THREADS_MANY)
        assert plan.threads % 32 == 0 and plan.threads <= probes.PHI_MAX_THREADS
        assert plan.per_thread == 1 and plan.per_thread in probes.PHI_PER_THREAD
        resident = sms * probes.PHI_RESIDENT_THREADS // plan.threads
        assert 1 <= plan.grid <= resident
        assert plan.grid == max(1, min(-(-units // plan.threads), resident))


def test_phi_plan_at_the_probe_and_throughput_shapes():
    """[3840, 128]: 122,880 float4s, fewer than the 135,168 threads of 132
    SMs, so one a thread in 960 blocks of 128; [3840, 8192]: the 264
    resident blocks of 512 stride over 7,864,320 float4s."""
    assert probes._phi_plan(3840 * 128, 132) == probes.PhiPlan(True, 1, 128, 960)
    assert probes._phi_plan(3840 * 8192, 132) == probes.PhiPlan(True, 1, 512, 264)
    assert probes._phi_plan(3840 * 128, 132, False) == probes.PhiPlan(False, 1, 512, 264)
    assert probes._phi_plan(3840 * 128, 132, True, 4, 256) == probes.PhiPlan(True, 4, 256, 120)


@pytest.mark.parametrize("n", PHI_NS)
@pytest.mark.parametrize("sms", [132, 2])
def test_emulated_phi_covers_every_element_once(n, sms):
    for aligned in (True, False):
        plan = probes._phi_plan(n, sms, aligned)
        assert _covered_once(n, _emulate_phi(n, plan))
    # other plans of the card's grid, and one block
    for pt in probes.PHI_PER_THREAD:
        for threads in (32, 128, 512):
            plan = probes._phi_plan(n, sms, True, pt, threads)
            assert _covered_once(n, _emulate_phi(n, plan))
            assert _covered_once(n, _emulate_phi(n, probes.PhiPlan(plan.vec, pt, threads, 1)))


@pytest.mark.parametrize("rows,cols", [(3840, 128), (1, 5), (517, 17)])
def test_emulated_phi_on_a_misaligned_view(rows, cols):
    """A contiguous [rows, cols] view 4 bytes into a flat buffer: not 16-byte
    aligned, so a float a unit, every float once; the values are the plain
    version's."""
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(rows * cols + 1).astype(np.float32))[1:]
    x = x.view(rows, cols)
    assert x.is_contiguous() and not probes._aligned(x)
    plan = probes._phi_plan(x.numel(), 132, probes._aligned(x, torch.empty_like(x)))
    assert not plan.vec
    floats = _emulate_phi(x.numel(), plan)
    assert _covered_once(x.numel(), floats)
    out = np.full(x.numel(), np.nan, np.float32)
    out[floats] = probes.phi_softplus_expm1_plain(x).numpy().ravel()[floats]
    np.testing.assert_array_equal(out.reshape(rows, cols), probes.phi_softplus_expm1(x).numpy())


class _PhiNoTail(PhiLayout):
    def tail(self, n, units, plan):
        return np.zeros(0, np.int64)


class _PhiStrideOffByOne(PhiLayout):  # one float4 short of the grid's span
    def step(self, plan):
        return plan.grid * plan.threads * plan.per_thread - 1


class _PhiBlockStride(PhiLayout):  # each block strides by its own span: the grid's steps overlap
    def step(self, plan):
        return plan.threads * plan.per_thread


@pytest.mark.parametrize("layout", [_PhiNoTail, _PhiStrideOffByOne, _PhiBlockStride],
                         ids=["no_tail", "stride_off_by_one", "overlapping_strides"])
def test_emulated_phi_fails_on_a_mutated_layout(layout):
    """n = 491,523 on 2 SMs: several grid-stride steps and a tail of 3."""
    n = 491523
    plan = probes._phi_plan(n, 2)
    assert plan.vec and plan.grid > 1 and n // 4 > plan.grid * plan.threads * plan.per_thread
    assert _covered_once(n, _emulate_phi(n, plan))
    assert not _covered_once(n, _emulate_phi(n, plan, layout()))
