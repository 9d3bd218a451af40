"""Probes of the data movement and the transcendentals that the fused
quasi-cyclic BP kernels are built from: CUDA kernels and their plain
PyTorch versions.

The Pallas scripts ``scripts/probe_pallas.py`` (k1-k6) and
``scripts/probe_pallas2.py`` (ka-kf) asked the TPU these questions; this
module asks them of the card, one wrapper per probe:

===========  =====================  ==========================================
probe        wrapper                computes
===========  =====================  ==========================================
k1           ``take_rows``          ``x[perm]``: rows of [E, B] by a table
k2           ``take_lanes``         ``x[:, perm]``: lanes of [8, E]
k2b          ``take_along_lanes``   ``take_along_axis(x, idx, 1)``, idx [8, E]
k3           ``roll_rows``          ``np.roll(x, 13, 0)``
k4           ``circulant_copy``     out[i] = x[(i + 13) mod 127], i < 127;
                                    out[127] = x[127]
k5           ``phi_softplus_expm1`` softplus(a) - log(expm1(a)), a = |x|+1e-3
k6           ``gather_loop``        64 x (``x[perm]`` then x 1.0001)
ka           ``take_along_rows``    ``take_along_axis(x, idx, 0)``, idx [E, B]
kb           ``index_rows``         ``x[idx, :]``, the function of k1
kc           ``phi_log_tanh``       -log(tanh(a / 2))
kd           ``phi_exp_log1p``      log1p(exp(-a)) - log(exp(a) - 1) + a
ke           ``take_along_loop``    64 x (ka's gather then x 1.0001)
kf           ``roll_loop``          64 x (k3's roll then x 1.0001)
===========  =====================  ==========================================

``csrc/probes.cu`` serves them through three entry points: a gather
through an index table, a shift whose index is computed, and phi.  The
gather and the shift each take a single pass (whole rows a warp at a time,
or a thread an element along lanes) or, for the loops, a resident kernel
that holds each column in shared memory for every iteration; phi takes
a grid-stride pass over float4s, one instance for each form and mode.  The
launch plans (``_pass_plan``, ``_loop_plan``, ``_phi_plan``) are chosen
here.  A wrapper given CUDA
tensors launches its kernel (or raises); given CPU tensors it takes its
plain version, ``<wrapper>_plain``.  Each launch adds one to the counter
``probe.<wrapper>.launches`` (``obs.counter``); the plain versions do not
count.  Indices are
int32 and lie in [0, length of the gathered axis).

    python -m feedback_gnn_tpu_torch.probes [--device cpu]

runs every probe on the scripts' inputs against its plain version and
times the three loops.  No decoder reaches this module.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import obs, resolve_device
from .decoders.bp4_qc import SMEM_LIMIT
from .decoders.cn_update import softplus

__all__ = [
    "take_rows", "take_lanes", "take_along_lanes", "roll_rows", "circulant_copy",
    "phi_softplus_expm1", "gather_loop", "take_along_rows", "index_rows", "phi_log_tanh",
    "phi_exp_log1p", "take_along_loop", "roll_loop", "Probe", "probe_inputs", "probe_cases",
    "main", "phi_last_launch",
]

# the scripts' shapes and constants
E, B, LANES = 3840, 128, 8
ROLL_SHIFT, CIRC_LEN, CIRC_ROWS = 13, 127, 128
LOOP_ITERS, LOOP_SCALE = 64, 1.0001
PHI_OFFSET = 1e-3

PHI_FORMS = ("softplus_expm1", "log_tanh", "exp_log1p")  # csrc/probes.cu's order
MAX_THREADS = 1024
# csrc/probes.cu's launch constants.  The loops' cluster is a pair of
# adjacent columns: on an H100 (132 SMs) all 64 pairs of [3840, 128] run
# side by side, one block to an SM.  The card puts two blocks of clusters
# of 4 or 8 on one SM, which doubles an iteration's time, and padded to
# one block an SM they do not all fit at once (15 clusters of 8):
# chip_smoke.py's loop plan grid.  LOOP_RPT:
# the loop instances by rows per thread.  The single passes: blocks of
# PASS_THREADS, at most PASS_BLOCKS_PER_SM blocks an SM.
LOOP_CLUSTER = 2
LOOP_RPT = (1, 2, 4, 8, 16, 32)
PASS_THREADS, PASS_BLOCKS_PER_SM = 256, 8
# phi: the instances by units (float4s, or floats) a thread and step; at
# most PHI_MAX_THREADS threads a block; every instance keeps
# PHI_RESIDENT_THREADS threads an SM resident (__launch_bounds__(512, 2):
# at most 64 registers a thread), which caps the grid.  The plan's rules
# are the winners of chip_smoke.py's plan grid on an H100 (1, 2 or 4
# units a thread x 32 to 512 threads, at [3840, 128] and [3840, 8192]):
# one unit a thread (the next step's, loaded ahead, is the second in
# flight), blocks of PHI_THREADS_FEW while the units leave resident threads
# idle, of PHI_THREADS_MANY once the grid strides.
PHI_PER_THREAD = (1, 2, 4)
PHI_THREADS_FEW, PHI_THREADS_MANY = 128, 512
PHI_MAX_THREADS, PHI_RESIDENT_THREADS = 512, 1024

WRAPPERS = (
    "take_rows", "take_lanes", "take_along_lanes", "roll_rows", "circulant_copy",
    "phi_softplus_expm1", "gather_loop", "take_along_rows", "index_rows", "phi_log_tanh",
    "phi_exp_log1p", "take_along_loop", "roll_loop",
)


# ---------------------------------------------------------------- checks


def _device(*tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_x(x):
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _check_idx(idx, shape):
    if idx.dtype != torch.int32:
        raise TypeError(f"index must be int32, got {idx.dtype}")
    if tuple(idx.shape) != tuple(shape):
        raise ValueError(f"index shape {tuple(idx.shape)} != {tuple(shape)}")
    if not idx.is_contiguous():
        raise ValueError("index must be contiguous")


def _check_iters(iters):
    if int(iters) < 1:
        raise ValueError(f"iteration count must be >= 1, got {iters}")


# --------------------------------------------------------------- launches


@dataclass(frozen=True)
class LoopPlan:
    """A loop's launch (csrc/probes.cu's resident_loop): one block per
    column in clusters of ``cluster`` adjacent columns, the last cluster's
    missing columns masked; ``threads`` threads, each owning the rows
    ``t + q * threads`` for q < ``rows_per_thread``; two buffers of the
    column's rows in shared memory (a full index table is staged in the
    second)."""

    cluster: int
    blocks: int
    threads: int
    rows_per_thread: int
    smem_bytes: int


@dataclass(frozen=True)
class PassPlan:
    """A single pass's launch: a grid of ``grid`` blocks of PASS_THREADS.
    Along rows a warp takes one (row, chunk) item at a time, a chunk being
    32 lanes of 4 floats (``vec``) or of 1; along lanes a thread takes an
    element, the grid's y striding over rows and x over columns."""

    grid: tuple[int, int]
    vec: bool


@dataclass(frozen=True)
class PhiPlan:
    """phi's launch: ``grid`` blocks of ``threads``; at each grid-stride
    step a thread takes ``per_thread`` units, float4s where ``vec`` (both
    pointers 16-byte aligned, n >= 4) and floats otherwise, and with
    ``vec`` the n % 4 floats past the last float4 go one to each of the
    grid's first threads."""

    vec: bool
    per_thread: int
    threads: int
    grid: int


def _up(n, k):
    return -(-n // k) * k


def _loop_plan(rows, cols) -> LoopPlan:
    """Clusters of LOOP_CLUSTER columns; the fewest rows per thread (a
    LOOP_RPT instance) that keep the block within MAX_THREADS, and a whole
    number of warps for them."""
    smem = 2 * 4 * rows
    if smem > SMEM_LIMIT:
        raise ValueError(f"a column of {rows} rows does not fit a block's shared memory")
    rpt = next(r for r in LOOP_RPT if -(-rows // r) <= MAX_THREADS)
    return LoopPlan(LOOP_CLUSTER, _up(cols, LOOP_CLUSTER), _up(-(-rows // rpt), 32), rpt, smem)


def _slab(rank, rows, cluster=LOOP_CLUSTER):
    """The rows [lo, hi) that block ``rank`` of a cluster loads and stores
    for all the cluster's columns (csrc/probes.cu's slab_begin)."""
    return rank * rows // cluster, (rank + 1) * rows // cluster


def _pass_plan(rows, cols, axis, sms, vec=False) -> PassPlan:
    """Along rows (axis 0) one warp an item, as many blocks as there are
    items for their warps, at most PASS_BLOCKS_PER_SM blocks an SM; along
    lanes (axis 1) a thread an element of a row, up to the same cap of
    blocks along x, one row a block along y (at most 65535, striding)."""
    cap = PASS_BLOCKS_PER_SM * sms
    if axis == 0:
        items = rows * -(-cols // (32 * (4 if vec else 1)))
        return PassPlan((max(1, min(-(-items // (PASS_THREADS // 32)), cap)), 1), vec)
    return PassPlan((max(1, min(-(-cols // PASS_THREADS), cap)), min(rows, 65535)), False)


def _phi_plan(n, sms, aligned=True, per_thread=1, threads=None) -> PhiPlan:
    """float4 units where the pointers are ``aligned`` and n >= 4; one a
    thread and step; blocks of PHI_THREADS_FEW threads while the units are
    fewer than the threads ``sms`` SMs hold at once (PHI_RESIDENT_THREADS
    each), else of PHI_THREADS_MANY; as many blocks as the units need, at
    most the resident ones.  ``per_thread`` and ``threads`` given: that
    shape (chip_smoke.py's plan grid)."""
    vec = aligned and n >= 4
    units = n // 4 if vec else n
    if threads is None:
        threads = PHI_THREADS_FEW if units < sms * PHI_RESIDENT_THREADS else PHI_THREADS_MANY
    resident = sms * PHI_RESIDENT_THREADS // threads
    return PhiPlan(vec, per_thread, threads, max(1, min(-(-units // (threads * per_thread)), resident)))


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _vec(cols, *tensors):
    """16-byte accesses along rows: whole float4s a row, aligned pointers."""
    return cols % 4 == 0 and _aligned(*tensors)


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _output(x):
    if x.numel() >= 2**31:
        raise ValueError("the probe kernels index with 32-bit ints: at most 2**31 - 1 elements")
    return torch.empty_like(x)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.fgt_cuda_error_string(err).decode()}")


def _plan_args(x, iters, axis, *aligned, plan=None):
    """(vec, rows per thread, cluster, threads, grid x, grid y, shared
    bytes) of a gather or shift launch: a loop's LoopPlan (``plan``, else
    _loop_plan's), or a single pass's PassPlan (rows per thread 0)."""
    rows, cols = x.shape
    if iters > 1:
        lp = plan or _loop_plan(rows, cols)
        return 0, lp.rows_per_thread, lp.cluster, lp.threads, lp.blocks, 1, lp.smem_bytes
    vec = axis == 0 and _vec(cols, *aligned)
    pp = _pass_plan(rows, cols, axis, _sms(x.device.index), vec)
    return int(pp.vec), 0, 1, PASS_THREADS, *pp.grid, 0


def loop_clusters(kind, plan: LoopPlan) -> int:
    """How many clusters of ``plan``'s launch the card holds at once (kind
    0: a gather with one index a row, 1: with a full table, 2: the shift)."""
    from ._build import load_kernels

    lib = load_kernels()
    n = ctypes.c_int(0)
    err = lib.fgt_probe_loop_clusters(kind, plan.rows_per_thread, plan.cluster, plan.threads,
                                      plan.blocks, plan.smem_bytes, ctypes.byref(n))
    _raise_on(lib, err, "cluster occupancy query of the loop")
    return n.value


def _launch_gather(name, x, idx, axis, iters=1, scale=1.0, plan=None):
    """out[r, c] = x[idx(r, c), c] along ``axis`` (idx a table of that
    axis's length, or of x's shape), ``iters`` times, each times ``scale``;
    the loops (iters > 1) along rows only, by ``plan`` if given (a LoopPlan,
    to measure others than _loop_plan's)."""
    from ._build import load_kernels

    lib = load_kernels()
    out = _output(x)
    if x.numel() == 0:
        return out
    full = idx.dim() == 2
    args = _plan_args(x, iters, axis, x, out, *((idx,) if full else ()), plan=plan)
    with torch.cuda.device(x.device):
        err = lib.fgt_probe_gather_launch(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), *x.shape, axis, int(full), int(iters),
            ctypes.c_float(scale), *args, _stream(x.device),
        )
    _raise_on(lib, err, name)
    obs.count(f"probe.{name}.launches")
    return out


def _launch_shift(name, x, shift, length, iters=1, scale=1.0, plan=None):
    """out[i] = x[(i + shift) mod length] along rows for i < length, x[i]
    past it, ``iters`` times, each times ``scale``; ``plan`` as for
    _launch_gather."""
    from ._build import load_kernels

    lib = load_kernels()
    out = _output(x)
    if x.numel() == 0:
        return out
    vec, rpt, cluster, threads, blocks, _, smem = _plan_args(x, iters, 0, x, out, plan=plan)
    with torch.cuda.device(x.device):
        err = lib.fgt_probe_shift_launch(
            x.data_ptr(), out.data_ptr(), *x.shape, int(shift) % length, length, int(iters),
            ctypes.c_float(scale), vec, rpt, cluster, threads, blocks, smem, _stream(x.device),
        )
    _raise_on(lib, err, name)
    obs.count(f"probe.{name}.launches")
    return out


def _launch_phi(name, x, form, fast, plan=None):
    """phi of x in ``form``, by ``plan`` if given (a PhiPlan, to measure
    others than _phi_plan's), else _phi_plan's."""
    from ._build import load_kernels

    lib = load_kernels()
    out = _output(x)
    if x.numel() == 0:
        return out
    plan = plan or _phi_plan(x.numel(), _sms(x.device.index), _aligned(x, out))
    with torch.cuda.device(x.device):
        err = lib.fgt_probe_phi_launch(x.data_ptr(), out.data_ptr(), x.numel(), PHI_FORMS.index(form),
                                       int(fast), int(plan.vec), plan.per_thread, plan.threads, plan.grid,
                                       _stream(x.device))
    _raise_on(lib, err, name)
    obs.count(f"probe.{name}.launches")
    return out


def phi_last_launch() -> PhiPlan:
    """The shape of the last phi launch the kernel library made."""
    from ._build import load_kernels

    shape = (ctypes.c_int * 4)()
    load_kernels().fgt_probe_phi_last_launch(shape)
    return PhiPlan(bool(shape[0]), *shape[1:])


# ------------------------------------------------------ gathers and shifts


def take_rows_plain(x, perm):
    return torch.index_select(x, 0, perm)


def take_rows(x, perm):
    """k1: ``jnp.take(x, perm, axis=0)`` of x [R, C] by perm [R]."""
    _check_x(x)
    _check_idx(perm, x.shape[:1])
    if _device(x, perm).type == "cuda":
        return _launch_gather("take_rows", x, perm, 0)
    return take_rows_plain(x, perm)


def index_rows_plain(x, idx):
    return x[idx]


def index_rows(x, idx):
    """kb: ``x[idx, :]`` of x [R, C] by idx [R]: the function of k1."""
    _check_x(x)
    _check_idx(idx, x.shape[:1])
    if _device(x, idx).type == "cuda":
        return _launch_gather("index_rows", x, idx, 0)
    return index_rows_plain(x, idx)


def take_lanes_plain(x, perm):
    return torch.index_select(x, 1, perm)


def take_lanes(x, perm):
    """k2: ``jnp.take(x, perm, axis=1)`` of x [R, C] by perm [C]."""
    _check_x(x)
    _check_idx(perm, x.shape[1:])
    if _device(x, perm).type == "cuda":
        return _launch_gather("take_lanes", x, perm, 1)
    return take_lanes_plain(x, perm)


def take_along_lanes_plain(x, idx):
    return torch.gather(x, 1, idx.long())


def take_along_lanes(x, idx):
    """k2b: ``jnp.take_along_axis(x, idx, axis=1)``, idx of x's shape."""
    _check_x(x)
    _check_idx(idx, x.shape)
    if _device(x, idx).type == "cuda":
        return _launch_gather("take_along_lanes", x, idx, 1)
    return take_along_lanes_plain(x, idx)


def take_along_rows_plain(x, idx):
    return torch.gather(x, 0, idx.long())


def take_along_rows(x, idx):
    """ka: ``jnp.take_along_axis(x, idx, axis=0)``, idx of x's shape."""
    _check_x(x)
    _check_idx(idx, x.shape)
    if _device(x, idx).type == "cuda":
        return _launch_gather("take_along_rows", x, idx, 0)
    return take_along_rows_plain(x, idx)


def roll_rows_plain(x):
    return torch.roll(x, ROLL_SHIFT, 0)


def roll_rows(x):
    """k3: ``pltpu.roll(x, 13, axis=0)``, which is ``np.roll``:
    out[i] = x[(i - 13) mod R]."""
    _check_x(x)
    if _device(x).type == "cuda":
        return _launch_shift("roll_rows", x, -ROLL_SHIFT, x.shape[0])
    return roll_rows_plain(x)


def circulant_copy_plain(x):
    return torch.cat([torch.roll(x[:CIRC_LEN], -ROLL_SHIFT, 0), x[CIRC_LEN:]])


def circulant_copy(x):
    """k4: out[i] = x[(i + 13) mod 127] for i < 127, out[i] = x[i] past it
    (the opposite direction to ``roll_rows``); x has at least 127 rows."""
    _check_x(x)
    if x.shape[0] < CIRC_LEN:
        raise ValueError(f"x has {x.shape[0]} rows, fewer than {CIRC_LEN}")
    if _device(x).type == "cuda":
        return _launch_shift("circulant_copy", x, ROLL_SHIFT, CIRC_LEN)
    return circulant_copy_plain(x)


# ------------------------------------------------------------------ loops


def gather_loop_plain(x, perm, iters=LOOP_ITERS):
    acc = x
    for _ in range(iters):
        acc = torch.index_select(acc, 0, perm) * LOOP_SCALE
    return acc


def gather_loop(x, perm, iters=LOOP_ITERS):
    """k6: ``iters`` times (``take_rows`` then times 1.0001)."""
    _check_x(x)
    _check_idx(perm, x.shape[:1])
    _check_iters(iters)
    if _device(x, perm).type == "cuda":
        return _launch_gather("gather_loop", x, perm, 0, iters, LOOP_SCALE)
    return gather_loop_plain(x, perm, iters)


def take_along_loop_plain(x, idx, iters=LOOP_ITERS):
    acc, idx = x, idx.long()
    for _ in range(iters):
        acc = torch.gather(acc, 0, idx) * LOOP_SCALE
    return acc


def take_along_loop(x, idx, iters=LOOP_ITERS):
    """ke: ``iters`` times (``take_along_rows`` then times 1.0001)."""
    _check_x(x)
    _check_idx(idx, x.shape)
    _check_iters(iters)
    if _device(x, idx).type == "cuda":
        return _launch_gather("take_along_loop", x, idx, 0, iters, LOOP_SCALE)
    return take_along_loop_plain(x, idx, iters)


def roll_loop_plain(x, iters=LOOP_ITERS):
    acc = x
    for _ in range(iters):
        acc = torch.roll(acc, ROLL_SHIFT, 0) * LOOP_SCALE
    return acc


def roll_loop(x, iters=LOOP_ITERS):
    """kf: ``iters`` times (``roll_rows`` then times 1.0001)."""
    _check_x(x)
    _check_iters(iters)
    if _device(x).type == "cuda":
        return _launch_shift("roll_loop", x, -ROLL_SHIFT, x.shape[0], iters, LOOP_SCALE)
    return roll_loop_plain(x, iters)


# -------------------------------------------------------------------- phi


def phi_softplus_expm1_plain(x):
    a = x.abs() + PHI_OFFSET
    return softplus(a) - torch.log(torch.expm1(a))


def phi_log_tanh_plain(x):
    a = x.abs() + PHI_OFFSET
    return -torch.log(torch.tanh(a * 0.5))


def phi_exp_log1p_plain(x):
    a = x.abs() + PHI_OFFSET
    return torch.log1p(torch.exp(-a)) - torch.log(torch.exp(a) - 1.0) + a


def _phi(name, form, plain, x, fast):
    _check_x(x)
    if _device(x).type == "cuda":
        return _launch_phi(name, x, form, fast)
    if fast:
        raise ValueError("the fast transcendentals exist only in the CUDA kernel")
    return plain(x)


def phi_softplus_expm1(x, fast=False):
    """k5: softplus(a) - log(expm1(a)) with a = |x| + 1e-3.  ``fast`` (card
    only, for timing) takes __expf/__logf in place of the accurate forms."""
    return _phi("phi_softplus_expm1", "softplus_expm1", phi_softplus_expm1_plain, x, fast)


def phi_log_tanh(x, fast=False):
    """kc: -log(tanh(a / 2)) with a = |x| + 1e-3; ``fast`` as above, with
    tanh.approx.f32."""
    return _phi("phi_log_tanh", "log_tanh", phi_log_tanh_plain, x, fast)


def phi_exp_log1p(x, fast=False):
    """kd: log1p(exp(-a)) - log(exp(a) - 1) + a with a = |x| + 1e-3;
    ``fast`` as above."""
    return _phi("phi_exp_log1p", "exp_log1p", phi_exp_log1p_plain, x, fast)


def phi_reference(x):
    """phi(a) = log((e^a + 1) / (e^a - 1)), the function all three forms
    compute, evaluated in float64 at the float32 a = |x| + 1e-3: the yardstick
    of each form's error in either mode."""
    a = (x.abs() + PHI_OFFSET).double()
    return torch.log1p(2.0 / torch.expm1(a))


# ------------------------------------------------------------- the probes


@dataclass(frozen=True)
class Probe:
    """One probe on its inputs: ``fn(*args)`` against ``plain(*args)``."""

    key: str  # the Pallas kernel's name in its script
    name: str  # the wrapper
    replaces: str  # file:line of the Pallas call
    fn: Callable
    plain: Callable
    args: tuple
    exact: bool  # data movement and loops: equal bit for bit; phi: PHI_TOL
    iters: int  # gathers or shifts per call


# phi against its plain version: both evaluate the same formula in float32
# with different math libraries; softplus(a) - log(expm1(a)) cancels near
# a = 5 to leave ~1e-6 of absolute rounding noise
PHI_TOL = dict(rtol=1e-5, atol=1e-5)


def probe_inputs(device):
    """The scripts' inputs, from ``np.random.default_rng(0)`` in their order:
    perm [E], x_sub [E, B], x_lane [8, E], and the broadcast index tables
    idx2 [8, E] and idx_full [E, B]."""
    rng = np.random.default_rng(0)
    perm = rng.permutation(E).astype(np.int32)
    x_sub = rng.standard_normal((E, B)).astype(np.float32)
    x_lane = rng.standard_normal((LANES, E)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return dict(perm=t(perm), x_sub=t(x_sub), x_lane=t(x_lane),
                idx2=t(np.broadcast_to(perm[None, :], (LANES, E))),
                idx_full=t(np.broadcast_to(perm[:, None], (E, B))))


def probe_cases(inp) -> list[Probe]:
    """The thirteen probes on ``probe_inputs``, in the scripts' order."""
    x, perm, lane = inp["x_sub"], inp["perm"], inp["x_lane"]
    p1, p2 = "scripts/probe_pallas.py", "scripts/probe_pallas2.py"
    return [
        Probe("k1", "take_rows", f"{p1}:42", take_rows, take_rows_plain, (x, perm), True, 1),
        Probe("k2", "take_lanes", f"{p1}:59", take_lanes, take_lanes_plain, (lane, perm), True, 1),
        Probe("k2b", "take_along_lanes", f"{p1}:78", take_along_lanes, take_along_lanes_plain,
              (lane, inp["idx2"]), True, 1),
        Probe("k3", "roll_rows", f"{p1}:95", roll_rows, roll_rows_plain, (x,), True, 1),
        Probe("k4", "circulant_copy", f"{p1}:113", circulant_copy, circulant_copy_plain,
              (x[:CIRC_ROWS],), True, 1),
        Probe("k5", "phi_softplus_expm1", f"{p1}:128", phi_softplus_expm1, phi_softplus_expm1_plain,
              (x,), False, 1),
        Probe("k6", "gather_loop", f"{p1}:146", gather_loop, gather_loop_plain, (x, perm), True,
              LOOP_ITERS),
        Probe("ka", "take_along_rows", f"{p2}:47", take_along_rows, take_along_rows_plain,
              (x, inp["idx_full"]), True, 1),
        Probe("kb", "index_rows", f"{p2}:56", index_rows, index_rows_plain, (x, perm), True, 1),
        Probe("kc", "phi_log_tanh", f"{p2}:68", phi_log_tanh, phi_log_tanh_plain, (x,), False, 1),
        Probe("kd", "phi_exp_log1p", f"{p2}:78", phi_exp_log1p, phi_exp_log1p_plain, (x,), False, 1),
        Probe("ke", "take_along_loop", f"{p2}:91", take_along_loop, take_along_loop_plain,
              (x, inp["idx_full"]), True, LOOP_ITERS),
        Probe("kf", "roll_loop", f"{p2}:111", roll_loop, roll_loop_plain, (x,), True, LOOP_ITERS),
    ]


def compare(probe: Probe, out, ref) -> float:
    """Largest absolute difference of ``out`` from ``ref``; raises unless
    they agree (bit for bit, or within PHI_TOL for phi)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{probe.key} {probe.name}: {tuple(out.shape)} {out.dtype} "
                             f"against {tuple(ref.shape)} {ref.dtype}")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    if probe.exact:
        ok = bool(torch.equal(out, ref))
    else:
        ok = bool(torch.allclose(out, ref, **PHI_TOL))
    if not ok:
        raise AssertionError(f"{probe.key} {probe.name} disagrees with its plain version: "
                             f"max_abs_err={err:.3e}")
    return err


def _seconds(fn, device, reps):
    """Seconds per call of fn(): CUDA events on the card, the host clock
    on the CPU; after one warm-up call."""
    fn()
    if device.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def main(device=None, reps=50) -> dict:
    """Every probe on the scripts' inputs against its plain version, one
    line each, then the three loops' times per iteration.  Runs on the card
    unless ``device="cpu"``; raises on any disagreement.  Returns each
    probe's largest absolute error by key."""
    device = resolve_device(device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    cases = probe_cases(probe_inputs(device))
    errs = {}
    for p in cases:
        out = p.fn(*p.args)
        errs[p.key] = compare(p, out, p.plain(*p.args))
        print(f"PASS {p.key} {p.name} {list(p.args[0].shape)}: max_abs_err={errs[p.key]:.3e} "
              f"({'exact' if p.exact else 'rtol=atol=1e-5'}) on {where}", flush=True)
    for p in cases:
        if p.iters > 1:
            dt = _seconds(lambda: p.fn(*p.args), device, reps) / p.iters
            x = p.args[0]
            gbs = x.numel() * x.element_size() / dt / 1e9
            print(f"TIME {p.key} {p.name} {list(x.shape)}: {dt * 1e6:.4f} us per iteration "
                  f"({gbs:.1f} GB/s eff) on {where}", flush=True)
    return errs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
