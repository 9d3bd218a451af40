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

Three kernels of ``csrc/probes.cu`` serve them: a gather through an index
table, a shift whose index is computed, and phi.  A wrapper given CUDA
tensors launches its kernel (or raises); given CPU tensors it takes its
plain version, ``<wrapper>_plain``.  Each launch adds one to
``launches[<wrapper>]``; the plain versions do not count.  Indices are
int32 and lie in [0, length of the gathered axis).

    python -m feedback_gnn_tpu_torch.probes [--device cpu]

runs every probe on the scripts' inputs against its plain version and
times the three loops.  No decoder reaches this module.
"""

from __future__ import annotations

import argparse
import ctypes
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import resolve_device
from .decoders.bp4_qc import SMEM_LIMIT
from .decoders.cn_update import softplus

__all__ = [
    "take_rows", "take_lanes", "take_along_lanes", "roll_rows", "circulant_copy",
    "phi_softplus_expm1", "gather_loop", "take_along_rows", "index_rows", "phi_log_tanh",
    "phi_exp_log1p", "take_along_loop", "roll_loop", "Probe", "probe_inputs", "probe_cases",
    "main", "launches",
]

# the scripts' shapes and constants
E, B, LANES = 3840, 128, 8
ROLL_SHIFT, CIRC_LEN, CIRC_ROWS = 13, 127, 128
LOOP_ITERS, LOOP_SCALE = 64, 1.0001
PHI_OFFSET = 1e-3

PHI_FORMS = ("softplus_expm1", "log_tanh", "exp_log1p")  # csrc/probes.cu's order
MAX_THREADS = 1024
DIRECT_THREADS = PHI_THREADS = 256

WRAPPERS = (
    "take_rows", "take_lanes", "take_along_lanes", "roll_rows", "circulant_copy",
    "phi_softplus_expm1", "gather_loop", "take_along_rows", "index_rows", "phi_log_tanh",
    "phi_exp_log1p", "take_along_loop", "roll_loop",
)
# kernel launches since the last reset, per wrapper
launches = dict.fromkeys(WRAPPERS, 0)


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


def _tile(x, axis):
    """(rows, cols, row_stride, col_stride) with the gathered axis as rows."""
    r, c = x.shape
    return (r, c, c, 1) if axis == 0 else (c, r, 1, c)


def _launch_shape(rows, iters, floats_per_row):
    """(resident, threads, shared-memory bytes) of a gather or shift launch:
    a single pass goes straight through device memory (a thread per
    element); the loops hold one column per block in shared memory,
    ``floats_per_row`` 4-byte words for each row."""
    if iters == 1:
        return 0, DIRECT_THREADS, 0
    smem = 4 * floats_per_row * rows
    if smem > SMEM_LIMIT:
        raise ValueError(f"a column of {rows} rows does not fit a block's shared memory")
    return 1, min(MAX_THREADS, -(-rows // 32) * 32), smem


def _output(x):
    if x.numel() >= 2**31:
        raise ValueError("the probe kernels index with 32-bit ints: at most 2**31 - 1 elements")
    return torch.empty_like(x)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.fgt_cuda_error_string(err).decode()}")


def _launch_gather(name, x, idx, axis, iters=1, scale=1.0):
    """out[r, c] = x[idx(r, c), c] along ``axis`` (idx a table of that
    axis's length, or of x's shape), ``iters`` times, each times ``scale``."""
    from ._build import load_kernels

    lib = load_kernels()
    out = _output(x)
    if x.numel() == 0:
        return out
    rows, cols, rs, cs = _tile(x, axis)
    resident, threads, smem = _launch_shape(rows, iters, 3)  # two buffers and the table
    irs, ics = (rs, cs) if idx.dim() == 2 else (1, 0)
    with torch.cuda.device(x.device):
        err = lib.fgt_probe_gather_launch(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols, rs, cs, irs, ics,
            int(iters), ctypes.c_float(scale), resident, threads, smem, _stream(x.device),
        )
    _raise_on(lib, err, name)
    launches[name] += 1
    return out


def _launch_shift(name, x, shift, length, iters=1, scale=1.0):
    """out[i] = x[(i + shift) mod length] along rows for i < length, x[i]
    past it, ``iters`` times, each times ``scale``."""
    from ._build import load_kernels

    lib = load_kernels()
    out = _output(x)
    if x.numel() == 0:
        return out
    rows, cols, rs, cs = _tile(x, 0)
    resident, threads, smem = _launch_shape(rows, iters, 2)
    with torch.cuda.device(x.device):
        err = lib.fgt_probe_shift_launch(
            x.data_ptr(), out.data_ptr(), rows, cols, rs, cs, int(shift) % length, length,
            int(iters), ctypes.c_float(scale), resident, threads, smem, _stream(x.device),
        )
    _raise_on(lib, err, name)
    launches[name] += 1
    return out


def _launch_phi(name, x, form, fast):
    from ._build import load_kernels

    lib = load_kernels()
    out = _output(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.fgt_probe_phi_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                                       PHI_FORMS.index(form), int(fast), PHI_THREADS,
                                       _stream(x.device))
    _raise_on(lib, err, name)
    launches[name] += 1
    return out


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
