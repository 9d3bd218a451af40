#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (feedback_gnn_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from feedback_gnn_tpu_torch/csrc with one
nvcc (K1, the fused QC BP4 decode; K2, the fused QC BP2 decode; the three
probe kernels of csrc/probes.cu), holds each against its plain PyTorch
version on the card, and drives the paths that run them or their
neighbours: the [[882,24]] sandwich cascade of feedback_gnn_tpu_torch.entry
and the [[1270,28]] compacted workload of bench.py (K1); the binary BSC
evaluation step on [[882,24]]'s hx (K2); the plain gather BP4 step on
[[882,24]] (no kernel); feedback_gnn_tpu_torch.probes.main(), the
thirteen probes of scripts/probe_pallas*.py.  Each decoding path is checked
against a published error rate, each probe against its plain version, with
every kernel's launch count set to 0 just before a path and read just
after.  Prints each phase's seconds, the card's name and power limit, one
JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}.  Exits non-zero, with no
result line, when there is no CUDA card or any phase fails.  Imports no
JAX.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEADLINE_S = 1100  # a hang prints every thread's stack and exits non-zero

# The main path: __graft_entry__.entry()'s configuration, checked against
# the TF original's BLER 7.92e-2 at p=0.12 (tests/test_cascade_e2e.py).
LER_P, LER_REF, LER_SIGMAS, LER_STEPS = 0.12, 7.92e-2, 4.5, 16  # 16 x 256 = 4096 samples
# throughput: steps back to back over WINDOWS windows of at least WINDOW_S
# seconds each; the median window is reported with the spread of all
WINDOWS, WINDOW_S = 5, 1.0
# bench.py's workload
BENCH = dict(batch=20480, p=0.05)
# K1 and K2 against their plain versions: bit for bit (the plain versions
# repeat the kernels' order of operations and the same accurate libm calls)
CMP_BATCH, CMP_ITERS = 256, 64
CASES = [
    ("boxplus-phi", None),
    ("boxplus-phi", "tf"),
    ("boxplus-phi", "accurate"),
    ("boxplus", None),
    ("minsum", None),
]

# The binary BSC path (examples/osd_eval.py --mode bp2 on [[882,24]]: hx,
# lx) on K2, and the plain gather BP4 path, each at the batch of the runs
# behind RESULTS.md's plain-BP rows, checked against the JAX package's
# flagged rate over 1.02e7 blocks (RESULTS.md), the TF original's beside it
BP2 = dict(p=0.05, batch=20480, iters=100, cn_type="minsum", factor=0.8, steps=3,
           ref=0.05275, tf=0.05342)
BP4_PLAIN = dict(p=0.10, batch=20480, iters=100, cn_type="minsum", factor=0.8, steps=3,
                 ref=0.03477, tf=0.03482)
K2_CMP_BATCH, K2_CMP_ITERS, K2_CMP_FACTOR = 256, 100, 0.8

# The previous design of K1 and K2 (one 256-thread block per sample,
# runtime CN rule and degrees), measured on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md's kernel table): milliseconds at each timed shape, and
# the seeded counts, which the bit-exact kernels must repeat
PREVIOUS_K1_MS = {
    ("n882", 256, 64): 1.4342, ("n882", 256, 16): 0.3942, ("n1270", 20480, 12): 31.8701,
    ("n1270", 3072, 64): 22.1389, ("n1270", 1024, 16): 2.0402,
}
PREVIOUS_K2_MS = 28.9668
PREVIOUS_COUNTS = {"main path": (300, 4096), "bp2_path": (3143, 61440), "bp4_plain_path": (2139, 61440)}
GRID_REPS = 10  # calls per plan of the launch-plan grid, in one CUDA graph
# Work of one decode, for the bound: float32 operations per edge and
# iteration (transcendentals counted as one each), read off csrc/bp4_qc.cu
# and csrc/bp2_qc.cu (the CN side is qc_common.cuh's cn_node in both).
VN_OPS_PER_EDGE = 12  # sum-add, two subs, lse_neg (8), sub
VN_OPS_PER_NODE = 18  # marginals (4 adds), two softplus (7 each)
CN_OPS_PER_EDGE = {
    ("boxplus-phi", None): 24,  # sign, abs, 2 phi (8 each, tanh form), 5 mul/add
    ("boxplus-phi", "tf"): 36,  # phi in the tf form: 14 each
    ("boxplus-phi", "accurate"): 28,  # phi in the accurate form: 10 each
    ("boxplus", None): 14,
    ("minsum", None): 15,
}
K2_VN_OPS_PER_EDGE = 2  # add to the total, subtract for the extrinsic
H100_F32_OPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3, H100 SXM data sheet
# shared memory of all SMs: 128 B per clock per SM x 132 SMs x 1.98 GHz
# (the boost clock), for the loop probes' on-chip bound
H100_SMEM_BYTES = 128 * 132 * 1.98e9

# The probes: back-to-back calls per timing, and float32 operations per
# element of each phi form (transcendentals counted as one each, as for K1)
PROBE_REPS, PROBE_PLAIN_REPS = 200, 20
PHI_OPS = {"phi_softplus_expm1": 10, "phi_log_tanh": 6, "phi_exp_log1p": 10}
# shared-memory bytes per element and iteration of the loops (csrc/probes.cu's
# resident_iterations): the element read and written, and a gather's index read
LOOP_SMEM_BYTES = {"gather_loop": 12, "take_along_loop": 12, "roll_loop": 8}


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def k1_bound_ms(qc, batch, iters, cn_type="boxplus-phi", phi_impl=None):
    """Least time of one decode on an H100: the larger of its bytes (LLRs
    and syndromes read once, marginals written once) over the memory rate
    and its f32 operations over the f32 rate."""
    n, l = qc.n, qc.l
    m = (qc.qx.mb + qc.qz.mb) * l
    edges = (qc.qx.num_groups + qc.qz.num_groups) * l
    nbytes = 4 * batch * (3 * n + m) + 4 * batch * 3 * n
    per_iter = edges * (VN_OPS_PER_EDGE + CN_OPS_PER_EDGE[(cn_type, phi_impl)]) + n * VN_OPS_PER_NODE + m
    ops = batch * (iters * per_iter + edges + 4 * n)
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_F32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound_ms(spec, batch, iters, cn_type):
    """Least time of one K2 decode on an H100: the larger of its bytes
    (logits and syndrome read once, marginal logits written once) over the
    memory rate and its f32 operations over the f32 rate."""
    n, m, edges = spec.nb * spec.l, spec.mb * spec.l, spec.num_edges
    nbytes = 4 * batch * (n + m + n)
    per_iter = edges * (K2_VN_OPS_PER_EDGE + CN_OPS_PER_EDGE[(cn_type, None)]) + m
    # entry: clip (2) and negate per VN, 1 - 2s (2) per CN; exit: final sums, negate
    ops = batch * (iters * per_iter + 3 * n + 2 * m + edges + n)
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_F32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_counts():
    from feedback_gnn_tpu_torch import probes
    from feedback_gnn_tpu_torch.decoders import bp2_qc, bp4_qc

    bp4_qc.launches = bp2_qc.launches = 0
    for name in probes.launches:
        probes.launches[name] = 0


def read_counts():
    from feedback_gnn_tpu_torch import probes
    from feedback_gnn_tpu_torch.decoders import bp2_qc, bp4_qc

    return {"K1": bp4_qc.launches, "K2": bp2_qc.launches, **probes.launches}


def expected_counts(**launched):
    """Every kernel's count 0 but those named."""
    counts = dict.fromkeys(read_counts(), 0)
    counts.update(launched)
    return counts


def random_inputs(qc, batch, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    llr = torch.randn((3, qc.n, batch), generator=g, device=device) * 2.0
    sx = torch.randint(0, 2, (qc.qx.mb * qc.l, batch), generator=g, device=device).float()
    sz = torch.randint(0, 2, (qc.qz.mb * qc.l, batch), generator=g, device=device).float()
    return llr, sx, sz


def time_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps):
    """Mean milliseconds of fn() on the card with the host's launch overhead
    taken out: reps calls captured into one CUDA graph, whose replay is timed
    by CUDA events (after a warm-up call and a warm-up replay).  The card's
    own gap between launches stays in."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_registers(report):
    """{(kernel, template arguments): (registers, spill-store bytes)} of every
    kernel in nvcc's -Xptxas -v report: K1/K2 instances by name and
    template arguments, the others by mangled name."""
    found, current, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            k = re.search(r"(bp[24]_qc_kernel)I((?:Li-?\d+E)+)E", current)
            key = (k.group(1), tuple(int(x) for x in re.findall(r"Li(-?\d+)E", k.group(2)))) if k else (current, ())
            found[key] = (int(m.group(1)), spill)
            current = None
    return found


def sass_counts(library):
    """SASS instructions (NOPs left out) of each K1/K2 instance in the built
    library (cuobjdump -sass), cut at its barrier instructions: the load,
    the VN pass, the CN pass and the final marginals each fall between two
    BARs.  For each segment: its instructions and MUFU (special-function)
    instructions, and the same for every loop in it (a backward branch and
    its target).  The smallest loop of a pass is one node visit with its
    loop control: nvcc unrolls a node loop into a body of several visits
    plus a remainder loop of one."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: no cuobjdump in this toolkit")
        return
    dump = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300).stdout
    for section in re.split(r"\n\s*Function : ", dump)[1:]:
        k = re.search(r"(bp[24]_qc_kernel)I((?:Li-?\d+E)+)E", section.split("\n", 1)[0])
        if not k:
            continue
        code = []  # (address, opcode, backward-branch target or None)
        for addr, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", section):
            op = [t for t in ins.split() if not t.startswith("@")][0]
            target = re.search(r"BRA\S*\s+(?:\S+\s+)?0x([0-9a-f]+)", ins)
            back = int(target.group(1), 16) if target and int(target.group(1), 16) < int(addr, 16) else None
            if op != "NOP":
                code.append((int(addr, 16), op, back))
        cuts = [i for i, (_, op, _) in enumerate(code) if op.startswith("BAR")]
        parts = []
        for lo, hi in zip([0] + [c + 1 for c in cuts], cuts + [len(code)]):
            seg = code[lo:hi]
            loops = sorted(
                (sum(1 for a, _, _ in seg if back <= a <= addr),
                 sum(1 for a, o, _ in seg if back <= a <= addr and o.startswith("MUFU")))
                for addr, _, back in seg if back is not None and back >= (seg[0][0] if seg else 0))
            mufu = sum(1 for _, o, _ in seg if o.startswith("MUFU"))
            parts.append(f"{len(seg)}/{mufu}" + (" loops " + ",".join(f"{n}/{m}" for n, m in loops) if loops else ""))
        args = [int(x) for x in re.findall(r"Li(-?\d+)E", k.group(2))]
        print(f"  sass {k.group(1)}{args}: instructions/MUFU between barriers: " + " | ".join(parts))


def plan_grid(launch_plan, nodes, max_threads):
    """The plans measured around a shape's chosen one: one
    sample per block at 1-4 nodes per thread, and 2-8 samples per block at
    the most threads that fit (and half that at the largest count that fits
    shared memory).  ``launch_plan(threads, samples_per_block)`` raises for
    a plan that does not fit."""
    def up32(x):
        return -(-x // 32) * 32

    pairs = [(up32(-(-nodes // p)), 1) for p in range(1, 5)]
    fits = []
    for spb in range(2, 9):
        thr = min(up32(nodes), max_threads // spb // 32 * 32)
        if thr >= 32:
            pairs.append((thr, spb))
    plans = []
    for thr, spb in pairs:
        try:
            plans.append(launch_plan(thr, spb))
            fits.append((thr, spb))
        except ValueError:
            pass
    thr, spb = fits[-1]
    if thr >= 64:
        plans.append(launch_plan(thr // 64 * 32, spb))
    return list(dict.fromkeys(plans))


def time_plans(label, plans, chosen, run, ref, card):
    """Time run(plan) for every plan of the grid in CUDA graphs (the host's
    launch overhead out, which eager calls of a 0.2 ms kernel do not
    escape), each held bit for bit to ref; print each and mark the fastest
    and the one the launch plan chose.  Returns {plan: ms}."""
    times = {}
    for plan in plans:
        out = run(plan)
        torch.cuda.synchronize()
        same = all(torch.equal(o, r) for o, r in zip(out, ref)) if isinstance(out, tuple) else torch.equal(out, ref)
        if not same:
            raise AssertionError(f"{label}: plan {plan} disagrees with the plain version")
        del out
        times[plan] = graph_ms(lambda: run(plan), reps=GRID_REPS)
    best = min(times, key=times.get)
    for plan, ms in times.items():
        mark = (" <- fastest" if plan == best else "") + (" <- chosen" if plan == chosen else "")
        print(f"  grid {label}: {plan.threads} threads x {plan.samples_per_block} samples per block, "
              f"{plan.nodes_per_thread} nodes per thread, {plan.smem_bytes} B, planned "
              f"{plan.blocks_per_sm} blocks per SM: {ms:.4f} ms on {card}{mark}")
    return times


def profile_step(label, step, args, step_ms, card):
    """Device time of one step by kernel name (torch.profiler), and the
    device's busy share against the step's unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        out = step(*args)
        int(out[0])
        torch.cuda.synchronize()
    # kernels only: an operator's own row repeats its kernels' device time
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile {label}: device busy {busy_ms:.3f} ms of a {step_ms:.3f} ms step "
          f"(busy share {busy_ms / step_ms:.3f}) on {card}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def check_against_plain(label, out, ref):
    """Hold K1's marginals against the plain version's; print the largest
    error and the share of agreeing decisions, raise unless bit for bit."""
    from feedback_gnn_tpu_torch.decoders.bp4 import hard_decision

    torch.cuda.synchronize()
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    ok = all(torch.equal(o, r) for o, r in zip(out, ref))
    xo, zo = hard_decision(*out)
    xr, zr = hard_decision(*ref)
    agree = float(((xo == xr) & (zo == zr)).float().mean())
    print(f"  K1 vs plain {label}: max_abs_err={err:.3e} decisions_agree={agree:.6f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {label}")
    return err


def compare_kernel(codes, device):
    """K1 against its plain version on the card, every CN rule and phi form."""
    from feedback_gnn_tpu_torch.decoders.bp4_qc import bp4_qc_marginals, bp4_qc_marginals_plain

    worst = 0.0
    for name, (_, qc, _) in codes.items():
        llr, sx, sz = random_inputs(qc, CMP_BATCH, device, seed=1)
        for cn_type, phi_impl in CASES:
            out = bp4_qc_marginals(qc, llr, sx, sz, CMP_ITERS, cn_type, 0.9, phi_impl=phi_impl)
            ref = bp4_qc_marginals_plain(qc, llr, sx, sz, CMP_ITERS, cn_type, 0.9, phi_impl=phi_impl)
            label = f"{name} B={CMP_BATCH} iters={CMP_ITERS} {cn_type} phi={phi_impl}"
            worst = max(worst, check_against_plain(label, out, ref))
    return worst


def bsc_inputs(hx, batch, p, device, seed):
    """The binary path's own kernel inputs: the constant BSC prior logit
    and the syndrome of BSC(p) noise."""
    from feedback_gnn_tpu_torch.channels import bsc_sample
    from feedback_gnn_tpu_torch.ops import mod2_matmul

    g = torch.Generator(device=device).manual_seed(seed)
    n = hx.shape[1]
    llr = torch.full((n, batch), -float(torch.log(torch.tensor((1.0 - p) / p))), device=device)
    syn = mod2_matmul(hx, bsc_sample(g, p, (n, batch))).float()
    return llr, syn


def check_k2(label, out, ref):
    """Hold K2's marginal logits against the plain version's; print the
    largest error and the share of agreeing decisions, raise unless bit for
    bit."""
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = torch.equal(out, ref)
    agree = float(((out > 0) == (ref > 0)).float().mean())
    print(f"  K2 vs plain {label}: max_abs_err={err:.3e} decisions_agree={agree:.6f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: {label}")
    return err


def compare_k2(specs, device):
    """K2 against its plain version on the card, every CN rule, on each
    paper code's hx."""
    from feedback_gnn_tpu_torch.decoders.bp2_qc import bp2_qc_logits, bp2_qc_logits_plain

    worst = 0.0
    for name, spec in specs.items():
        g = torch.Generator(device=device).manual_seed(3)
        n, m = spec.nb * spec.l, spec.mb * spec.l
        llr = torch.randn((n, K2_CMP_BATCH), generator=g, device=device) * 3.0
        syn = torch.randint(0, 2, (m, K2_CMP_BATCH), generator=g, device=device).float()
        for cn_type in ("boxplus-phi", "boxplus", "minsum"):
            args = (spec, llr, syn, K2_CMP_ITERS, cn_type, K2_CMP_FACTOR)
            label = f"{name} hx B={K2_CMP_BATCH} iters={K2_CMP_ITERS} {cn_type} f={K2_CMP_FACTOR}"
            worst = max(worst, check_k2(label, bp2_qc_logits(*args), bp2_qc_logits_plain(*args)))
    return worst


def same_counts(label, count, samples):
    """Print whether a seeded count repeats the previous design's (the
    kernels are bit exact, so on the same software it should)."""
    before = PREVIOUS_COUNTS[label]
    print(f"{label} seeded count {count}/{samples}: previous design {before[0]}/{before[1]}, "
          f"{'the same' if (count, samples) == before else 'DIFFERENT'}")


def check_rate(label, flagged, samples, ref, tf):
    """The flagged rate must land within LER_SIGMAS of the JAX package's."""
    rate = flagged / samples
    sigma = (ref * (1 - ref) / samples) ** 0.5
    print(f"{label}: flagged={flagged}/{samples} rate={rate:.5f} JAX package {ref} "
          f"({abs(rate - ref) / sigma:.2f} sigma), TF original {tf}")
    if abs(rate - ref) >= LER_SIGMAS * sigma:
        raise AssertionError(f"{label}: flagged rate {rate} outside {LER_SIGMAS} sigma of {ref}")


def timed_windows(step, args, batch):
    """Syndromes/s of back-to-back steps over WINDOWS windows of at least
    WINDOW_S seconds each (each window ends with a fetch of the last
    step's counts and a synchronize); returns the per-window rates, the
    per-window ms per step, and every step's output."""
    rates, step_ms, outs = [], [], []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = 0
        while True:
            outs.append(step(*args))
            n += 1
            if time.perf_counter() - t1 >= WINDOW_S:
                break
        int(outs[-1][0])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        rates.append(n * batch / dt)
        step_ms.append(dt / n * 1e3)
    return rates, step_ms, outs


def report_rate(label, rates, step_ms, card):
    med = statistics.median(rates)
    print(f"{label}: {med:.1f} syndromes/s median of {len(rates)} windows of >= {WINDOW_S} s "
          f"(min {min(rates):.1f}, max {max(rates):.1f}; "
          f"{statistics.median(step_ms):.3f} ms per step median) on {card}")
    print("  windows: " + ", ".join(f"{r:.1f}" for r in rates))
    return statistics.median(step_ms)


def run_main_path(device):
    """entry()'s step at p=0.12 over LER_STEPS batches; (logical, samples)."""
    from feedback_gnn_tpu_torch.entry import entry

    fn, (gen, _) = entry(device)
    gen.manual_seed(7)
    logical = flagged = 0
    for _ in range(LER_STEPS):
        f, lg = fn(gen, LER_P)
        flagged += int(f)
        logical += int(lg)
    return fn, gen, flagged, logical, LER_STEPS * 256


def bench_step(graph, qc, params, batch):
    from feedback_gnn_tpu_torch.decoders import CascadeConfig, sandwich_eval_step

    cfg = CascadeConfig(num_iter1=64, num_iter2=16, num_rounds=5, p0=0.05,
                        compact_fraction=0.15, stage1_prepass=12, round_fraction=0.05)

    def step(gen, p):
        return sandwich_eval_step(graph, [params], cfg, gen, p, batch, qc=qc, return_overflow=True)

    return cfg, step


def probe_library(p):
    """The one PyTorch call that computes the probe's function, as a thunk
    on its inputs (index tables widened to int64 beforehand), or None."""
    from feedback_gnn_tpu_torch.probes import ROLL_SHIFT

    a = p.args
    if p.name in ("take_rows", "index_rows"):
        return lambda: torch.index_select(a[0], 0, a[1])
    if p.name == "take_lanes":
        return lambda: torch.index_select(a[0], 1, a[1])
    if p.name in ("take_along_lanes", "take_along_rows"):
        dim, idx = (1 if p.name == "take_along_lanes" else 0), a[1].long()
        return lambda: torch.gather(a[0], dim, idx)
    if p.name == "roll_rows":
        return lambda: torch.roll(a[0], ROLL_SHIFT, 0)
    return None


def probe_bounds_ms(p, out):
    """The probe's least time on an H100, (ms, by, memory), the largest of:
    its inputs read once and its output written once over the memory rate;
    its float32 operations (one multiply per element and iteration in the
    loops, phi's PHI_OPS) over the f32 rate; and for the loops the bytes
    each iteration moves through shared memory (LOOP_SMEM_BYTES) over its
    rate.  ``memory`` names the memory whose bytes bind, None if operations
    do."""
    nbytes = sum(t.numel() * t.element_size() for t in p.args if torch.is_tensor(t))
    nbytes += out.numel() * out.element_size()
    ops = out.numel() * (PHI_OPS.get(p.name, 0) + (p.iters if p.iters > 1 else 0))
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_F32_OPS
    t_smem = p.iters * LOOP_SMEM_BYTES.get(p.name, 0) * out.numel() / H100_SMEM_BYTES
    t = max(t_bytes, t_ops, t_smem)
    if t == t_ops:
        return 1e3 * t, "operations", None
    return 1e3 * t, "bytes", ("shared memory" if t == t_smem else "device memory")


def loop_bank_probe(p, per_iter_us, card):
    """k6 on the identity permutation beside k6 on its random one: thread r
    reads row r, 32 banks for 32 threads, where a random permutation sends
    several threads of a warp to one bank.  Same index read, same
    instructions; the difference per iteration is what the bank conflicts
    cost.  Checked against the plain version, timed, printed."""
    from feedback_gnn_tpu_torch import probes

    x = p.args[0]
    ident = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    out, ref = probes.gather_loop(x, ident), probes.gather_loop_plain(x, ident)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("k6 on the identity permutation disagrees with its plain version")
    full_ms = graph_ms(lambda: probes.gather_loop(x, ident), reps=PROBE_REPS)
    two_ms = graph_ms(lambda: probes.gather_loop(x, ident, iters=2), reps=PROBE_REPS)
    ident_us = (full_ms - two_ms) / (p.iters - 2) * 1e3
    print(f"  {p.key} on the identity permutation: {full_ms:.5f} ms per call; each further "
          f"iteration {ident_us:.4f} us against {per_iter_us:.4f} us on the random one on {card}")


def run_probes(device, card):
    """probes.main(), the entry point of the Pallas probe scripts' port, with
    the launch counts reset just before and read just after; then each probe
    against its plain version, the kernel's, the plain version's and the
    library call's times, the bounds, and for phi the fast transcendentals.
    Returns the probes' rows of the kernels line."""
    from feedback_gnn_tpu_torch import probes

    reset_counts()
    probes.main(device)
    torch.cuda.synchronize()
    probe_counts = read_counts()
    print(f"probes launches={probe_counts}")
    if any(probe_counts[nm] < 1 for nm in probes.WRAPPERS) or probe_counts["K1"] or probe_counts["K2"]:
        raise AssertionError(f"kernel launches {probe_counts} in probes.main()")
    probe_rows = []
    for p in probes.probe_cases(probes.probe_inputs(device)):
        out = p.fn(*p.args)
        ref = p.plain(*p.args)
        torch.cuda.synchronize()
        err = probes.compare(p, out, ref)
        # these calls take microseconds on the card, less than the host
        # spends launching them: time them in CUDA graphs, and show the
        # host-paced time of back-to-back eager calls beside
        k_ms = graph_ms(lambda: p.fn(*p.args), reps=PROBE_REPS)
        eager_ms = time_ms(lambda: p.fn(*p.args), reps=PROBE_REPS)
        pl_ms = graph_ms(lambda: p.plain(*p.args), reps=PROBE_PLAIN_REPS)
        lib = probe_library(p)
        lib_ms = None
        if lib is not None:
            if not torch.equal(lib(), ref):
                raise AssertionError(f"{p.key}: the library call disagrees with the plain version")
            lib_ms = graph_ms(lib, reps=PROBE_REPS)
        b_ms, b_by, b_mem = probe_bounds_ms(p, out)
        print(f"probe {p.key} {p.name} {list(p.args[0].shape)}: max_abs_err={err:.3e} "
              f"kernel {k_ms:.5f} ms (eager back to back {eager_ms:.5f} ms), plain {pl_ms:.5f} ms, "
              "library " + (f"{lib_ms:.5f} ms" if lib_ms is not None else "none")
              + f", bound {b_ms:.5f} ms ({b_by}" + (f" through {b_mem}" if b_mem else "")
              + f") on {card}", flush=True)
        if p.iters > 1:  # the loops: what one more iteration on chip costs (a
            # single pass takes another route, so the yardstick is two)
            two_ms = graph_ms(lambda: p.fn(*p.args, iters=2), reps=PROBE_REPS)
            per_iter_us = (k_ms - two_ms) / (p.iters - 2) * 1e3
            print(f"  {p.key} two iterations per call: {two_ms:.5f} ms; each further iteration "
                  f"{per_iter_us:.4f} us, on-chip bound {b_ms / p.iters * 1e3:.4f} us on {card}")
            if p.name == "gather_loop":
                loop_bank_probe(p, per_iter_us, card)
        if not p.exact:  # phi: the fast transcendentals, timed and held to float64
            f_ms = graph_ms(lambda: p.fn(*p.args, fast=True), reps=PROBE_REPS)
            ref64 = probes.phi_reference(p.args[0])
            acc_err = float((out.double() - ref64).abs().max())
            fast_err = float((p.fn(*p.args, fast=True).double() - ref64).abs().max())
            print(f"  {p.key} fast transcendentals: {f_ms:.5f} ms against {k_ms:.5f} ms; max abs error "
                  f"against float64 phi: accurate {acc_err:.3e}, fast {fast_err:.3e} on {card}")
        probe_rows.append({
            "name": p.name,
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/probes.cu",
            "replaces": p.replaces,
            "launches": probe_counts[p.name],
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": pl_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_memory": b_mem,
            "library_ms": lib_ms,
        })
    return probe_rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    from feedback_gnn_tpu_torch import _build, resolve_device
    from feedback_gnn_tpu_torch.codes import build_graph, detect_qc_structure, ghp_882_24
    from feedback_gnn_tpu_torch.decoders import bp4_qc
    from feedback_gnn_tpu_torch.entry import load_code

    t_all = time.perf_counter()

    # 1. the card
    t0 = time.perf_counter()
    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {name} count {torch.cuda.device_count()}", flush=True)
    phase("card", t0)

    # 2. the build
    t0 = time.perf_counter()
    _build.load_kernels()
    info = _build.build_info
    print(f"build: nvcc {'ran' if info['built'] else 'cached'} in {info['seconds']:.2f} s -> {info['library']}")
    registers = ptxas_registers(info["ptxas"])
    for (kernel, args), (regs, spill) in sorted(registers.items()):
        print(f"  registers {kernel}{list(args)}: {regs}, spill stores {spill} B")
    sass_counts(info["library"])
    phase("build", t0)

    t0 = time.perf_counter()
    codes = {nm: load_code(nm, device) for nm in ("n882", "n1270")}
    # the binary path decodes with [[882,24]]'s hx; its spec two ways
    code882 = ghp_882_24()
    hx = torch.as_tensor(np.asarray(code882.hx), dtype=torch.float32, device=device)
    lx = torch.as_tensor(np.asarray(code882.lx), dtype=torch.float32, device=device)
    spec882 = codes["n882"][1].qx
    if detect_qc_structure(np.asarray(code882.hx), spec882.l) != spec882:
        raise AssertionError("the QC spec of [[882,24]]'s hx differs between qc_pair_from_code and "
                             "detect_qc_structure")
    hx_graph = build_graph(np.asarray(code882.hx)).to(device)
    k2_specs = {"n882": spec882, "n1270": codes["n1270"][1].qx}
    phase("codes", t0)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    max_err = compare_kernel(codes, device)
    phase("kernel_vs_plain", t0)

    t0 = time.perf_counter()
    k2_err = compare_k2(k2_specs, device)
    phase("k2_vs_plain", t0)

    # 4. the main path
    t0 = time.perf_counter()
    reset_counts()
    fn, gen, flagged, logical, samples = run_main_path(device)
    counts = read_counts()
    launches = counts["K1"]
    ler = logical / samples
    sigma = (LER_REF * (1 - LER_REF) / samples) ** 0.5
    print(f"main path [[882,24]] nG=3 p={LER_P}: flagged={flagged} logical={logical}/{samples} "
          f"LER={ler:.5f} ref={LER_REF} ({abs(ler - LER_REF) / sigma:.2f} sigma) launches={counts}")
    if abs(ler - LER_REF) >= LER_SIGMAS * sigma:
        raise AssertionError(f"LER {ler} outside {LER_SIGMAS} sigma of {LER_REF}")
    same_counts("main path", logical, samples)
    if counts != expected_counts(K1=LER_STEPS * (1 + 3)):
        raise AssertionError(f"kernel launches {counts}, expected K1={LER_STEPS * 4}, K2=0")
    rates, step_ms, _ = timed_windows(fn, (gen, 0.08), 256)
    main_ms = report_rate("main path throughput [[882,24]] B=256 p=0.08", rates, step_ms, card)
    phase("main_path", t0)

    # 5. bench.py's workload: [[1270,28]], nG=5, prepass 12, compaction 0.15/0.05
    t0 = time.perf_counter()
    graph, qc, params = codes["n1270"]
    cfg, step = bench_step(graph, qc, params, BENCH["batch"])
    gen = torch.Generator(device=device).manual_seed(0)
    step(gen, BENCH["p"])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    rates, step_ms, counts = timed_windows(step, (gen, BENCH["p"]), BENCH["batch"])
    launches_b = read_counts()
    flagged_b = sum(int(c[0]) for c in counts)
    logical_b = sum(int(c[1]) for c in counts)
    overflow = sum(int(c[2]) for c in counts)
    bench_ms = report_rate(f"bench [[1270,28]] nG=5 p={BENCH['p']} B={BENCH['batch']}", rates, step_ms, card)
    print(f"bench: {len(counts)} steps, flagged={flagged_b} logical={logical_b} overflow={overflow} "
          f"launches={launches_b}")
    if overflow != 0:
        raise AssertionError(f"compaction overflow {overflow}")
    if launches_b != expected_counts(K1=len(counts) * (2 + cfg.num_rounds)):
        raise AssertionError(f"kernel launches {launches_b} in {len(counts)} bench steps")
    phase("bench", t0)

    # 6. K1 against its plain version, and both times, at every shape the
    # main path and the bench give it
    t0 = time.perf_counter()
    from feedback_gnn_tpu_torch.decoders.cascade import _capacity

    cap1 = _capacity(cfg.compact_fraction, BENCH["batch"], cfg.qc_batch_tile)
    cap2 = _capacity(cfg.round_fraction, BENCH["batch"], cfg.qc_batch_tile)
    shapes = [
        ("n882", 256, 64), ("n882", 256, 16),
        ("n1270", BENCH["batch"], 12), ("n1270", cap1, 64), ("n1270", cap2, 16),
    ]
    timing = {}
    for nm, batch, iters in shapes:
        qc_s = codes[nm][1]
        llr, sx, sz = random_inputs(qc_s, batch, device, seed=2)
        plan = bp4_qc._launch_plan(qc_s, batch)
        blocks, regs, spill = bp4_qc._occupancy(qc_s, "boxplus-phi", None, plan)
        key = ("bp4_qc_kernel", bp4_qc._kernel_codes("boxplus-phi", None, plan.instance))
        print(f"K1 {nm} B={batch} iters={iters}: instance (DC, DV)={plan.instance} boxplus-phi, "
              f"{plan.regime} batch: {plan.threads} threads x {plan.samples_per_block} samples per "
              f"block ({plan.blocks(batch)} blocks), {plan.nodes_per_thread} nodes per thread, "
              f"{plan.smem_bytes} B shared; resident blocks per SM {blocks} (planned "
              f"{plan.blocks_per_sm}); registers {regs} (ptxas {registers.get(key)}), local {spill} B")
        out = bp4_qc.bp4_qc_marginals(qc_s, llr, sx, sz, iters)
        k_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals(qc_s, llr, sx, sz, iters), reps=10)
        ref = bp4_qc.bp4_qc_marginals_plain(qc_s, llr, sx, sz, iters)
        max_err = max(max_err, check_against_plain(f"{nm} B={batch} iters={iters}", out, ref))
        del out
        grid = time_plans(
            f"K1 {nm} B={batch} iters={iters}",
            plan_grid(lambda t, spb: bp4_qc._launch_plan(qc_s, batch, t, spb),
                      max(qc_s.n, (qc_s.qx.mb + qc_s.qz.mb) * qc_s.l), bp4_qc.K1_MAX_THREADS),
            plan, lambda p: bp4_qc._launch_kernel(qc_s, llr, sx, sz, iters, "boxplus-phi", 1.0, None, p),
            ref, card)
        del ref
        p_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals_plain(qc_s, llr, sx, sz, iters), reps=2)
        b_ms, b_by = k1_bound_ms(qc_s, batch, iters)
        timing[(nm, batch, iters)] = (k_ms, p_ms, b_ms, b_by)
        old = PREVIOUS_K1_MS[(nm, batch, iters)]
        print(f"K1 {nm} B={batch} iters={iters}: kernel {k_ms:.4f} ms (previous design {old:.4f} ms, "
              f"ratio {k_ms / old:.3f}; in a CUDA graph {grid[plan]:.4f} ms), plain {p_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}) on {card}")
    phase("k1_timing", t0)

    # 7. the binary BSC path: bp2_bsc_eval_step on [[882,24]]'s hx, on K2
    t0 = time.perf_counter()
    from feedback_gnn_tpu_torch.models import bp2_bsc_eval_step, bp4_plain_eval_step

    def bp2_step(g, p):
        return bp2_bsc_eval_step(hx_graph, hx, lx, g, p, BP2["batch"], num_iter=BP2["iters"],
                                 cn_type=BP2["cn_type"], normalization_factor=BP2["factor"],
                                 qc_spec=spec882)

    gen = torch.Generator(device=device).manual_seed(5)
    reset_counts()
    outs = [bp2_step(gen, BP2["p"]) for _ in range(BP2["steps"])]
    counts = read_counts()
    k2_launches = counts["K2"]
    flagged2 = sum(int(o[0]) for o in outs)
    logical2 = sum(int(o[1]) for o in outs)
    print(f"bp2_path launches={counts}; logical={logical2}")
    same_counts("bp2_path", flagged2, BP2["steps"] * BP2["batch"])
    check_rate(f"bp2_path [[882,24]] hx BSC p={BP2['p']} {BP2['cn_type']} f={BP2['factor']} "
               f"x{BP2['iters']} B={BP2['batch']}", flagged2, BP2["steps"] * BP2["batch"],
               BP2["ref"], BP2["tf"])
    if counts != expected_counts(K2=BP2["steps"]):
        raise AssertionError(f"kernel launches {counts} in {BP2['steps']} bp2_path steps")
    rates, step_ms, _ = timed_windows(bp2_step, (gen, BP2["p"]), BP2["batch"])
    bp2_ms = report_rate(f"bp2_path throughput [[882,24]] hx B={BP2['batch']} p={BP2['p']}",
                         rates, step_ms, card)
    phase("bp2_path", t0)

    # 8. the plain gather BP4 path on [[882,24]] (runs no kernel)
    t0 = time.perf_counter()
    graph882 = codes["n882"][0]

    def bp4_step(g, p):
        return bp4_plain_eval_step(graph882, g, p, BP4_PLAIN["batch"], num_iter=BP4_PLAIN["iters"],
                                   cn_type=BP4_PLAIN["cn_type"],
                                   normalization_factor=BP4_PLAIN["factor"])

    gen = torch.Generator(device=device).manual_seed(6)
    reset_counts()
    flagged4 = logical4 = 0
    bp4_step_ms = []
    for _ in range(BP4_PLAIN["steps"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        f, lg = bp4_step(gen, BP4_PLAIN["p"])
        flagged4 += int(f)
        logical4 += int(lg)
        torch.cuda.synchronize()
        bp4_step_ms.append((time.perf_counter() - t1) * 1e3)
    same_counts("bp4_plain_path", flagged4, BP4_PLAIN["steps"] * BP4_PLAIN["batch"])
    print(f"bp4_plain_path launches={read_counts()}; logical={logical4}; ms per step "
          + ", ".join(f"{t:.3f}" for t in bp4_step_ms) + f" on {card}")
    check_rate(f"bp4_plain_path [[882,24]] p={BP4_PLAIN['p']} {BP4_PLAIN['cn_type']} "
               f"f={BP4_PLAIN['factor']} x{BP4_PLAIN['iters']} B={BP4_PLAIN['batch']}",
               flagged4, BP4_PLAIN["steps"] * BP4_PLAIN["batch"], BP4_PLAIN["ref"], BP4_PLAIN["tf"])
    bp4_ms = statistics.median(bp4_step_ms)
    phase("bp4_plain_path", t0)

    # 9. K2 against its plain version, and both times, at the bp2_path shape
    t0 = time.perf_counter()
    from feedback_gnn_tpu_torch.decoders.bp2_qc import bp2_qc_logits, bp2_qc_logits_plain

    from feedback_gnn_tpu_torch.decoders import bp2_qc

    llr, syn = bsc_inputs(hx, BP2["batch"], BP2["p"], device, seed=7)
    k2_args = (spec882, llr, syn, BP2["iters"], BP2["cn_type"], BP2["factor"])
    plan = bp2_qc._launch_plan(spec882, BP2["batch"], BP2["cn_type"])
    blocks, regs, spill = bp2_qc._occupancy(spec882, BP2["cn_type"], plan)
    key = ("bp2_qc_kernel", (bp2_qc.CN_TYPES.index(BP2["cn_type"]),) + plan.instance)
    label = f"K2 n882 hx B={BP2['batch']} iters={BP2['iters']} {BP2['cn_type']}"
    print(f"{label}: instance (DC, DV)={plan.instance}, {plan.regime} batch: {plan.threads} threads x "
          f"{plan.samples_per_block} samples per block ({plan.blocks(BP2['batch'])} blocks), "
          f"{plan.nodes_per_thread} nodes per thread, {plan.smem_bytes} B shared; resident blocks per "
          f"SM {blocks} (planned {plan.blocks_per_sm}); registers {regs} (ptxas {registers.get(key)}), "
          f"local {spill} B")
    k2_ms = time_ms(lambda: bp2_qc_logits(*k2_args), reps=10)
    ref = bp2_qc_logits_plain(*k2_args)
    k2_err = max(k2_err, check_k2(label, bp2_qc_logits(*k2_args), ref))
    grid = time_plans(label, plan_grid(lambda t, spb: bp2_qc._launch_plan(spec882, BP2["batch"], BP2["cn_type"], t, spb),
                                spec882.nb * spec882.l, bp2_qc.K2_MAX_THREADS),
               plan, lambda p: bp2_qc._launch_kernel(spec882, llr, syn, BP2["iters"], BP2["cn_type"],
                                                     BP2["factor"], p), ref, card)
    del ref
    k2_plain_ms = time_ms(lambda: bp2_qc_logits_plain(*k2_args), reps=2)
    k2_b_ms, k2_b_by = k2_bound_ms(spec882, BP2["batch"], BP2["iters"], BP2["cn_type"])
    print(f"{label}: kernel {k2_ms:.4f} ms (previous design {PREVIOUS_K2_MS:.4f} ms, ratio "
          f"{k2_ms / PREVIOUS_K2_MS:.3f}; in a CUDA graph {grid[plan]:.4f} ms), plain "
          f"{k2_plain_ms:.4f} ms, bound {k2_b_ms:.5f} ms ({k2_b_by}) on {card}")
    phase("k2_timing", t0)

    # 10. the probes of scripts/probe_pallas*.py
    t0 = time.perf_counter()
    probe_rows = run_probes(device, card)
    phase("probes", t0)

    # 11. where a step's device time goes
    t0 = time.perf_counter()
    profile_step("main path [[882,24]] B=256 p=0.08", fn, (gen, 0.08), main_ms, card)
    profile_step(f"bench [[1270,28]] B={BENCH['batch']} p={BENCH['p']}", step, (gen, BENCH["p"]),
                 bench_ms, card)
    profile_step(f"bp2_path [[882,24]] hx B={BP2['batch']} p={BP2['p']}", bp2_step, (gen, BP2["p"]),
                 bp2_ms, card)
    profile_step(f"bp4_plain_path [[882,24]] B={BP4_PLAIN['batch']} p={BP4_PLAIN['p']}", bp4_step,
                 (gen, BP4_PLAIN["p"]), bp4_ms, card)
    phase("profile", t0)

    k_ms, p_ms, b_ms, b_by = timing[("n882", 256, 64)]
    kernels = {"kernels": [
        {
            "name": "bp4_qc_marginals",
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/bp4_qc.cu",
            "replaces": "feedback_gnn_tpu/decoders/bp4_qc.py:329",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        },
        {
            "name": "bp2_qc_logits",
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/bp2_qc.cu",
            "replaces": "feedback_gnn_tpu/decoders/bp2_qc.py:116",
            "launches": k2_launches,
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_b_ms,
            "bound_by": k2_b_by,
            "library_ms": None,
        },
        *probe_rows,
    ]}
    print(f"phase total: {time.perf_counter() - t_all:.2f} s")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
