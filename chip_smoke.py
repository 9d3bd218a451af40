#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (feedback_gnn_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from feedback_gnn_tpu_torch/csrc with nvcc,
holds it against its plain PyTorch version on the card, drives the main
path (the [[882,24]] sandwich cascade of feedback_gnn_tpu_torch.entry, then
the [[1270,28]] compacted workload of bench.py) and checks the decoded
logical error rate.  Prints each phase's seconds, the card's name and power
limit, one JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}.  Exits non-zero, with no result line, when
there is no CUDA card or any phase fails.  Imports no JAX.
"""

from __future__ import annotations

import faulthandler
import json
import statistics
import subprocess
import sys
import time

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
# kernel against plain version: rtol = atol = 2e-3 on the marginals, the
# JAX suite's own tolerance for kernel-versus-reference marginals
RTOL = ATOL = 2e-3
CMP_BATCH, CMP_ITERS = 256, 64
CASES = [
    ("boxplus-phi", None),
    ("boxplus-phi", "tf"),
    ("boxplus-phi", "accurate"),
    ("boxplus", None),
    ("minsum", None),
]

# Work of one decode, for the bound: float32 operations per edge and
# iteration (transcendentals counted as one each), read off csrc/bp4_qc.cu.
VN_OPS_PER_EDGE = 12  # sum-add, two subs, lse_neg (8), sub
VN_OPS_PER_NODE = 18  # marginals (4 adds), two softplus (7 each)
CN_OPS_PER_EDGE = {
    ("boxplus-phi", None): 24,  # sign, abs, 2 phi (8 each, tanh form), 5 mul/add
    ("boxplus-phi", "tf"): 36,  # phi in the tf form: 14 each
    ("boxplus-phi", "accurate"): 28,  # phi in the accurate form: 10 each
    ("boxplus", None): 14,
    ("minsum", None): 15,
}
H100_F32_OPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3, H100 SXM data sheet


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
    error and the share of agreeing decisions, raise outside tolerance."""
    from feedback_gnn_tpu_torch.decoders.bp4 import hard_decision

    torch.cuda.synchronize()
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    ok = all(bool(((o - r).abs() <= ATOL + RTOL * r.abs()).all()) for o, r in zip(out, ref))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    from feedback_gnn_tpu_torch import _build, resolve_device
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
    for line in info["ptxas"].splitlines():
        if "ptxas" in line or "Used" in line or "spill" in line:
            print(f"  {line.strip()}")
    phase("build", t0)

    t0 = time.perf_counter()
    codes = {nm: load_code(nm, device) for nm in ("n882", "n1270")}
    phase("codes", t0)

    # 3. kernel against plain version
    t0 = time.perf_counter()
    max_err = compare_kernel(codes, device)
    phase("kernel_vs_plain", t0)

    # 4. the main path
    t0 = time.perf_counter()
    bp4_qc.launches = 0
    fn, gen, flagged, logical, samples = run_main_path(device)
    launches = bp4_qc.launches
    ler = logical / samples
    sigma = (LER_REF * (1 - LER_REF) / samples) ** 0.5
    print(f"main path [[882,24]] nG=3 p={LER_P}: flagged={flagged} logical={logical}/{samples} "
          f"LER={ler:.5f} ref={LER_REF} ({abs(ler - LER_REF) / sigma:.2f} sigma) K1 launches={launches}")
    if abs(ler - LER_REF) >= LER_SIGMAS * sigma:
        raise AssertionError(f"LER {ler} outside {LER_SIGMAS} sigma of {LER_REF}")
    if launches != LER_STEPS * (1 + 3):
        raise AssertionError(f"K1 launched {launches} times, expected {LER_STEPS * 4}")
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
    bp4_qc.launches = 0
    rates, step_ms, counts = timed_windows(step, (gen, BENCH["p"]), BENCH["batch"])
    launches_b = bp4_qc.launches
    flagged_b = sum(int(c[0]) for c in counts)
    logical_b = sum(int(c[1]) for c in counts)
    overflow = sum(int(c[2]) for c in counts)
    bench_ms = report_rate(f"bench [[1270,28]] nG=5 p={BENCH['p']} B={BENCH['batch']}", rates, step_ms, card)
    print(f"bench: {len(counts)} steps, flagged={flagged_b} logical={logical_b} overflow={overflow} "
          f"K1 launches={launches_b}")
    if overflow != 0:
        raise AssertionError(f"compaction overflow {overflow}")
    if launches_b != len(counts) * (2 + cfg.num_rounds):
        raise AssertionError(f"K1 launched {launches_b} times in {len(counts)} bench steps")
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
        saved = bp4_qc.launches
        out = bp4_qc.bp4_qc_marginals(qc_s, llr, sx, sz, iters)
        k_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals(qc_s, llr, sx, sz, iters), reps=10)
        bp4_qc.launches = saved  # comparison and timing launches do not count
        ref = bp4_qc.bp4_qc_marginals_plain(qc_s, llr, sx, sz, iters)
        max_err = max(max_err, check_against_plain(f"{nm} B={batch} iters={iters}", out, ref))
        del out, ref
        p_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals_plain(qc_s, llr, sx, sz, iters), reps=2)
        b_ms, b_by = k1_bound_ms(qc_s, batch, iters)
        timing[(nm, batch, iters)] = (k_ms, p_ms, b_ms, b_by)
        print(f"K1 {nm} B={batch} iters={iters}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}) on {card}")
    phase("k1_timing", t0)

    # 7. where a step's device time goes (profiled steps do not count)
    t0 = time.perf_counter()
    saved = bp4_qc.launches
    profile_step("main path [[882,24]] B=256 p=0.08", fn, (gen, 0.08), main_ms, card)
    profile_step(f"bench [[1270,28]] B={BENCH['batch']} p={BENCH['p']}", step, (gen, BENCH["p"]),
                 bench_ms, card)
    bp4_qc.launches = saved
    phase("profile", t0)

    k_ms, p_ms, b_ms, b_by = timing[("n882", 256, 64)]
    kernels = {"kernels": [{
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
    }]}
    print(f"phase total: {time.perf_counter() - t_all:.2f} s")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
