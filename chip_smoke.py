#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (feedback_gnn_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from feedback_gnn_tpu_torch/csrc with one
nvcc (K1, the fused QC BP4 decode; K2, the fused QC BP2 decode; the three
probe kernels of csrc/probes.cu), holds each against its plain PyTorch
version on the card, and drives the paths that run them or their
neighbours: the [[882,24]] sandwich cascade of feedback_gnn_tpu_torch.entry
and the [[1270,28]] compacted workload of cli/bench.py (K1); the evaluate
CLI (cli/evaluate.py's run(), [[882,24]] at p=0.08 to 100 logical errors,
K1); the rescue stage (K1's tf and accurate instances); the cascade on the
gather backend (no kernel); the binary BSC evaluation step on
[[882,24]]'s hx (K2); the plain gather BP4 step on [[882,24]] (no kernel);
BP2 + OSD-0 and BP4 + OSD-0 through cli/osd_eval.py (no kernel);
feedback_gnn_tpu_torch.probes.main(), the thirteen probes of
scripts/probe_pallas*.py; training (K1 in both failure miners, each held
bit for bit to its plain version; one train step held to the CPU's; the
loss falling at full width; cli/train_from_scratch.py end to end and
resumed from its artifacts; checkpoint round trips); the fully-learned
GNN_BP4 decoder at full width (the shipped trained weights' LERs against
the JAX package's runs, card against CPU forward and one train step, the
train step's rate, cli/train_gnn_bp4.py end to end) and the example CLIs
(cli/qldpc_codes.py; cli/n1270.py --qc-kernel, K1).  Each decoding path
is checked against a published error rate, each probe against its plain
version, with every kernel's launch count set to 0 just before a path and
read just after.  Prints each phase's seconds, the card's name and power limit, one
JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}.  Exits non-zero, with no
result line, when there is no CUDA card or any phase fails.  Imports no
JAX.
"""

from __future__ import annotations

import contextlib
import copy
import faulthandler
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DEADLINE_S = 1100  # a hang prints every thread's stack and exits non-zero

# The main path: __graft_entry__.entry()'s configuration, checked against
# the TF original's BLER 7.92e-2 at p=0.12 (tests/test_cascade_e2e.py).
LER_P, LER_REF, LER_SIGMAS, LER_STEPS = 0.12, 7.92e-2, 4.5, 16  # 16 x 256 = 4096 samples
# The evaluate CLI on [[882,24]], nG=3, p=0.08, B=20480, to 100 logical
# errors: the TF original's LER 7.55e-5, the JAX package's 7.95e-5
# (RESULTS.md).  Compaction sized by CascadeConfig's rule from the flagged
# shares of [[882,24]] at p=0.08, stage1_flagged(..., 2048, (12, 64),
# seed=1, device="cpu"): 33.2 % after the 12-iteration prepass, 5.3 % after
# the full 64; the phase prints them again at its own batch.  About
# 65 batches reach the target; MAX_ITER bounds a broken decoder's run.
EVALUATE = dict(p=0.08, batch=20480, rounds=3, compact=0.40, prepass=12, rounds_cap=0.08,
                target=100, max_mc_iter=300, ref_tf=7.55e-5, ref_jax=7.95e-5)
# The rescue stage on the evaluate cascade at p=0.10 (no prepass: 62 % are
# still flagged after 12 iterations there, 14.8 % after 64, by the same
# stage1_flagged call at p=0.10, so level 1 holds 25 %), one seeded step
# per setting; its undersized case is one
# sample of capacity (tile 1: the default tile of 128 rounds 1/B up past
# the ~50 samples still flagged after the cascade).
RESCUE = dict(p=0.10, batch=20480, compact=0.25, seed=11)
# The cascade on the gather backend, held as the main path is
GATHER = dict(p=0.12, batch=4096, seed=12)
# BP + OSD-0 (cli/osd_eval.py) against RESULTS.md: BP2 at p=0.05 to 100
# errors, BP4 at p=0.10 for a fixed 6 batches (its gather BP4 takes ~1.5 s
# a batch); OSD sub-batches sized from the flagged rates that bp2_path and
# bp4_plain_path measure for the same BP.  The card's OSD-0 is held to the
# CPU's on the first OSD_CHECK_SAMPLES samples of one sub-batch of each.
OSD_BP2 = dict(p=0.05, batch=20480, ref=6.51e-4, target=100, max_mc_iter=40)
OSD_BP4 = dict(p=0.10, batch=20480, ref=4.02e-4, steps=6)
OSD_CHECK_SAMPLES = 64
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
# resident_loop): the element read and written.  The index does not change
# across iterations and need be read only once (the loops hold it in
# registers); the bound that also charged a gather's index read every
# iteration, 12 B, is printed beside for comparison with older records.
LOOP_SMEM_BYTES = {"gather_loop": 8, "take_along_loop": 8, "roll_loop": 8}
LOOP_SMEM_BYTES_WITH_INDEX = {"gather_loop": 12, "take_along_loop": 12}
# The probe kernels' times before the redesign of the gather and shift
# kernels (single passes a thread an element, loops a block loading its
# column alone), microseconds, by this script on an NVIDIA H100 80GB HBM3
# at 700 W (graphs of 200): a probe slower than before shows here
PROBE_BEFORE_US = {"k1": 3.11, "k2": 1.91, "k2b": 1.95, "k3": 3.08, "k4": 1.53, "k5": 3.25, "k6": 43.78,
                   "ka": 3.31, "kb": 3.22, "kc": 2.64, "kd": 2.97, "ke": 45.40, "kf": 38.64}

# Training on [[882,24]] at full width (the shipped GNN's 20 message dims
# and 40 hidden units, the published BP4-64 / GNN + BP4-16 schedule, B=100):
# the K1 miners against their plain versions at weight 40 (the easy miner
# at B=2048, the hard one with the shipped coarse GNN at B=1024, both
# compacted to 2048 columns); the miners' rates at the curriculum's batch
# of 8192 at weight 60, whose easy failures (BP4-64 flags ~3 % there, ~1 %
# at 40) make the train batch; one train step's loss and gradients on the
# card against the CPU at tests/test_training.py's 16/8 schedule
# (loss_from 4), and at the published 64/16 printed only.  The check feeds
# the CPU's stage 2 the card's stage-1 features: on these non-converging
# samples each device's own BP4 trajectory from the uniform prior turns
# ulp differences of the math libraries into other marginals (printed
# beside).  Then the loss falling over 15 steps at lr 1e-3 from a fresh
# init; the published step's rate and memory.
TRAIN = dict(wt=40, easy_batch=2048, hard_batch=1024, iters=64, cap=2048, mine_batch=8192, mine_wt=60,
             mine_reps=6, step_batch=100, check=dict(num_iter1=16, num_iter2=8, loss_from=4),
             full=dict(num_iter1=64, num_iter2=16, loss_from=8), loss_rtol=1e-4, grad_rel=1e-3,
             fall_steps=15, fall_lr=1e-3, rate_steps=20, seed=21)
# The curriculum CLI end to end: every count cut, no width.  16 weights
# 30..60 (the published 4..60 in steps of 2 from 30 on), 2 mining batches
# of 8192 per weight (published 60), 512 easy / 16 hard failures kept per
# weight (12000 / 3000), one epoch per model (coarse 4, final 1), the
# evaluation at p=0.10 only, to 20 logical errors (0.10 and 0.09, to 100).
CURRICULUM = ["--wt", "30", "60", "--mine-batches", "2", "--mine-batch-size", "8192",
              "--mine-compact-cap", "2048", "--easy-cap", "512", "--hard-cap", "16",
              "--coarse-epochs", "1", "--final-epochs", "1", "--batch-size", "100",
              "--eval-p", "0.10", "--eval-batch", "20480", "--eval-target-errors", "20"]
# GNN_BP4 (decoders/gnn_full.py) at the full width of the JAX package's
# trained runs (20/20/40, 8 iterations, mean, no bias, boxplus-phi).  The
# shipped trained weights (feedback_gnn_tpu_torch/weights/) against the
# logical counts of those runs (runs/gnn_bp4_{n882,gb48}.json: the JAX
# package's own CPU run repeats them from the same keys), within SIGMAS of
# the two-sample difference: (code, p, reference logical count, its
# blocks, batches of `batch` here, checked); n882 at p=0.02 has too few
# errors to check.  Card against CPU on shared inputs: the per-iteration
# check/logical logits at B=256 (relative L2 a stack) and the hard
# decisions, then one loss (rtol loss_rtol) and its gradient leaves
# (relative L2) at the train batch.  The logits' and the leaves' limits
# are the larger of stack_rel / grad_rel and ulp_factor times their
# float32 floor: the relative L2 that moving every trained weight by one
# ulp (seeded) gives, on the card and on the CPU, added in quadrature.
# phi's staircase at large arguments (softplus(x) - log(expm1(x)), both
# near x) turns ulps into logit differences of up to ~1.5 at |logit|
# 10-16, which the CN embeddings carry on: at these inputs float32 cannot
# hold two implementations within 1e-3.  The train step's rate and
# memory at B=120 from a fresh init; cli/train_gnn_bp4.py at cut counts
# (200 steps and 5 evaluation batches, published 4000 and 50; no width
# cut); cli/qldpc_codes.py's table; cli/n1270.py --qc-kernel for 2 batches.
GNN_BP4 = dict(
    batch=2048, seed=31, sigmas=4.5,
    ler=[("n882", 0.03, 170, 102400, 50, True), ("n882", 0.02, 37, 102400, 50, False),
         ("gb48", 0.05, 3578, 40960, 20, True), ("gb48", 0.03, 836, 40960, 20, True)],
    precision_diag=[("n882", 0.03, 170, 102400, 50, False)],
    # the JAX package on the CPU (float32) on the n882 run's own keys
    # (fold_in(fold_in(PRNGKey(0), 5000 + b), 300), b < 50, B=2048): 217,
    # against the TPU run's 170; printed beside, not checked
    jax_cpu={("n882", 0.03): (217, 102400)},
    check_batch=256, check_p=0.03, stack_rel=1e-3, ulp_factor=2.0, ulp_seed=5, decisions=0.9999,
    train_batch=120, train_p=0.03, loss_rtol=1e-4, grad_rel=1e-3, rate_steps=20,
    cli=["--code", "n882", "--steps", "200", "--train-p", "0.03", "--eval-p", "0.03",
         "--eval-batches", "5"],
    n1270=["-p", "0.10", "--qc-kernel", "--max-mc-iter", "2"], n1270_batch=5000,
    zoo={"Steane": (7, 1), "Surface d=3": (13, 1), "Rotated surface d=3": (9, 1),
         "Toric (checkerboard) d=4": (16, 2), "HGP(rep5, rep5)": (41, 1), "GB [[254,28]]": (254, 28),
         "GB [[48,6,8]] overcomplete": (48, 6), "GB [[46,2,9]] overcomplete": (46, 2),
         "GHP [[882,24]]": (882, 24)},
)
# Multi-device (parallel/): ranks are processes of this machine's one card,
# so two ranks share it (Gloo) and one rank alone takes NCCL.  (a) the
# evaluate configuration data-parallel on 2 ranks (20480 = 2 x 10240), its
# counts against the same two per-rank seeds run unsharded here; (b) one
# rank on NCCL at 20480 against the unsharded step; (c) cli/evaluate.py
# --data-shards 2 for `cli_batches` batches; (d) the DP train step on 2
# ranks at the published 64/16 schedule on B=100 stage-1 failures (the
# first of `train_pool` fixed-weight samples at weight 80 that BP-64
# leaves flagged, as the miners keep them), against the single-process
# step (stage 2 on shared stage-1 features at TRAIN's rule; the whole step
# as tests/test_sharding.py holds JAX's); (e) the gather cascade
# edge-sharded over 2 ranks at GATHER's point against the unsharded decode
# on the same noise, at two schedules: the short one (`edge_short`
# iterations, where moving the prior LLRs by one ulp changes next to no
# decision) must agree on at least `agree` of the samples, which a wrong
# vn_sum or shard layout cannot; the published 64/16, where BP4 turns ulps
# into other decisions, on all but twice the share that the ulp move
# changes in the unsharded decode itself, with its LER held to the main
# path's reference as gather_cascade is; cli/bench_scaling.py for 1 and 2
# ranks.  Every child has a join deadline and every collective a timeout.
PARALLEL = dict(p=0.08, batch=20480, seeds=[101, 102, 103, 104], cli_batches=3, train_batch=100,
                train_pool=2048, train_wt=80, train_seed=41, edge_seed=43, edge_short=(8, 4), agree=0.999,
                floor_factor=2.0, cosine=0.75, timeout_s=240.0, join_s=300.0, scaling=["--code", "n882", "--local-batch", "10240", "--shards", "1", "2",
                                       "--qc-kernel", "--iters", "4", "-p", "0.08", "-nG", "3"])
CURRICULUM_ARTIFACTS = ("n882_easy.npz", "n882_coarse_16_16.npz", "n882_hard.npz",
                        "n882_final_64_16_mixed.npz", "n882_scratch_eval.json")


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


def report_rate(label, rates, step_ms, card):
    from feedback_gnn_tpu_torch.cli.bench import WINDOW_S

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


def sigmas(count, samples, ref):
    """(rate, distance from ``ref`` in binomial sigmas at ``samples``)."""
    rate = count / samples
    return rate, abs(rate - ref) / (ref * (1 - ref) / samples) ** 0.5


def stage1_flagged(graph, qc, p, batch, iters_list, seed, device):
    """{iterations: flagged share} of one seeded depolarizing batch after
    stage-1 BP4 of each length: the shares a compaction level must hold
    (CascadeConfig's sizing rule), counted outside the cascade."""
    from feedback_gnn_tpu_torch.channels import depolarizing_probs, pauli_iid
    from feedback_gnn_tpu_torch.decoders.bp4_qc import bp4_decode_qc
    from feedback_gnn_tpu_torch.decoders.cascade import prior_llr
    from feedback_gnn_tpu_torch.ops import mod2_matmul

    g = torch.Generator(device=device).manual_seed(seed)
    nx, nz = pauli_iid(g, *depolarizing_probs(p), graph.n, batch)
    pad = (0, 0, 0, graph.n_pad - graph.n)
    nx, nz = (torch.nn.functional.pad(t.to(torch.int32), pad) for t in (nx, nz))
    sx, sz = mod2_matmul(graph.hx, nz), mod2_matmul(graph.hz, nx)
    llr = prior_llr(0.05, graph.n, batch, graph.n_pad, device=device)
    shares = {}
    for iters in iters_list:
        r = bp4_decode_qc(graph, qc, llr, sx, sz, iters, need_logits=False)
        est = torch.cat([mod2_matmul(graph.hz, r.x_hat), mod2_matmul(graph.hx, r.z_hat)])
        shares[iters] = int((est != torch.cat([sz, sx])).any(0).sum()) / batch
    return shares


def osd_capacity(flagged_rate, batch):
    """OSD sub-batch size for a BP flagged rate: the mean flagged count of
    a batch plus 8 standard deviations, rounded up to 128."""
    mean = flagged_rate * batch
    sd = (batch * flagged_rate * (1 - flagged_rate)) ** 0.5
    return -(-int(mean + 8 * sd + 1) // 128) * 128


class OsdRecorder:
    """Stands in for osd0_decode where the OSD steps call it (models.py,
    decoders/osd.py) and keeps the first call's inputs and output."""

    def __init__(self):
        from feedback_gnn_tpu_torch import models
        from feedback_gnn_tpu_torch.decoders import osd

        self.modules, self.real, self.first = (models, osd), osd.osd0_decode, None

    def __call__(self, llr, pcm, syndrome):
        out = self.real(llr, pcm, syndrome)
        if self.first is None:
            self.first = (llr.clone(), pcm, syndrome.clone(), out.clone())
        return out

    def __enter__(self):
        for m in self.modules:
            m.osd0_decode = self
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.osd0_decode = self.real


def osd_card_vs_cpu(label, rec, card):
    """osd0_decode on the card against osd0_decode on the CPU, on the first
    OSD_CHECK_SAMPLES samples of the recorded sub-batch (each sample's
    elimination is its own); raise unless equal.  Returns the card's ms
    for the whole sub-batch."""
    from feedback_gnn_tpu_torch.decoders.osd import osd0_decode

    llr, pcm, syn, out = rec.first
    k = min(OSD_CHECK_SAMPLES, llr.shape[0])
    t1 = time.perf_counter()
    cpu = osd0_decode(llr[:k].cpu(), pcm, syn[:, :k].cpu())
    cpu_s = time.perf_counter() - t1
    again = osd0_decode(llr[:k], pcm, syn[:, :k]).cpu()
    ok = torch.equal(out[:k].cpu(), cpu) and torch.equal(again, cpu)
    ms = time_ms(lambda: osd0_decode(llr, pcm, syn), reps=2)
    print(f"  {label}: osd0_decode on the card vs the CPU, {k} of {llr.shape[0]} samples "
          f"x {llr.shape[1]} columns, rank {syn.shape[0]}: {'equal' if ok else 'DIFFERENT'} "
          f"(CPU {cpu_s:.2f} s); the whole sub-batch {ms:.3f} ms on {card}")
    if not ok:
        raise AssertionError(f"{label}: osd0_decode on the card differs from the CPU")
    return ms


def profile_sim_ler(label, step, p, batch, steps, device, card):
    """The device idle share of sim_ler: the device's busy time over a short
    sweep of ``steps`` batches (torch.profiler) against the same sweep's
    unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from feedback_gnn_tpu_torch.sim import sim_ler

    kw = dict(batch_size=batch, max_mc_iter=steps, num_target_block_errors=None, verbose=False,
              device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim_ler(step, [p], **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        sim_ler(step, [p], **kw)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    print(f"profile {label}: sim_ler over {steps} batches: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f} on {card}")


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


def probe_bounds_ms(p, out, smem_bytes=LOOP_SMEM_BYTES):
    """The probe's least time on an H100, (ms, by, memory), the largest of:
    its inputs read once and its output written once over the memory rate;
    its float32 operations (one multiply per element and iteration in the
    loops, phi's PHI_OPS) over the f32 rate; and for the loops the bytes
    each iteration moves through shared memory (``smem_bytes`` an element)
    over its rate.  ``memory`` names the memory whose bytes bind, None if
    operations do."""
    nbytes = sum(t.numel() * t.element_size() for t in p.args if torch.is_tensor(t))
    nbytes += out.numel() * out.element_size()
    ops = out.numel() * (PHI_OPS.get(p.name, 0) + (p.iters if p.iters > 1 else 0))
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_F32_OPS
    t_smem = p.iters * smem_bytes.get(p.name, 0) * out.numel() / H100_SMEM_BYTES
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


def loop_plan_grid(p, card):
    """The loop ``p`` under other launch plans than _loop_plan's: clusters of
    1, 2, 4 and 8 columns, and of 8 with each block asking for more than
    half an SM's shared memory (one block an SM).  Each held bit for bit
    against the plain version, timed at 64 and 2 iterations, printed with
    the clusters the card holds at once."""
    from feedback_gnn_tpu_torch import probes
    from feedback_gnn_tpu_torch.decoders.bp4_qc import SM_BLOCK_RESERVED, SM_SMEM

    x = p.args[0]
    base = probes._loop_plan(*x.shape)
    kind = {"gather_loop": 0, "take_along_loop": 1, "roll_loop": 2}[p.name]
    if kind == 2:
        def run(plan, iters):
            return probes._launch_shift(p.name, x, -probes.ROLL_SHIFT, x.shape[0], iters, probes.LOOP_SCALE, plan)
    else:
        def run(plan, iters):
            return probes._launch_gather(p.name, x, p.args[1], 0, iters, probes.LOOP_SCALE, plan)
    ref = p.plain(*p.args)
    one_per_sm = SM_SMEM // 2 - SM_BLOCK_RESERVED + 4
    for cluster, smem in [(1, base.smem_bytes), (2, base.smem_bytes), (4, base.smem_bytes), (8, base.smem_bytes),
                          (8, max(base.smem_bytes, one_per_sm))]:
        plan = probes.LoopPlan(cluster, -(-x.shape[1] // cluster) * cluster, base.threads, base.rows_per_thread,
                               smem)
        out = run(plan, p.iters)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{p.key} under {plan} disagrees with its plain version")
        full_ms = graph_ms(lambda: run(plan, p.iters), reps=PROBE_REPS)
        two_ms = graph_ms(lambda: run(plan, 2), reps=PROBE_REPS)
        per_us = (full_ms - two_ms) / (p.iters - 2) * 1e3
        print(f"  {p.key} plan cluster={cluster} threads={plan.threads}x{plan.rows_per_thread} smem={smem} "
              f"({probes.loop_clusters(kind, plan)} clusters at once{', chosen' if plan == base else ''}): "
              f"{full_ms * 1e3:.3f} us a call, {per_us:.4f} us an iteration, fixed "
              f"{full_ms * 1e3 - p.iters * per_us:.3f} us on {card}")


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
    # the launch floor: the gather kernel on a [1, 1] input, timed as the
    # probes are (a graph of PROBE_REPS), the least a probe's call can take
    one = torch.ones((1, 1), device=device)
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    if not torch.equal(probes.take_rows(one, zero), one):
        raise AssertionError("take_rows on [1, 1] disagrees with its input")
    floor_ms = graph_ms(lambda: probes.take_rows(one, zero), reps=PROBE_REPS)
    print(f"probes launch floor: take_rows on [1, 1] {floor_ms * 1e3:.4f} us a call (graph of "
          f"{PROBE_REPS}) on {card}", flush=True)
    probe_rows = []
    for p in probes.probe_cases(probes.probe_inputs(device)):
        out = p.fn(*p.args)
        ref = p.plain(*p.args)
        torch.cuda.synchronize()
        err = probes.compare(p, out, ref)
        # these calls take microseconds on the card, less than the host
        # spends launching them: time them in CUDA graphs (the median of
        # three), and show the host-paced time of back-to-back eager calls
        # beside
        k_ms = statistics.median(graph_ms(lambda: p.fn(*p.args), reps=PROBE_REPS) for _ in range(3))
        eager_ms = time_ms(lambda: p.fn(*p.args), reps=PROBE_REPS)
        pl_ms = graph_ms(lambda: p.plain(*p.args), reps=PROBE_PLAIN_REPS)
        lib = probe_library(p)
        lib_ms = None
        if lib is not None:
            if not torch.equal(lib(), ref):
                raise AssertionError(f"{p.key}: the library call disagrees with the plain version")
            lib_ms = graph_ms(lib, reps=PROBE_REPS)
        b_ms, b_by, b_mem = probe_bounds_ms(p, out)
        before_us = PROBE_BEFORE_US[p.key]
        print(f"probe {p.key} {p.name} {list(p.args[0].shape)}: max_abs_err={err:.3e} "
              f"kernel {k_ms:.5f} ms (eager back to back {eager_ms:.5f} ms), plain {pl_ms:.5f} ms, "
              "library " + (f"{lib_ms:.5f} ms" if lib_ms is not None else "none")
              + f", bound {b_ms:.5f} ms ({b_by}" + (f" through {b_mem}" if b_mem else "")
              + f"), launch floor {floor_ms:.5f} ms; before the redesign {before_us:.2f} us"
              + (" (SLOWER than before)" if k_ms * 1e3 > before_us else "") + f" on {card}", flush=True)
        row = {}
        if p.name in LOOP_SMEM_BYTES_WITH_INDEX:
            old_ms = probe_bounds_ms(p, out, LOOP_SMEM_BYTES_WITH_INDEX)[0]
            print(f"  {p.key} bound with the index read every iteration (12 B, the older bound): "
                  f"{old_ms:.5f} ms; with the index once (8 B): {b_ms:.5f} ms")
        if p.iters > 1:  # the loops: what one more iteration on chip costs (a
            # single pass takes another route, so the yardstick is two), and
            # what the call costs besides its iterations
            two_ms = graph_ms(lambda: p.fn(*p.args, iters=2), reps=PROBE_REPS)
            per_iter_us = (k_ms - two_ms) / (p.iters - 2) * 1e3
            fixed_us = k_ms * 1e3 - p.iters * per_iter_us
            print(f"  {p.key} two iterations per call: {two_ms:.5f} ms; each further iteration "
                  f"{per_iter_us:.4f} us, on-chip bound {b_ms / p.iters * 1e3:.4f} us; fixed part "
                  f"{fixed_us:.4f} us (call less {p.iters} iterations) on {card}")
            row = {"per_iter_us": per_iter_us, "fixed_us": fixed_us}
            if p.name == "gather_loop":
                loop_bank_probe(p, per_iter_us, card)
            loop_plan_grid(p, card)
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
            "launch_floor_ms": floor_ms,
            **row,
        })
    return probe_rows


def run_evaluate(codes, device, card, E=EVALUATE):
    """cli/evaluate.py's run() on [[882,24]] to 100 logical errors; checks
    the target, the overflow, the LER and K1's launches, prints the flagged
    share at each compaction level and the throughput.  Returns the step
    (for the profile) and its ms per batch."""
    from feedback_gnn_tpu_torch.cli import evaluate
    from feedback_gnn_tpu_torch.config import config_from_args, make_eval_parser

    graph, qc, _ = codes["n882"]
    cfg = config_from_args(make_eval_parser().parse_args([
        "-c", "n882", "-p", str(E["p"]), "-nG", str(E["rounds"]), "-bs", str(E["batch"]), "--qc-kernel",
        "--compact", str(E["compact"]), "--prepass", str(E["prepass"]), "--rounds-cap", str(E["rounds_cap"]),
        "--target-errors", str(E["target"]), "--max-mc-iter", str(E["max_mc_iter"]), "--device", str(device)]))
    full = cfg.cascade.num_iter1
    shares = stage1_flagged(graph, qc, E["p"], E["batch"], (E["prepass"], full), seed=8, device=device)
    reset_counts()
    res = evaluate.run(cfg)
    counts = read_counts()
    steps = int(res.num_blocks[0]) // E["batch"]
    step_ms = float(res.runtime[0]) / steps * 1e3
    logical, blocks = int(res.logical_errors[0]), int(res.num_blocks[0])
    ler, sig_tf = sigmas(logical, blocks, E["ref_tf"])
    _, sig_jax = sigmas(logical, blocks, E["ref_jax"])
    print(f"evaluate [[882,24]] nG={E['rounds']} p={E['p']} B={E['batch']}: flagged share after the "
          f"{E['prepass']}-iteration prepass {shares[E['prepass']]:.5f} (capacity {E['compact']}), after "
          f"the full {full} {shares[full]:.5f} (capacity {E['rounds_cap']}), after the cascade "
          f"{res.flagged_rate[0]:.3e}")
    print(f"evaluate: logical {logical}/{blocks} LER={ler:.4e} in {steps} batches, status "
          f"{int(res.status[0])}, overflow {int(res.overflow[0])}; TF original {E['ref_tf']} ({sig_tf:.2f} "
          f"sigma), JAX package {E['ref_jax']} ({sig_jax:.2f} sigma); launches={counts}")
    print(f"evaluate throughput: {res.throughput[0]:.1f} syndromes/s (sim_ler, {step_ms:.3f} ms per "
          f"batch) on {card}")
    if int(res.status[0]) != 4:
        raise AssertionError(f"evaluate did not reach {E['target']} logical errors in {E['max_mc_iter']} batches")
    if int(res.overflow[0]) != 0:
        raise AssertionError(f"evaluate: compaction overflow {int(res.overflow[0])}")
    if sig_tf >= LER_SIGMAS:
        raise AssertionError(f"evaluate: LER {ler} outside {LER_SIGMAS} sigma of {E['ref_tf']}")
    if counts != expected_counts(K1=steps * (2 + E["rounds"])):  # prepass, subset, rounds
        raise AssertionError(f"kernel launches {counts} in {steps} evaluate batches")
    return {"step": evaluate.make_step(cfg, device)[1], "ms": step_ms}


def run_rescue(codes, device, card, R=RESCUE, rounds=EVALUATE["rounds"]):
    """One seeded step of the compacted cascade per rescue setting: none,
    tf, tf then accurate at capacity 0.02, and tf at one sample of
    capacity.  The flagged count never rises, the overflow is 0 at 0.02
    and not at one sample, and K1 runs (1 + nG) launches per stage.
    Returns the tf,accurate step, its ms, and the rescue capacity."""
    from dataclasses import replace

    from feedback_gnn_tpu_torch.decoders.cascade import CascadeConfig, _capacity, sandwich_eval_step

    graph, qc, params = codes["n882"]
    base = CascadeConfig(num_rounds=rounds, compact_fraction=R["compact"])
    rows = {}
    for rescue, fraction, tile in ((None, 0.02, 128), ("tf", 0.02, 128), ("tf,accurate", 0.02, 128),
                                   ("tf", 1 / R["batch"], 1)):
        cfg = replace(base, rescue_phi=rescue, rescue_fraction=fraction, qc_batch_tile=tile)
        gen = torch.Generator(device=device).manual_seed(R["seed"])
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flagged, logical, overflow = (int(o) for o in sandwich_eval_step(
            graph, [params], cfg, gen, R["p"], R["batch"], qc=qc, return_overflow=True))
        ms = (time.perf_counter() - t1) * 1e3
        counts = read_counts()
        stages = len(rescue.split(",")) if rescue else 0
        print(f"rescue {rescue} (capacity {_capacity(fraction, R['batch'], tile)}) p={R['p']} "
              f"B={R['batch']}: flagged={flagged} logical={logical} overflow={overflow}, {ms:.3f} ms, "
              f"launches={counts} on {card}")
        if counts != expected_counts(K1=(1 + rounds) * (1 + stages)):
            raise AssertionError(f"rescue {rescue}: kernel launches {counts}, expected K1="
                                 f"{(1 + rounds) * (1 + stages)}")
        rows[(rescue, tile)] = (flagged, overflow, ms)
    f_none, f_tf, f_both = (rows[(k, 128)][0] for k in (None, "tf", "tf,accurate"))
    under = rows[("tf", 1)]
    if not f_both <= f_tf <= f_none:
        raise AssertionError(f"rescue raised the flagged count: {f_none}, {f_tf}, {f_both}")
    if any(rows[(k, 128)][1] for k in (None, "tf", "tf,accurate")):
        raise AssertionError("rescue: overflow at rescue_fraction 0.02")
    if not (under[1] > 0 and under[0] <= f_none):
        raise AssertionError(f"rescue at one sample of capacity: overflow {under[1]}, flagged {under[0]}")
    cfg = replace(base, rescue_phi="tf,accurate")

    def step(gen, p):
        return sandwich_eval_step(graph, [params], cfg, gen, p, R["batch"], qc=qc, return_overflow=True)

    return {"step": step, "ms": rows[("tf,accurate", 128)][2], "capacity": _capacity(0.02, R["batch"], 128)}


def run_gather_cascade(device, card, G=GATHER, rounds=EVALUATE["rounds"]):
    """One step of the evaluate step on the gather backend (no
    --qc-kernel): LER within LER_SIGMAS of the main path's reference, no
    kernel launched.  Returns the step and its ms."""
    from feedback_gnn_tpu_torch.cli import evaluate
    from feedback_gnn_tpu_torch.config import config_from_args, make_eval_parser

    cfg = config_from_args(make_eval_parser().parse_args(
        ["-c", "n882", "-nG", str(rounds), "-bs", str(G["batch"]), "--device", str(device)]))
    _, step = evaluate.make_step(cfg, device)
    gen = torch.Generator(device=device).manual_seed(G["seed"])
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    flagged, logical = (int(o) for o in step(gen, G["p"]))
    ms = (time.perf_counter() - t1) * 1e3
    counts = read_counts()
    ler, sig = sigmas(logical, G["batch"], LER_REF)
    print(f"gather_cascade [[882,24]] nG={rounds} p={G['p']} B={G['batch']}: flagged={flagged} "
          f"logical={logical} LER={ler:.5f} ref={LER_REF} ({sig:.2f} sigma), {ms:.3f} ms, "
          f"launches={counts} on {card}")
    if sig >= LER_SIGMAS:
        raise AssertionError(f"gather_cascade: LER {ler} outside {LER_SIGMAS} sigma of {LER_REF}")
    if counts != expected_counts():
        raise AssertionError(f"gather_cascade launched kernels: {counts}")
    return {"step": step, "ms": ms}


def run_osd(bp_rates, device, card, specs=None):
    """cli/osd_eval.py's main() for bp2-osd (to 100 errors) and bp4-osd (a
    fixed number of batches), each OSD sub-batch sized from ``bp_rates``,
    the flagged rates of its BP; checks the LER, the overflow and that no
    kernel ran, and holds the card's osd0_decode to the CPU's on one
    recorded sub-batch.  Returns {mode: (step, argv, ms per batch, ms of
    one osd0_decode)}."""
    from feedback_gnn_tpu_torch.cli import osd_eval
    from feedback_gnn_tpu_torch.codes import ghp_882_24

    specs = specs or {"bp2-osd": OSD_BP2, "bp4-osd": OSD_BP4}
    runs = {}
    for mode, spec in specs.items():
        cap = osd_capacity(bp_rates[mode], spec["batch"])
        argv = ["--mode", mode, "-p", str(spec["p"]), "-bs", str(spec["batch"]), "--osd-cap", str(cap),
                "--device", str(device)]
        if "steps" in spec:  # a fixed number of batches
            argv += ["--target-errors", str(10 ** 9), "--max-mc-iter", str(spec["steps"])]
        else:  # to the target number of logical errors
            argv += ["--target-errors", str(spec["target"]), "--max-mc-iter", str(spec["max_mc_iter"])]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with OsdRecorder() as rec:
            res = osd_eval.main(argv)
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        logical, blocks = int(res.logical_errors[0]), int(res.num_blocks[0])
        steps = blocks // spec["batch"]
        ler, sig = sigmas(logical, blocks, spec["ref"])
        step_ms = float(res.runtime[0]) / steps * 1e3
        print(f"osd {mode} [[882,24]] p={spec['p']} B={spec['batch']} osd-cap {cap} (BP flagged rate "
              f"{bp_rates[mode]:.5f}): logical {logical}/{blocks} LER={ler:.4e} ({sig:.2f} sigma from "
              f"{spec['ref']}), BP-flagged {int(res.flagged_errors[0])}, overflow {int(res.overflow[0])}, "
              f"status {int(res.status[0])}, {steps} batches, {step_ms:.3f} ms per batch, "
              f"{res.throughput[0]:.1f} syndromes/s, peak memory {peak_gb:.2f} GB, launches={counts} "
              f"on {card}")
        osd_ms = osd_card_vs_cpu(f"osd {mode}", rec, card)
        if "steps" in spec and steps != spec["steps"]:
            raise AssertionError(f"{mode}: {steps} batches, expected {spec['steps']}")
        if "steps" not in spec and int(res.status[0]) != 4:
            raise AssertionError(f"{mode}: did not reach {spec['target']} logical errors in "
                                 f"{spec['max_mc_iter']} batches")
        if int(res.overflow[0]) != 0:
            raise AssertionError(f"{mode}: OSD capacity overflow {int(res.overflow[0])}")
        if sig >= LER_SIGMAS:
            raise AssertionError(f"{mode}: LER {ler} outside {LER_SIGMAS} sigma of {spec['ref']}")
        if counts != expected_counts():
            raise AssertionError(f"{mode} launched kernels: {counts}")
        step, _ = osd_eval.make_step(osd_eval.make_parser().parse_args(argv), ghp_882_24(), device)
        runs[mode] = (step, argv, step_ms, osd_ms)
    return runs


@contextlib.contextmanager
def plain_k1():
    """K1's wrapper replaced by its plain version, which runs on the tensors'
    own device: a path run against itself without the kernel."""
    from feedback_gnn_tpu_torch.decoders import bp4_qc

    wrapper = bp4_qc.bp4_qc_marginals

    def plain(qc, llr, sx, sz, num_iter, cn_type="boxplus-phi", factor=1.0, msg_dtype="float32",
              phi_impl=None):
        return bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, num_iter, cn_type, factor, phi_impl)

    bp4_qc.bp4_qc_marginals = plain
    try:
        yield
    finally:
        bp4_qc.bp4_qc_marginals = wrapper


def check_miner(label, make, batch, launches, device, card, T=TRAIN):
    """A K1 miner (compacted) against itself on K1's plain version, on the
    same injected noise: the same kept count and columns, bit for bit, and
    ``launches`` K1 launches.  Prints how far its flagged set agrees with
    the gather miner's (phi's tanh form in K1, expm1 in the gather path)."""
    gen = torch.Generator(device=device).manual_seed(T["seed"])
    miner = make(compact_cap=T["cap"], qc=True)
    nx, nz = miner.sample(gen, T["wt"], batch)
    reset_counts()
    out = miner.body(nx, nz)
    torch.cuda.synchronize()
    counts = read_counts()
    with plain_k1():
        ref = miner.body(nx, nz)
    same = int(out[2]) == int(ref[2]) and all(torch.equal(o, r) for o, r in zip(out[:2], ref[:2]))
    k1_flags = make(qc=True).body(nx, nz)[2]
    gather_flags = make(qc=False).body(nx, nz)[2]
    agree = float((k1_flags == gather_flags).float().mean())
    print(f"train {label} miner [[882,24]] wt={T['wt']} B={batch} x{T['iters']} cap {T['cap']}: kept "
          f"{int(out[2])} (plain version {int(ref[2])}), columns {'equal' if same else 'DIFFERENT'}; "
          f"launches={counts}; flagged {int(k1_flags.sum())} K1 vs {int(gather_flags.sum())} gather, "
          f"agreement {agree:.5f} on {card}", flush=True)
    if not same:
        raise AssertionError(f"the {label} miner on K1 differs from its plain version")
    if counts != expected_counts(K1=launches):
        raise AssertionError(f"{label} miner: kernel launches {counts}, expected K1={launches}")
    return out


def mining_rate(label, miner, device, card, T=TRAIN):
    """Syndromes scanned per second by a compacted miner at the curriculum's
    batch, queued as cli/train_from_scratch.mine_phase queues them.
    Returns the rate and the first batch's output."""
    gen = torch.Generator(device=device).manual_seed(T["seed"])
    first = miner(gen, T["mine_wt"], T["mine_batch"])  # also the warm-up
    int(first[2])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = [miner(gen, T["mine_wt"], T["mine_batch"]) for _ in range(T["mine_reps"])]
    kept = [int(o[2]) for o in outs]
    dt = time.perf_counter() - t1
    rate = T["mine_reps"] * T["mine_batch"] / dt
    print(f"train {label} miner throughput wt={T['mine_wt']}: {rate:.1f} syndromes scanned/s "
          f"({T['mine_reps']} batches of {T['mine_batch']}, {dt / T['mine_reps'] * 1e3:.3f} ms a batch, "
          f"kept {kept}) on {card}")
    return rate, first


def step_grads(graph, cfg, params, nx, nz, feats=None):
    """Loss and gradient leaves of one train step (frozen stage 1, stage 2,
    backward), and the stage-1 features; ``feats`` replaces stage 1."""
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
    from feedback_gnn_tpu_torch.train.trainer import stage_one_features, stage_two_loss

    leaves = flatten_with_paths(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
        leaf.grad = None
    feats = feats if feats is not None else stage_one_features(graph, cfg, nx, nz)
    loss, _ = stage_two_loss(params, graph, cfg, nx, nz, *feats)
    loss.backward()
    return loss.item(), {k: v.grad.detach().cpu() for k, v in leaves.items()}, feats


def compare_steps(label, card_out, cpu_out):
    """(relative loss difference, largest relative L2 error of a gradient leaf)."""
    loss_rel = abs(card_out[0] - cpu_out[0]) / abs(cpu_out[0])
    grad_rel = max(float((card_out[1][k] - g).norm() / g.norm()) for k, g in cpu_out[1].items())
    print(f"  {label}: loss card {card_out[0]:.7f} CPU {cpu_out[0]:.7f} (relative {loss_rel:.3e}), largest "
          f"gradient-leaf relative L2 error {grad_rel:.3e}", flush=True)
    return loss_rel, grad_rel


def run_train(codes, code882, device, card, T=TRAIN):
    """Training on the card: the K1 miners against their plain versions, one
    train step against the CPU, the loss falling at full width, rates, the
    curriculum CLI end to end and resumed, checkpoints.  Returns the timing
    rows of K1 at the miners' shape and a train step for the profile."""
    from feedback_gnn_tpu_torch.cli import train_from_scratch
    from feedback_gnn_tpu_torch.codes import QuantumGraph
    from feedback_gnn_tpu_torch.config import CODE_REGISTRY
    from feedback_gnn_tpu_torch.decoders import (
        bp4_qc, init_feedback_gnn, load_weights, params_from_numpy, save_reference_weights,
    )
    from feedback_gnn_tpu_torch.decoders.bp4 import hard_decision
    from feedback_gnn_tpu_torch.decoders.cascade import prior_llr
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths, load_pytree, save_pytree
    from feedback_gnn_tpu_torch.ops import mod2_matmul
    from feedback_gnn_tpu_torch.train import (
        TrainConfig, make_bp_failure_miner, make_cascade_failure_miner, make_optimizer, make_train_step,
    )

    graph, qc, shipped = codes["n882"]
    coarse = load_weights(CODE_REGISTRY["n882"]["coarse_weights"], device)
    shipped_cpu = load_weights(CODE_REGISTRY["n882"]["weights"], "cpu")

    def easy(compact_cap=None, qc=False):
        return make_bp_failure_miner(graph, num_iter=T["iters"], wt_max=60, compact_cap=compact_cap,
                                     qc=codes["n882"][1] if qc else None)

    def hard(compact_cap=None, qc=False):
        return make_cascade_failure_miner(graph, coarse, num_iter1=T["iters"], num_iter2=T["iters"], wt_max=60,
                                          compact_cap=compact_cap, qc=codes["n882"][1] if qc else None)

    # 1. the K1 miners against their plain versions, and their rates
    check_miner("easy", easy, T["easy_batch"], 1, device, card)
    check_miner("hard", hard, T["hard_batch"], 2, device, card)
    rates = {name: mining_rate(name, make(compact_cap=T["cap"], qc=True), device, card)
             for name, make in (("easy", easy), ("hard", hard))}
    mined = rates["easy"][1]

    # K1 at the miners' shape: the curriculum's batch x 64 iterations, from the prior
    gen = torch.Generator(device=device).manual_seed(T["seed"])
    nx, nz = easy().sample(gen, T["wt"], T["mine_batch"])
    pad = (0, 0, 0, graph.n_pad - graph.n)
    sx = mod2_matmul(graph.hx, torch.nn.functional.pad(nz.to(torch.int32), pad))[: graph.gx.num_cn]
    sz = mod2_matmul(graph.hz, torch.nn.functional.pad(nx.to(torch.int32), pad))[: graph.gz.num_cn]
    llr = prior_llr(0.05, graph.n, T["mine_batch"], device=device)
    k_args = (qc, llr, sx, sz, T["iters"])
    out = bp4_qc.bp4_qc_marginals(*k_args)
    k_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals(*k_args), reps=10)
    check_against_plain(f"n882 B={T['mine_batch']} iters={T['iters']} (miners)", out,
                        bp4_qc.bp4_qc_marginals_plain(*k_args))
    p_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals_plain(*k_args), reps=2)
    b_ms, b_by = k1_bound_ms(qc, T["mine_batch"], T["iters"])
    print(f"K1 n882 B={T['mine_batch']} iters={T['iters']} (miners): kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
          f"ms, bound {b_ms:.5f} ms ({b_by}) on {card}")
    del out

    # 2. one train step on the card against the CPU, same parameters and batch
    batch = T["step_batch"]
    nx, nz = (t[:, :batch].to(torch.float32) for t in mined[:2])
    if int(mined[2]) < batch:
        raise AssertionError(f"the easy miner kept {int(mined[2])} < {batch} failures")
    cpu_graph = QuantumGraph.from_code(code882, stage_mode=True).to("cpu")

    def fresh(dev):  # the shipped weights, a copy of their own per run
        return params_from_numpy(shipped_cpu, dev)

    checks = {}
    for name, sched in (("16/8", T["check"]), ("64/16", T["full"])):
        cfg = TrainConfig(**sched)
        on_card = step_grads(graph, cfg, fresh(device), nx, nz)
        on_cpu = step_grads(cpu_graph, cfg, fresh("cpu"), nx.cpu(), nz.cpu())
        stage1 = [torch.equal(a.cpu(), b) for a, b in zip(on_card[2], on_cpu[2])]
        decisions = [torch.equal(a.cpu(), b) for a, b in zip(hard_decision(*on_card[2][0]),
                                                              hard_decision(*on_cpu[2][0]))]
        print(f"train step {name} [[882,24]] B={batch}, card vs CPU: stage-1 features equal {stage1}, "
              f"their hard decisions equal {decisions}")
        full = compare_steps("whole step", on_card, on_cpu)
        shared = compare_steps("stage 2 on the card's stage-1 features",
                               on_card, step_grads(cpu_graph, cfg, fresh("cpu"), nx.cpu(), nz.cpu(),
                                                   feats=[f.cpu() for f in on_card[2]]))
        checks[name] = (full, shared)
    full, shared = checks["16/8"]
    if not (shared[0] <= T["loss_rtol"] and shared[1] <= T["grad_rel"]):
        raise AssertionError(f"train step 16/8: card vs CPU loss {shared[0]:.3e} (rtol {T['loss_rtol']}), "
                             f"gradients {shared[1]:.3e} (limit {T['grad_rel']})")

    # 3. the loss falls at full width from a fresh init
    cfg = TrainConfig(**T["full"], learning_rate=T["fall_lr"])
    params = init_feedback_gnn(torch.Generator(device=device).manual_seed(T["seed"]))
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step = make_train_step(graph, cfg, opt)
    losses = []
    for _ in range(T["fall_steps"]):
        params, state, loss, fb, bl = step(params, state, nx, nz)
        losses.append(float(loss))
    print(f"train loss over {T['fall_steps']} steps at 64/16 lr {T['fall_lr']} B={batch}: "
          + ", ".join(f"{v:.4f}" for v in losses))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses[0]} -> {losses[-1]}")

    # 4. rates and memory of the published step (64/16, lr 2e-4)
    cfg = TrainConfig(**T["full"])
    params = fresh(device)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step = make_train_step(graph, cfg, opt)
    step(params, state, nx, nz)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    saved = {}

    def pack(t):  # what autograd keeps for the backward pass, each tensor once
        saved[(t.data_ptr(), tuple(t.shape), t.dtype)] = t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step(params, state, nx, nz)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    t1 = time.perf_counter()
    for _ in range(T["rate_steps"]):
        float(step(params, state, nx, nz)[2])
    dt = time.perf_counter() - t1
    step_ms = dt / T["rate_steps"] * 1e3
    counts = read_counts()
    print(f"train step 64/16 B={batch}: {T['rate_steps'] / dt:.3f} steps/s, "
          f"{T['rate_steps'] * batch / dt:.1f} samples/s ({step_ms:.3f} ms a step, one loss read a step); peak memory of a step "
          f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB held between "
          f"steps; autograd saved {len(saved)} tensors, {sum(saved.values()) / 1e9:.3f} GB); "
          f"launches={counts} on {card}")
    if counts != expected_counts():
        raise AssertionError(f"the train step launched kernels: {counts}")

    # 5. checkpoints: npz and reference pickle round trips on the card
    with tempfile.TemporaryDirectory() as d:
        save_pytree(params, os.path.join(d, "p.npz"))
        back = load_pytree(os.path.join(d, "p.npz"), like=params)
        save_reference_weights(params, os.path.join(d, "p.pkl"))
        back2 = load_weights(os.path.join(d, "p.pkl"), device)
        flat = flatten_with_paths(params)
        same = all(torch.equal(flat[k], v) and v.device == flat[k].device
                   for tree in (back, back2) for k, v in flatten_with_paths(tree).items())
    print(f"train checkpoints: save_pytree/load_pytree and save_reference_weights/load_weights on the card "
          f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("a checkpoint round trip changed the parameters")

    # 6. the curriculum CLI, then again from its artifacts
    with tempfile.TemporaryDirectory() as d:
        argv = CURRICULUM + ["--out-dir", d, "--device", str(device)]
        weights = range(int(CURRICULUM[1]), int(CURRICULUM[2]) + 1, 2)
        mine_batches = int(CURRICULUM[CURRICULUM.index("--mine-batches") + 1])
        eval_batch = int(CURRICULUM[CURRICULUM.index("--eval-batch") + 1])
        reset_counts()
        t1 = time.perf_counter()
        res = train_from_scratch.main(argv)
        first_s = time.perf_counter() - t1
        counts = read_counts()
        made = sorted(os.listdir(d))
        eval_batches = sum(sum(r["blocks"]) for r in res.values()) // eval_batch
        # easy: one launch a batch; hard: two; evaluation: 1 + nG=3 a batch
        want = len(weights) * mine_batches * 3 + 4 * eval_batches
        print(f"train_from_scratch [[882,24]] {' '.join(CURRICULUM)}: {first_s:.2f} s, artifacts {made}, "
              f"launches={counts} (K1 counted from the code {want})")
        for name, r in res.items():
            print(f"  {name}: p={r['ps']} LER={r['ler']} errors={r['errors']} blocks={r['blocks']} "
                  f"overflow={r['overflow']}")
        if made != sorted(CURRICULUM_ARTIFACTS):
            raise AssertionError(f"train_from_scratch wrote {made}")
        if any(sum(r["overflow"]) for r in res.values()) or set(res) != {"trained", "shipped"}:
            raise AssertionError(f"train_from_scratch evaluation: {res}")
        if counts != expected_counts(K1=want):
            raise AssertionError(f"train_from_scratch: kernel launches {counts}, expected K1={want}")
        stamps = {a: os.stat(os.path.join(d, a)).st_mtime_ns for a in CURRICULUM_ARTIFACTS[:-1]}
        reset_counts()
        t1 = time.perf_counter()
        again = train_from_scratch.main(argv + ["--skip-shipped-eval"])
        again_s = time.perf_counter() - t1
        counts = read_counts()
        want = 4 * sum(again["trained"]["blocks"]) // eval_batch
        kept = {a: os.stat(os.path.join(d, a)).st_mtime_ns for a in CURRICULUM_ARTIFACTS[:-1]} == stamps
        print(f"train_from_scratch resumed: {again_s:.2f} s, artifacts "
              f"{'untouched' if kept else 'REWRITTEN'}, "
              f"trained LER {again['trained']['ler']} (first call {res['trained']['ler']}), launches={counts} "
              f"(the evaluation's {want})")
        if not kept or counts != expected_counts(K1=want) or again["trained"] != res["trained"]:
            raise AssertionError("train_from_scratch did not resume from its artifacts")

    def train_step():
        return (step(params, state, nx, nz)[2],)

    return {"k1": (k_ms, p_ms, b_ms, b_by), "step": train_step, "ms": step_ms}


def two_sample_sigmas(count, samples, ref, ref_samples):
    """(count/samples - ref/ref_samples) in sigmas of the difference of two
    binomial rates, the pooled rate's."""
    pooled = (count + ref) / (samples + ref_samples)
    sd = (pooled * (1 - pooled) * (1 / samples + 1 / ref_samples)) ** 0.5
    return (count / samples - ref / ref_samples) / sd if sd > 0 else 0.0


def gnn_counts(step, p, batches, G, device):
    """(flagged, logical) summed over ``batches`` seeded batches of step(gen, p)."""
    from feedback_gnn_tpu_torch.cli.train_gnn_bp4 import seed_of

    counts = [torch.stack(step(torch.Generator(device=device).manual_seed(seed_of(G["seed"], b, int(p * 1e4))), p))
              for b in range(batches)]
    return [int(v) for v in torch.stack(counts).sum(dim=0)]


def ulp_moved(params, seed):
    """A copy of the parameter tree with each entry moved by -1, 0 or +1
    ulp (relative 2^-23), the steps drawn from ``seed``."""
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths

    gen = torch.Generator().manual_seed(seed)
    moved = copy.deepcopy(params)
    with torch.no_grad():
        for leaf in flatten_with_paths(moved).values():
            leaf.mul_(1 + (torch.randint(0, 3, leaf.shape, generator=gen) - 1).to(leaf.device) * 2.0 ** -23)
    return moved


@contextlib.contextmanager
def bf16_dense():
    """GNN_BP4's dense layers with their inputs and kernels rounded to
    bfloat16 and the products summed in float32, as a TPU's default float32
    matmul computes them."""
    from feedback_gnn_tpu_torch.decoders import gnn_full

    plain = gnn_full.dense_bl

    def rounded(x, kernel, bias=None, activation=None):
        return plain(x.to(torch.bfloat16).float(), kernel.to(torch.bfloat16).float(), bias, activation)

    gnn_full.dense_bl = rounded
    try:
        yield
    finally:
        gnn_full.dense_bl = plain


def rel_l2(a, ref):
    """Relative L2 error of ``a`` against ``ref``, on the CPU."""
    ref = ref.cpu()
    return float((a.cpu() - ref).norm() / ref.norm())


def stack_rel_l2(stack, ref):
    """Per iteration, the larger relative L2 error of the two tensors of
    ``stack`` against ``ref``."""
    return [max(rel_l2(a, b) for a, b in zip(sa, sb)) for sa, sb in zip(stack, ref)]


def loss_and_grads(params, graph, lrowsets, cfg, nx, nz):
    """gnn_bp4_loss and its gradient leaves (on the CPU) at ``params``."""
    from feedback_gnn_tpu_torch.decoders.gnn_full import gnn_bp4_loss
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths

    leaves = flatten_with_paths(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
        leaf.grad = None
    loss = gnn_bp4_loss(params, graph, lrowsets, cfg, nx, nz)
    loss.backward()
    return loss.item(), {k: v.grad.detach().cpu() for k, v in leaves.items()}


def run_gnn_bp4(codes, device, card, G=GNN_BP4):
    """GNN_BP4 on the card: the shipped trained weights' LERs, card against
    CPU (forward, loss and gradients), the eval and train steps' rates and
    memory, cli/train_gnn_bp4.py end to end, cli/qldpc_codes.py and
    cli/n1270.py --qc-kernel.  Returns the steps and times for the profile
    and K1's rows at cli/n1270.py's shapes."""
    from feedback_gnn_tpu_torch.channels.pauli import depolarizing_probs, pauli_iid
    from feedback_gnn_tpu_torch.cli import n1270, qldpc_codes, train_gnn_bp4
    from feedback_gnn_tpu_torch.codes import QuantumGraph
    from feedback_gnn_tpu_torch.decoders import bp4_qc
    from feedback_gnn_tpu_torch.decoders.gnn_full import (
        GNNBP4Config, gnn_bp4_apply, init_gnn_bp4, load_gnn_bp4_weights, load_shipped, make_logit_rowsets,
    )
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
    from feedback_gnn_tpu_torch.models import gnn_bp4_eval_step
    from feedback_gnn_tpu_torch.ops import mod2_matmul
    from feedback_gnn_tpu_torch.train.trainer import ClipAdam

    def setup(name, dev):
        host = QuantumGraph.from_code(train_gnn_bp4.build_code(name), stage_mode=True)
        params, cfg = load_shipped(name, dev)
        return host.to(dev), make_logit_rowsets(host, dev), params, cfg

    cards = {name: setup(name, device) for name in ("n882", "gb48")}
    out = {}

    # 1.-2. the shipped trained weights against the JAX package's runs
    def ler_rows(tag, table):
        rows, missed = [], []
        for name, p, ref, ref_blocks, batches, checked in table:
            graph, rs, params, cfg = cards[name]

            def step(gen, p_, graph=graph, rs=rs, params=params, cfg=cfg):
                return gnn_bp4_eval_step(graph, rs, params, cfg, gen, p_, G["batch"])

            step(torch.Generator(device=device).manual_seed(0), p)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t1 = time.perf_counter()
            flagged, logical = gnn_counts(step, p, batches, G, device)
            secs = time.perf_counter() - t1
            counts = read_counts()
            blocks = batches * G["batch"]
            z = two_sample_sigmas(logical, blocks, ref, ref_blocks)
            ok = abs(z) < G["sigmas"] or not checked
            print(f"gnn_bp4 {tag}[[{name}]] p={p}: logical {logical}/{blocks} = {logical / blocks:.4e} "
                  f"(flagged {flagged}) against the JAX run's {ref}/{ref_blocks} = {ref / ref_blocks:.4e}: "
                  f"{z:+.2f} sigma{'' if checked else ' (not checked)'}; {secs:.3f} s, "
                  f"{blocks / secs:.1f} syndromes/s at B={G['batch']}; launches={counts} on {card}", flush=True)
            if counts != expected_counts():
                raise AssertionError(f"the GNN_BP4 eval step launched kernels: {counts}")
            rows.append((name, p, logical, blocks, secs, step))
            if not ok:
                missed.append((name, p, z))
        return rows, missed

    rows, missed = ler_rows("", G["ler"])
    for name, p, logical, blocks, _, _ in rows:
        if (name, p) in G["jax_cpu"]:
            ref, ref_blocks = G["jax_cpu"][(name, p)]
            print(f"gnn_bp4 [[{name}]] p={p}: logical {logical}/{blocks} against the JAX package's "
                  f"{ref}/{ref_blocks} on the CPU on the TPU run's keys: "
                  f"{two_sample_sigmas(logical, blocks, ref, ref_blocks):+.2f} sigma (not checked)", flush=True)
    # the JAX runs trained and counted on a TPU, whose default float32
    # matmul rounds its inputs to bfloat16: the same count with the dense
    # layers' inputs so rounded, printed beside the float32 one
    with bf16_dense():
        ler_rows("bf16 dense inputs (diagnostic) ", G["precision_diag"])
    if missed:
        torch.backends.cuda.matmul.allow_tf32 = True
        ler_rows("TF32 on (diagnostic) ", G["ler"])
        torch.backends.cuda.matmul.allow_tf32 = False
        raise AssertionError(f"GNN_BP4 LERs outside {G['sigmas']} sigma of the JAX runs: {missed}")
    name, p, logical, blocks, secs, eval_step = rows[0]
    out["eval_ms"] = secs / (blocks // G["batch"]) * 1e3
    gen = torch.Generator(device=device).manual_seed(1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    int(eval_step(gen, p)[0])
    peak = torch.cuda.max_memory_allocated()
    print(f"gnn_bp4 eval step [[882,24]] B={G['batch']} p={p}: {blocks / secs:.1f} syndromes/s "
          f"({out['eval_ms']:.3f} ms a batch); peak memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above "
          f"the {base / 1e9:.3f} GB held) on {card}", flush=True)
    out["eval"] = lambda: eval_step(gen, p)

    # 3. card against CPU, forward: per-iteration logits and the hard decisions
    graph, rs, params, cfg = cards["n882"]
    cpu_graph, cpu_rs, cpu_params, _ = setup("n882", "cpu")
    n, B = cpu_graph.n, G["check_batch"]
    noise = pauli_iid(torch.Generator().manual_seed(G["seed"]), *depolarizing_probs(G["check_p"]), n, B)
    nx, nz = (torch.nn.functional.pad(t.to(torch.int32), (0, 0, 0, cpu_graph.n_pad - n)) for t in noise)
    sx, sz = mod2_matmul(cpu_graph.hx, nz), mod2_matmul(cpu_graph.hz, nx)
    with torch.no_grad():
        on_card = gnn_bp4_apply(params, graph, rs, sx.to(device), sz.to(device), cfg, collect_logits=True)
        on_cpu = gnn_bp4_apply(cpu_params, cpu_graph, cpu_rs, sx, sz, cfg, collect_logits=True)
        card_moved = gnn_bp4_apply(ulp_moved(params, G["ulp_seed"]), graph, rs, sx.to(device), sz.to(device),
                                   cfg, collect_logits=True)
        cpu_moved = gnn_bp4_apply(ulp_moved(cpu_params, G["ulp_seed"]), cpu_graph, cpu_rs, sx, sz, cfg,
                                  collect_logits=True)
    rel = stack_rel_l2(on_card[2], on_cpu[2])
    floor = [float(np.hypot(c, h)) for c, h in zip(stack_rel_l2(card_moved[2], on_card[2]),
                                                    stack_rel_l2(cpu_moved[2], on_cpu[2]))]
    limits = [max(G["stack_rel"], G["ulp_factor"] * f) for f in floor]
    differ = int(((on_card[0].cpu() != on_cpu[0]) | (on_card[1].cpu() != on_cpu[1]))[:n].sum())
    share = 1.0 - differ / (n * B)
    print(f"gnn_bp4 forward [[882,24]] B={B} p={G['check_p']}, card vs CPU: per-iteration logits relative "
          f"L2 " + ", ".join(f"{v:.3e}" for v in rel) + "; float32 floor (one-ulp weight moves, card and CPU) "
          + ", ".join(f"{v:.3e}" for v in floor) + f"; hard decisions differ at {differ} of {n * B} entries "
          f"(agree {share:.6f})", flush=True)
    if any(r > lim for r, lim in zip(rel, limits)) or share < G["decisions"]:
        raise AssertionError(f"GNN_BP4 forward, card vs CPU: logits {rel} (limits {limits}), decisions agree "
                             f"{share} (limit {G['decisions']})")

    # 4. card against CPU, one loss and its gradients
    B = G["train_batch"]
    tx, tz = pauli_iid(torch.Generator().manual_seed(G["seed"] + 1), *depolarizing_probs(G["train_p"]), n, B)
    tx, tz = tx.to(torch.float32), tz.to(torch.float32)
    def both(dev, g_, rs_):
        """The loss and gradients at the shipped weights and at their one-ulp move."""
        shipped = load_shipped("n882", dev)[0]
        x_, z_ = tx.to(dev), tz.to(dev)
        return (loss_and_grads(shipped, g_, rs_, cfg, x_, z_),
                loss_and_grads(ulp_moved(shipped, G["ulp_seed"]), g_, rs_, cfg, x_, z_))

    (on_card, card_moved), (on_cpu, cpu_moved) = both(device, graph, rs), both("cpu", cpu_graph, cpu_rs)
    loss_rel, grad_rel = compare_steps(f"gnn_bp4 loss [[882,24]] B={B} p={G['train_p']}, card vs CPU", on_card,
                                       on_cpu)
    errors = {k: rel_l2(on_card[1][k], g) for k, g in on_cpu[1].items()}
    floors = {k: float(np.hypot(rel_l2(card_moved[1][k], on_card[1][k]), rel_l2(cpu_moved[1][k], g)))
              for k, g in on_cpu[1].items()}
    over = {k: (e, floors[k]) for k, e in errors.items() if e > max(G["grad_rel"], G["ulp_factor"] * floors[k])}
    worst = max(errors, key=lambda k: errors[k] / floors[k])
    print(f"  float32 floor of the gradient leaves (one-ulp weight moves, card and CPU): {min(floors.values()):.3e} "
          f"to {max(floors.values()):.3e}; closest to it {worst}: error {errors[worst]:.3e}, floor "
          f"{floors[worst]:.3e}; the loss's floor {abs(cpu_moved[0] - on_cpu[0]) / abs(on_cpu[0]):.3e} (CPU)",
          flush=True)
    if loss_rel > G["loss_rtol"] or over:
        raise AssertionError(f"GNN_BP4 loss, card vs CPU: {loss_rel:.3e} (rtol {G['loss_rtol']}), gradient leaves "
                             f"over their limits (error, floor): {over}")
    del on_card, on_cpu, card_moved, cpu_moved

    # 5. the train step's rate and memory, from a fresh init
    tparams = init_gnn_bp4(torch.Generator(device=device).manual_seed(G["seed"]), cfg)
    opt = ClipAdam(1e-3, 10.0)
    state = opt.init(tparams)
    tgen = torch.Generator(device=device).manual_seed(G["seed"])

    def train_once():
        nx_, nz_ = pauli_iid(tgen, *depolarizing_probs(G["train_p"]), n, B)
        return (train_gnn_bp4.train_step(opt, state, tparams, graph, rs, cfg, nx_, nz_),)

    float(train_once()[0])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    float(train_once()[0])
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    t1 = time.perf_counter()
    losses = [train_once()[0] for _ in range(G["rate_steps"])]
    float(losses[-1])
    dt = time.perf_counter() - t1
    out["train"], out["train_ms"] = train_once, dt / G["rate_steps"] * 1e3
    print(f"gnn_bp4 train step [[882,24]] B={B}: {G['rate_steps'] / dt:.3f} steps/s, "
          f"{G['rate_steps'] * B / dt:.1f} samples/s ({out['train_ms']:.3f} ms a step); peak memory of a step "
          f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB held); "
          f"launches={read_counts()} on {card}", flush=True)

    # 6. cli/train_gnn_bp4.py end to end
    with tempfile.TemporaryDirectory() as d:
        rpath, wpath = os.path.join(d, "r.json"), os.path.join(d, "w.npz")
        reset_counts()
        t1 = time.perf_counter()
        results, losses, trained = train_gnn_bp4.main(G["cli"] + ["--device", str(device), "--out", rpath,
                                                                  "--weights-out", wpath])
        secs = time.perf_counter() - t1
        counts = read_counts()
        with open(rpath) as f:
            written = json.load(f)
        back = flatten_with_paths(load_gnn_bp4_weights(wpath, GNNBP4Config(**written["cfg"]), device))
    flat = flatten_with_paths(trained)
    same = sorted(back) == sorted(flat) and all(torch.equal(v, flat[k].detach()) for k, v in back.items())
    cli_p = float(G["cli"][G["cli"].index("--eval-p") + 1])
    init_ler, trained_ler = results["init"][cli_p]["ler"], results["trained"][cli_p]["ler"]
    print(f"gnn_bp4 cli/train_gnn_bp4.py {' '.join(G['cli'])}: {secs:.2f} s; loss step 0 {losses[0]:.4f}, "
          f"step {len(losses) - 1} {losses[-1]:.4f}; LER at p={cli_p} init {init_ler:.4e}, trained "
          f"{trained_ler:.4e}; weights loaded back {'equal' if same else 'DIFFERENT'}; JSON keys "
          f"{list(written)}; launches={counts}", flush=True)
    point = next(iter(written["trained"].values()))
    if not (np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0] and trained_ler < init_ler and same
            and list(written) == ["code", "cfg", "steps", "train_p", "init", "trained"]
            and list(written["cfg"]) == list(GNNBP4Config._fields)
            and list(point) == ["flagged", "logical", "blocks", "ler"] and counts == expected_counts()):
        raise AssertionError("cli/train_gnn_bp4.py end to end failed its checks")

    # 7. the example CLIs: the code zoo's table, [[1270,28]] with K1
    zoo = qldpc_codes.main([])
    got = {k: (c.N, c.K) for k, c in zoo.items()}
    if got != G["zoo"]:
        raise AssertionError(f"cli/qldpc_codes.py: {got}")
    reset_counts()
    t1 = time.perf_counter()
    res = n1270.main(G["n1270"] + ["--device", str(device)])
    secs = time.perf_counter() - t1
    counts = read_counts()
    bs = G["n1270_batch"]
    batches = int(res.num_blocks[0]) // bs
    overflow = int(np.sum(res.overflow))
    print(f"cli/n1270.py {' '.join(G['n1270'])}: {batches} batches of {bs} in {secs:.2f} s, logical "
          f"{int(res.logical_errors[0])}, LER {float(res.ler[0]):.4e}, overflow {overflow}, launches={counts} "
          f"(K1 counted from the code: {batches * 6})", flush=True)
    if overflow != 0 or counts != expected_counts(K1=batches * 6) or batches < 1:
        raise AssertionError(f"cli/n1270.py: overflow {overflow}, launches {counts}")

    # K1 at cli/n1270.py's shapes: stage 1 (64 iterations) and a round (16)
    qc = codes["n1270"][1]
    out["k1"] = {}
    for iters in (64, 16):
        llr, ksx, ksz = random_inputs(qc, bs, device, seed=3)
        label = f"n1270 B={bs} iters={iters} (cli/n1270.py)"
        check_against_plain(label, bp4_qc.bp4_qc_marginals(qc, llr, ksx, ksz, iters),
                            bp4_qc.bp4_qc_marginals_plain(qc, llr, ksx, ksz, iters))
        k_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals(qc, llr, ksx, ksz, iters), reps=10)
        p_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals_plain(qc, llr, ksx, ksz, iters), reps=2)
        b_ms, b_by = k1_bound_ms(qc, bs, iters)
        out["k1"][iters] = (k_ms, p_ms, b_ms, b_by)
        print(f"K1 {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) on {card}")
    return out


def run_ranks(world, tasks, device, P=PARALLEL):
    """Every rank's results of ``tasks`` (parallel/workers.py) on ``world``
    ranks of this machine's cards (the CPU for a rehearsal), the backend
    chosen by the rule."""
    from feedback_gnn_tpu_torch.parallel.launch import launch
    from feedback_gnn_tpu_torch.parallel.workers import run_tasks

    rank_device = "cpu" if device.type == "cpu" else None
    return launch(run_tasks, world, args=(tasks, rank_device), device=rank_device, timeout_s=P["timeout_s"],
                  join_timeout_s=P["join_s"], threads=1 if rank_device else None)


def run_parallel(codes, code882, device, card, P=PARALLEL, E=EVALUATE, T=TRAIN, G=GATHER):
    """Phase parallel: (a)-(e) and the scaling CLI (see PARALLEL)."""
    from dataclasses import replace

    from feedback_gnn_tpu_torch.channels import pauli_fixed_weight, pauli_iid
    from feedback_gnn_tpu_torch.channels.pauli import depolarizing_probs
    from feedback_gnn_tpu_torch.cli import bench_scaling
    from feedback_gnn_tpu_torch.codes import QuantumGraph
    from feedback_gnn_tpu_torch.config import CODE_REGISTRY
    from feedback_gnn_tpu_torch.decoders.bp4 import hard_decision
    from feedback_gnn_tpu_torch.decoders.cascade import (CascadeConfig, data_seed, prior_llr,
                                                         sandwich_decode, sandwich_eval_step)
    from feedback_gnn_tpu_torch.decoders.gnn_feedback import load_weights
    from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
    from feedback_gnn_tpu_torch.ops import mod2_matmul
    from feedback_gnn_tpu_torch.train.trainer import (ClipAdam, TrainConfig, make_train_step,
                                                      stage_one_features, stage_two_loss)

    graph, qc, params = codes["n882"]
    host = QuantumGraph.from_code(code882, stage_mode=True)
    weights = CODE_REGISTRY["n882"]["weights"]
    if device.type == "cuda":  # the ranks share this card: hand back what earlier phases cached
        gc.collect()
        torch.cuda.empty_cache()
        print(f"parallel: this process holds {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
              f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved on {card}", flush=True)
    cfg = CascadeConfig(num_rounds=E["rounds"], compact_fraction=E["compact"], stage1_prepass=E["prepass"],
                        round_fraction=E["rounds_cap"])
    steps, batch, p = len(P["seeds"]), P["batch"], P["p"]
    # prepass, subset, rounds: K1 launches per rank (none on a CPU rehearsal)
    launches = steps * (2 + E["rounds"]) if device.type == "cuda" else 0
    # the backend each world must take here: one rank has the card to
    # itself (NCCL); two share the one card (Gloo), or take a card each
    backends = ({1: "nccl", 2: "gloo" if torch.cuda.device_count() == 1 else "nccl"}
                if device.type == "cuda" else {1: "gloo", 2: "gloo"})
    out = {}

    def unsharded(data, local):
        """Counts per seed summed over ``data`` ranks run here, and the
        seconds of the steps (one warm-up first)."""
        sandwich_eval_step(graph, [params], cfg, torch.Generator(device=device).manual_seed(7), p, local,
                           qc=qc, return_overflow=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = []
        for s in P["seeds"]:
            tot = np.zeros(3, np.int64)
            for d in range(data):
                gen = torch.Generator(device=device).manual_seed(data_seed(s, d))
                tot += [int(c) for c in sandwich_eval_step(graph, [params], cfg, gen, p, local, qc=qc,
                                                           return_overflow=True)]
            counts.append(tuple(int(c) for c in tot))
        torch.cuda.synchronize()
        return counts, time.perf_counter() - t1

    def check_eval(label, res, ref, backend, world):
        seconds = max(r["seconds"] for r in res)
        rate = batch * steps / seconds
        peaks = [(r["peak_bytes"] or 0) / 1e9 for r in res]
        print(f"parallel {label}: backend {[r['backend'] for r in res]}, counts {res[0]['counts']} "
              f"(unsharded sum {ref}), K1 launches per rank {[r['k1_launches'] for r in res]}, "
              f"{rate:.1f} syndromes/s ({seconds / steps * 1e3:.3f} ms per batch of {batch}), peak "
              f"{', '.join(f'{g:.3f}' for g in peaks)} GB per rank on {card}", flush=True)
        if any(r["backend"] != backend for r in res):
            raise AssertionError(f"parallel {label}: backend {[r['backend'] for r in res]}, expected {backend}")
        if any(r["counts"] != ref for r in res):
            raise AssertionError(f"parallel {label}: counts differ from the unsharded sum")
        if any(c[2] != 0 for c in ref):
            raise AssertionError(f"parallel {label}: compaction overflow")
        if any(r["k1_launches"] != launches for r in res):
            raise AssertionError(f"parallel {label}: K1 launches {[r['k1_launches'] for r in res]}, "
                                 f"expected {launches} per rank")
        return rate, seconds / steps

    def eval_task(data):
        return ("eval_counts", dict(mesh_shape=(data, 1), graph=host, params=weights, cfg=cfg,
                                    local_batch=batch // data, seeds=P["seeds"], p=p, qc=qc,
                                    return_overflow=True, warmup=1))

    # (a) data-parallel evaluation, 2 ranks on the one card
    ref2, _ = unsharded(2, batch // 2)
    out["a"] = check_eval(f"(a) DP eval 2 ranks [[882,24]] p={p} B={batch}", [r[0] for r in run_ranks(2, [eval_task(2)], device)],
                          ref2, backends[2], 2)
    # (b) the NCCL route: one rank, and one rank per card where there are two
    ref1, t_plain = unsharded(1, batch)
    out["b"] = check_eval(f"(b) world 1 [[882,24]] p={p} B={batch}", [r[0] for r in run_ranks(1, [eval_task(1)], device)], ref1,
                          backends[1], 1)
    out["plain"] = (batch * steps / t_plain, t_plain / steps)
    print(f"parallel unsharded step [[882,24]] p={p} B={batch}: {out['plain'][0]:.1f} syndromes/s "
          f"({out['plain'][1] * 1e3:.3f} ms per batch); world-1 NCCL overhead "
          f"{(out['b'][1] - out['plain'][1]) * 1e3:.3f} ms per batch; 2 ranks sharing the card "
          f"{out['a'][0] / out['plain'][0]:.3f} of the unsharded rate on {card}", flush=True)
    if torch.cuda.device_count() >= 2:
        check_eval(f"(b) one rank per card [[882,24]] p={p} B={batch}", [r[0] for r in run_ranks(2, [eval_task(2)], device)], ref2,
                   "nccl", 2)

    # (c) the evaluate CLI, spawning its 2 ranks
    argv = ["-c", "n882", "-p", str(p), "-nG", str(E["rounds"]), "-bs", str(batch), "--qc-kernel",
            "--compact", str(E["compact"]), "--prepass", str(E["prepass"]), "--rounds-cap",
            str(E["rounds_cap"]), "--max-mc-iter", str(P["cli_batches"]), "--target-errors", "1000000",
            "--data-shards", "2"]
    t1 = time.perf_counter()
    if device.type == "cpu":
        argv += ["--device", "cpu"]
    run = subprocess.run([sys.executable, "-m", "feedback_gnn_tpu_torch.cli.evaluate", *argv],
                         capture_output=True, text=True, timeout=P["join_s"],
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    print(run.stdout[-3000:], run.stderr[-3000:], sep="\n", flush=True)
    # the summary row: p | flagged | LER | log errs | blocks | runtime | blk/s | status
    summary = [line.split("|") for line in run.stdout.splitlines() if line.count("|") == 7
               and line.split("|")[0].strip() == f"{p:.4g}"]
    backend = backends[2]
    print(f"parallel (c) cli/evaluate.py --data-shards 2: exit {run.returncode} in "
          f"{time.perf_counter() - t1:.2f} s, backend {backend} expected on {card}", flush=True)
    if run.returncode != 0 or len(summary) != 1 or f"backend {backend}, world 2" not in run.stdout:
        raise AssertionError("parallel (c): the sharded evaluate CLI did not finish as expected")
    if int(summary[0][4]) != P["cli_batches"] * batch or "WARNING" in run.stdout:
        raise AssertionError(f"parallel (c): blocks {summary[0][4]} or a compaction overflow")

    # (d) the data-parallel train step, 2 ranks
    tcfg = TrainConfig(**T["full"])
    b = P["train_batch"]
    gen = torch.Generator(device=device).manual_seed(P["train_seed"])
    px, pz = (t.to(torch.float32) for t in pauli_fixed_weight(gen, P["train_wt"], graph.n, P["train_pool"]))
    h_vn = stage_one_features(graph, tcfg, px, pz)[0]
    pad = (0, 0, 0, graph.n_pad - graph.n)
    xh, zh = (torch.nn.functional.pad(t[: graph.n], pad) for t in hard_decision(*h_vn))
    pxp, pzp = (torch.nn.functional.pad(t.to(torch.int32), pad) for t in (px, pz))
    failed = torch.cat([mod2_matmul(graph.hz, xh ^ pxp), mod2_matmul(graph.hx, zh ^ pzp)]).ne(0).any(dim=0)
    keep = failed.nonzero().flatten()[:b]
    print(f"parallel (d): {int(failed.sum())} of {P['train_pool']} samples at weight {P['train_wt']} fail "
          f"stage 1; the first {len(keep)} are the batch", flush=True)
    if len(keep) < b:
        raise AssertionError("parallel (d): too few stage-1 failures for the batch")
    nx, nz = px[:, keep], pz[:, keep]

    def fresh():
        tree = load_weights(weights, device)
        for leaf in flatten_with_paths(tree).values():
            leaf.requires_grad_(True)
        return tree

    ref_params = fresh()
    feats = stage_one_features(graph, tcfg, nx, nz)
    loss, (s_hat, ls_hat) = stage_two_loss(ref_params, graph, tcfg, nx, nz, *feats)
    loss.backward()
    shared_ref = (loss.item(), {k: v.grad.cpu().numpy() for k, v in flatten_with_paths(ref_params).items()},
                  float((s_hat != 0).any(dim=0).float().mean()))
    whole_params, opt = fresh(), ClipAdam(0.0, 1e30)
    state = opt.init(whole_params)
    _, _, w_loss, w_fb, _ = make_train_step(graph, tcfg, opt)(whole_params, state, nx, nz)
    whole_ref = (float(w_loss), {k: v.grad.cpu().numpy() for k, v in flatten_with_paths(whole_params).items()},
                 float(w_fb))
    step = dict(graph=host, params=weights, cfg=tcfg, noise_x=nx.cpu().numpy(), noise_z=nz.cpu().numpy())
    t1 = time.perf_counter()
    shared, whole = (r for r in zip(*run_ranks(2, [
        ("dp_stage_two_grads", dict(step, data=2, features=[f.cpu().numpy() for f in feats])),
        ("train_step", dict(step, mesh_shape=(2, 1)))], device)))
    train_s = time.perf_counter() - t1
    for label, res, (r_loss, r_grads, r_fb) in (("stage 2 on shared stage-1 features", shared, shared_ref),
                                                ("whole step", whole, whole_ref)):
        for r in res:
            (l2, fb2, _), = r["rates"]
            loss_rel = abs(l2 - r_loss) / abs(r_loss)
            grad_rel = max(np.linalg.norm(r["grads"][k] - g) / np.linalg.norm(g) for k, g in r_grads.items())
            a = np.concatenate([r["grads"][k].ravel() for k in r_grads])
            c = np.concatenate([g.ravel() for g in r_grads.values()])
            cosine = float(a @ c / (np.linalg.norm(a) * np.linalg.norm(c)))
            print(f"parallel (d) DP train 64/16 [[882,24]] B={b} {label}: backend {r['backend']}, loss "
                  f"{l2:.7f} vs {r_loss:.7f} (relative {loss_rel:.3e}), flagged_bler {fb2} vs {r_fb}, "
                  f"largest leaf relative L2 {grad_rel:.3e}, cosine {cosine:.6f}", flush=True)
            if r["backend"] != backends[2]:
                raise AssertionError(f"parallel (d): backend {r['backend']}")
            if label == "whole step":
                ok = loss_rel <= 1e-5 and np.isclose(fb2, r_fb, rtol=1e-6) and cosine > P["cosine"]
            else:
                ok = loss_rel <= T["loss_rtol"] and grad_rel <= T["grad_rel"]
            if not ok:
                raise AssertionError(f"parallel (d) {label}: outside its tolerance")
    print(f"parallel (d): both sharded train steps with spawn and set-up in {train_s:.2f} s on {card}")

    # (e) the gather cascade edge-sharded over 2 ranks, on injected noise:
    # the published schedule, and the short one where decisions are stable
    gen = torch.Generator(device=device).manual_seed(P["edge_seed"])
    ex, ez = pauli_iid(gen, *depolarizing_probs(G["p"]), graph.n, G["batch"])
    short_iters = P["edge_short"]
    schedules = {"64/16": CascadeConfig(num_rounds=E["rounds"]),
                 f"{short_iters[0]}/{short_iters[1]}": CascadeConfig(
                     num_rounds=E["rounds"], num_iter1=short_iters[0], num_iter2=short_iters[1])}
    ranks = run_ranks(2, [("decode", dict(edge=2, graph=host, params=weights, cfg=ecfg, noise_x=ex.cpu().numpy(),
                                          noise_z=ez.cpu().numpy())) for ecfg in schedules.values()], device)
    nx_, nz_ = (torch.nn.functional.pad(t.to(torch.int32), pad) for t in (ex, ez))
    sx, sz = mod2_matmul(graph.hx, nz_), mod2_matmul(graph.hz, nx_)
    for i, (sched, ecfg) in enumerate(schedules.items()):
        res = [r[i] for r in ranks]
        llr0 = prior_llr(ecfg.p0, graph.n, G["batch"], graph.n_pad, device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x_ref, z_ref = sandwich_decode(graph, [params], ecfg, llr0, sx, sz, sz, sx)
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t1) * 1e3
        # the unsharded decode's own floor: the prior moved by one ulp (pad rows stay 0)
        moved = llr0.clone()
        moved[:, : graph.n] = torch.nextafter(moved[:, : graph.n], torch.tensor(float("inf"), device=device))
        x_mv, z_mv = sandwich_decode(graph, [params], ecfg, moved, sx, sz, sz, sx)
        floor = float((~((x_mv == x_ref) & (z_mv == z_ref)).all(dim=0)).float().mean())
        short = i == 1
        for r in res:
            xh, zh = (torch.nn.functional.pad(torch.as_tensor(r[k], device=device).to(torch.int32), pad)
                      for k in ("x_hat", "z_hat"))
            agree = ((xh == x_ref) & (zh == z_ref)).all(dim=0)
            share = float(agree.float().mean())
            xd, zd = nx_ ^ xh, nz_ ^ zh
            logical = int((torch.cat([mod2_matmul(graph.hx_perp, xd), mod2_matmul(graph.hz_perp, zd)]) != 0)
                          .any(dim=0).sum())
            ler, sig = sigmas(logical, G["batch"], LER_REF)
            print(f"parallel (e) edge 2 gather cascade {sched} [[882,24]] nG={E['rounds']} p={G['p']} "
                  f"B={G['batch']}: backend {r['backend']}, decisions agree on {share:.6f} of samples "
                  f"({int((~agree).sum())} differ; the unsharded decode with the prior moved one ulp changes "
                  f"{floor:.6f}), LER {ler:.5f}" + ("" if short else f" ({sig:.2f} sigma from {LER_REF})")
                  + f", {r['seconds'] * 1e3:.3f} ms (unsharded {ref_ms:.3f} ms) on {card}", flush=True)
            if r["backend"] != backends[2]:
                raise AssertionError(f"parallel (e): backend {r['backend']}")
            # the short schedule: per-sample decisions at P["agree"]; the
            # published one turns ulps into other decisions, so it is held
            # to its own floor and the LER
            if short and share < P["agree"]:
                raise AssertionError(f"parallel (e) {sched}: agreement {share} below {P['agree']}")
            if not short and (1 - share > P["floor_factor"] * floor
                              or (device.type == "cuda" and sig >= LER_SIGMAS)):
                raise AssertionError(f"parallel (e) {sched}: agreement {share} (floor {floor}) or LER {ler} "
                                     f"outside {LER_SIGMAS} sigma of {LER_REF}")
        if not all(np.array_equal(r["x_hat"], res[0]["x_hat"]) and np.array_equal(r["z_hat"], res[0]["z_hat"])
                   for r in res):
            raise AssertionError(f"parallel (e) {sched}: the edge ranks' replicated decisions differ")

    # weak scaling through cli/bench_scaling.py, 1 and 2 ranks on the card
    rows = bench_scaling.scaling_rows(bench_scaling._parser().parse_args(
        P["scaling"] + (["--device", "cpu"] if device.type == "cpu" else [])))
    for row in rows:
        print(f"parallel bench_scaling: {json.dumps(row)} on {card}", flush=True)
        if row["backend"] != backends[row["data_shards"]] or (
                device.type == "cuda" and min(row["k1_launches_per_rank"]) == 0):
            raise AssertionError(f"parallel bench_scaling: {row}")
    out["scaling"] = rows
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    from feedback_gnn_tpu_torch import _build, resolve_device
    from feedback_gnn_tpu_torch.cli.bench import timed_windows  # throughput: bench.py's timing
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

    # 5. bench.py's workload through cli/bench.py: [[1270,28]], nG=5,
    # prepass 12, compaction 0.15/0.05
    t0 = time.perf_counter()
    from feedback_gnn_tpu_torch.cli import bench

    settings = bench.bench_settings({})  # the workload as published, no overrides
    graph, qc, params = codes["n1270"]
    cfg, step = settings.cfg, bench.make_step(graph, qc, params, settings)
    gen = torch.Generator(device=device).manual_seed(0)
    step(gen, settings.p)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    rates, step_ms, counts = timed_windows(step, (gen, settings.p), settings.batch)
    launches_b = read_counts()
    flagged_b = sum(int(c[0]) for c in counts)
    logical_b = sum(int(c[1]) for c in counts)
    overflow = sum(int(c[2]) for c in counts)
    bench_ms = report_rate(f"bench [[1270,28]] nG=5 p={settings.p} B={settings.batch}", rates, step_ms, card)
    print(f"bench: {len(counts)} steps, flagged={flagged_b} logical={logical_b} overflow={overflow} "
          f"launches={launches_b}; metric {bench.METRIC}, vs_baseline "
          f"{statistics.median(rates) / bench.BASELINE_SYNDROMES_PER_S:.2f}")
    if overflow != 0:
        raise AssertionError(f"compaction overflow {overflow}")
    if launches_b != expected_counts(K1=len(counts) * (2 + cfg.num_rounds)):
        raise AssertionError(f"kernel launches {launches_b} in {len(counts)} bench steps")
    phase("bench", t0)

    # 6.-8. the evaluate CLI to 100 logical errors, the rescue stage, the
    # evaluate step on the gather backend
    t0 = time.perf_counter()
    ev = run_evaluate(codes, device, card)
    phase("evaluate", t0)
    t0 = time.perf_counter()
    rs = run_rescue(codes, device, card)
    phase("rescue", t0)
    t0 = time.perf_counter()
    ga = run_gather_cascade(device, card)
    phase("gather_cascade", t0)

    # 9. K1 against its plain version, and both times, at every shape the
    # main path, the bench, the evaluate CLI, the rescue and phase
    # parallel's ranks give it
    t0 = time.perf_counter()
    from feedback_gnn_tpu_torch.cli import bench_scaling
    from feedback_gnn_tpu_torch.decoders.cascade import _capacity

    E = EVALUATE
    rescue_cap = rs["capacity"]
    cap1 = _capacity(cfg.compact_fraction, settings.batch, cfg.qc_batch_tile)
    cap2 = _capacity(cfg.round_fraction, settings.batch, cfg.qc_batch_tile)
    ecap1 = _capacity(E["compact"], E["batch"], 128)
    ecap2 = _capacity(E["rounds_cap"], E["batch"], 128)
    local = PARALLEL["batch"] // 2  # (a) and (c): the evaluate cascade on each of 2 data ranks
    scale = bench_scaling._parser().parse_args(PARALLEL["scaling"])  # no compaction, no prepass
    shapes = [  # (code, batch, iterations, phi form, time the plan grid)
        ("n882", 256, 64, None, True), ("n882", 256, 16, None, True),
        ("n1270", settings.batch, 12, None, True), ("n1270", cap1, 64, None, True),
        ("n1270", cap2, 16, None, True),
        ("n882", E["batch"], E["prepass"], None, False), ("n882", ecap1, 64, None, False),
        ("n882", ecap2, 16, None, False),
        ("n882", local, E["prepass"], None, False), ("n882", _capacity(E["compact"], local, 128), 64, None, False),
        ("n882", _capacity(E["rounds_cap"], local, 128), 16, None, False),
        (scale.code, scale.local_batch, scale.iters1, None, False),
        (scale.code, scale.local_batch, scale.iters2, None, False),
        ("n882", rescue_cap, 64, "tf", False), ("n882", rescue_cap, 16, "tf", False),
        ("n882", rescue_cap, 64, "accurate", False), ("n882", rescue_cap, 16, "accurate", False),
    ]
    timing = {}
    for nm, batch, iters, phi, with_grid in shapes:
        qc_s = codes[nm][1]
        llr, sx, sz = random_inputs(qc_s, batch, device, seed=2)
        plan = bp4_qc._launch_plan(qc_s, batch)
        blocks, regs, spill = bp4_qc._occupancy(qc_s, "boxplus-phi", phi, plan)
        key = ("bp4_qc_kernel", bp4_qc._kernel_codes("boxplus-phi", phi, plan.instance))
        label = f"{nm} B={batch} iters={iters}" + (f" phi={phi}" if phi else "")
        print(f"K1 {label}: instance (DC, DV)={plan.instance} boxplus-phi, "
              f"{plan.regime} batch: {plan.threads} threads x {plan.samples_per_block} samples per "
              f"block ({plan.blocks(batch)} blocks), {plan.nodes_per_thread} nodes per thread, "
              f"{plan.smem_bytes} B shared; resident blocks per SM {blocks} (planned "
              f"{plan.blocks_per_sm}); registers {regs} (ptxas {registers.get(key)}), local {spill} B")
        out = bp4_qc.bp4_qc_marginals(qc_s, llr, sx, sz, iters, phi_impl=phi)
        k_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals(qc_s, llr, sx, sz, iters, phi_impl=phi), reps=10)
        ref = bp4_qc.bp4_qc_marginals_plain(qc_s, llr, sx, sz, iters, phi_impl=phi)
        max_err = max(max_err, check_against_plain(label, out, ref))
        del out

        def launch(p):
            return bp4_qc._launch_kernel(qc_s, llr, sx, sz, iters, "boxplus-phi", 1.0, phi, p)

        if with_grid:
            g_ms = time_plans(
                f"K1 {label}",
                plan_grid(lambda t, spb: bp4_qc._launch_plan(qc_s, batch, t, spb),
                          max(qc_s.n, (qc_s.qx.mb + qc_s.qz.mb) * qc_s.l), bp4_qc.K1_MAX_THREADS),
                plan, launch, ref, card)[plan]
        else:
            g_ms = graph_ms(lambda: launch(plan), reps=GRID_REPS)
        del ref
        p_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals_plain(qc_s, llr, sx, sz, iters, phi_impl=phi), reps=2)
        b_ms, b_by = k1_bound_ms(qc_s, batch, iters, phi_impl=phi)
        timing[(nm, batch, iters, phi)] = (k_ms, p_ms, b_ms, b_by)
        old = PREVIOUS_K1_MS.get((nm, batch, iters)) if phi is None else None
        print(f"K1 {label}: kernel {k_ms:.4f} ms ("
              + (f"previous design {old:.4f} ms, ratio {k_ms / old:.3f}; " if old else "")
              + f"in a CUDA graph {g_ms:.4f} ms), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) on {card}")
    phase("k1_timing", t0)

    # 10. the binary BSC path: bp2_bsc_eval_step on [[882,24]]'s hx, on K2
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

    # 11. the plain gather BP4 path on [[882,24]] (runs no kernel)
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

    # 12. BP + OSD-0 through cli/osd_eval.py, OSD sub-batches sized from
    # the flagged rates bp2_path and bp4_plain_path measured for their BP
    t0 = time.perf_counter()
    osd_runs = run_osd({"bp2-osd": flagged2 / (BP2["steps"] * BP2["batch"]),
                        "bp4-osd": flagged4 / (BP4_PLAIN["steps"] * BP4_PLAIN["batch"])}, device, card)
    phase("osd", t0)

    # 13. K2 against its plain version, and both times, at the bp2_path shape
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

    # 14. the probes of scripts/probe_pallas*.py
    t0 = time.perf_counter()
    probe_rows = run_probes(device, card)
    phase("probes", t0)

    # 15. training: the K1 miners, the train step, the curriculum CLI
    t0 = time.perf_counter()
    tr = run_train(codes, code882, device, card)
    phase("train", t0)

    # 16. GNN_BP4 and the example CLIs
    t0 = time.perf_counter()
    gn = run_gnn_bp4(codes, device, card)
    phase("gnn_bp4", t0)

    # 17. multi-device: data-parallel and edge-sharded ranks
    t0 = time.perf_counter()
    run_parallel(codes, code882, device, card)
    phase("parallel", t0)

    # 18. where a step's device time goes
    t0 = time.perf_counter()
    profile_step("main path [[882,24]] B=256 p=0.08", fn, (gen, 0.08), main_ms, card)
    profile_step(f"bench [[1270,28]] B={settings.batch} p={settings.p}", step, (gen, settings.p),
                 bench_ms, card)
    estep = ev["step"]
    profile_step(f"evaluate [[882,24]] B={E['batch']} p={E['p']}", estep, (gen, E["p"]), ev["ms"], card)
    profile_sim_ler(f"evaluate [[882,24]] B={E['batch']} p={E['p']}", estep, E["p"], E["batch"], 8,
                    device, card)
    profile_step(f"rescue tf,accurate [[882,24]] B={RESCUE['batch']} p={RESCUE['p']}", rs["step"],
                 (gen, RESCUE["p"]), rs["ms"], card)
    profile_step(f"gather_cascade [[882,24]] B={GATHER['batch']} p={GATHER['p']}", ga["step"],
                 (gen, GATHER["p"]), ga["ms"], card)
    profile_step(f"bp2_path [[882,24]] hx B={BP2['batch']} p={BP2['p']}", bp2_step, (gen, BP2["p"]),
                 bp2_ms, card)
    profile_step(f"bp4_plain_path [[882,24]] B={BP4_PLAIN['batch']} p={BP4_PLAIN['p']}", bp4_step,
                 (gen, BP4_PLAIN["p"]), bp4_ms, card)
    for mode, (ostep, argv, step_ms_o, osd_ms) in osd_runs.items():
        calls = 2 if mode == "bp4-osd" else 1
        print(f"osd {mode}: osd0_decode {calls} x {osd_ms:.3f} ms of a {step_ms_o:.3f} ms batch "
              f"(OSD share {calls * osd_ms / step_ms_o:.3f}) on {card}")
        profile_step(f"osd {mode} [[882,24]]", ostep, (gen, float(argv[argv.index("-p") + 1])), step_ms_o, card)
    profile_step(f"train step 64/16 [[882,24]] B={TRAIN['step_batch']}", tr["step"], (), tr["ms"], card)
    profile_step(f"gnn_bp4 eval step [[882,24]] B={GNN_BP4['batch']} p=0.03", gn["eval"], (), gn["eval_ms"], card)
    profile_step(f"gnn_bp4 train step [[882,24]] B={GNN_BP4['train_batch']}", gn["train"], (), gn["train_ms"],
                 card)
    phase("profile", t0)

    k_ms, p_ms, b_ms, b_by = timing[("n882", 256, 64, None)]
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
