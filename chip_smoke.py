#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (feedback_gnn_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from feedback_gnn_tpu_torch/csrc with one
nvcc (K1, the fused QC BP4 decode; K2, the fused QC BP2 decode; the three
probe kernels of csrc/probes.cu; the fused feedback-GNN step of
csrc/gnn_feedback.cu; OSD-0's elimination of csrc/osd0.cu; the GF(2)
product of csrc/gf2mat.cu; GNN_BP4's CN and VN updates of csrc/gnn_bp4.cu),
holds each against its plain PyTorch version on the card (the GNN step also
timed beside it, with its host cost a call and its issue bounds; GNN_BP4's
updates and one whole decode at the gnn_p03 cell's shape beside their
operations bounds), and drives the paths that run them or their
neighbours (every cascade counting one fused GNN step a round): the [[882,24]] sandwich cascade of feedback_gnn_tpu_torch.entry
and the [[1270,28]] compacted workload of cli/bench.py (K1); the evaluate
CLI (cli/evaluate.py's run(), [[882,24]] at p=0.08 to 100 logical errors,
K1); the rescue stage (K1's tf and accurate instances); the cascade on the
gather backend (no kernel); the binary BSC evaluation step on
[[882,24]]'s hx (K2); the plain gather BP4 step on [[882,24]] (no kernel);
BP2 + OSD-0 (the OSD-0 kernel) and BP4 + OSD-0 (K1's min-sum instance,
also held to its plain version at that decode's shape, and the OSD-0
kernel, held to its plain version at the BP+OSD cell's shapes) through
cli/osd_eval.py;
feedback_gnn_tpu_torch.probes.main(), the thirteen probes of
scripts/probe_pallas*.py; training (K1 in both failure miners, each held
bit for bit to its plain version; one train step held to the CPU's; the
loss falling at full width; cli/train_from_scratch.py end to end and
resumed from its artifacts; checkpoint round trips); the fully-learned
GNN_BP4 decoder at full width (the shipped trained weights' LERs against
the JAX package's runs, card against CPU forward and one train step, the
train step's rate, cli/train_gnn_bp4.py end to end) and the example CLIs
(cli/qldpc_codes.py; cli/n1270.py --qc-kernel, K1); K1's bfloat16 message
carry (each instance at the bench's, the main path's and the rescue's
shapes bit for bit against its plain version and timed beside float32's;
the bench workload and the main path with the carry), and the host GF(2)
core that builds the codes (against the NumPy path).  Each decoding path
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
import ctypes
import faulthandler
import gc
import hashlib
import json
import os
import platform
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# one yardstick: the K1 and K2 bounds and the card's peaks are the benchmark's
from benchmark.counts import H100_BYTES, H100_F32_OPS, k1_bound_ms, k2_bound_ms

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
# the host GF(2) core's phase: a seeded random matrix beside the codes'
NATIVE = dict(seed=0, random=(2000, 4000), matmul_batch=4096)
# BP + OSD-0 (cli/osd_eval.py) against RESULTS.md: BP2 at p=0.05 and BP4
# (on K1's min-sum instance) at p=0.10, each to 100 errors; OSD sub-batches
# sized from the flagged rates that bp2_path and bp4_plain_path measure for
# the same BP.  The card's OSD-0 is held to the CPU's on the first
# OSD_CHECK_SAMPLES samples of one sub-batch of each.
OSD_BP2 = dict(p=0.05, batch=20480, ref=6.51e-4, target=100, max_mc_iter=40)
OSD_BP4 = dict(p=0.10, batch=20480, ref=4.02e-4, target=100, max_mc_iter=40)
OSD_CHECK_SAMPLES = 64
# OSD-0's kernel against its plain version at the BP+OSD cell's shapes
OSD_KERNEL = dict(p=0.10, batch=20480, cap=1024, seed=31)
# the GF(2) product's kernel against its plain version and torch.matmul at the
# cells' full-batch shapes: both codes' syndrome and accounting matrices
GF2 = dict(codes=("n1270", "n882"), matrices=("hx", "hz", "hx_perp", "hz_perp"), batch=20480, p=0.05, seed=17,
           reps=20)
# GNN_BP4's CN and VN update kernels against their plain versions at the
# gnn_p03 cell's shape ([[882,24]], B=20480, the shipped weights, embeddings
# drawn on every row): within `tol` on every row, timed by events over
# `reps` calls (the plain version over `plain_reps`) beside the update's
# bound; then one decode of the cell's traffic (p) on the kernels, timed
# over `decode_reps`, with its peak memory and launches.
GNN_BP4_KERNEL = dict(code="n882", batch=20480, tol=1e-5, reps=5, plain_reps=2, p=0.03, seed=25, decode_reps=3)
# K1 and K2 against their plain versions: bit for bit (the plain versions
# repeat the kernels' order of operations and the same accurate libm calls)
CMP_BATCH, CMP_ITERS = 256, 64
# K1's min-sum instance at the shape of cli/osd_eval.py's bp4-osd decode
# (the benchmark's n882_bp4_osd.osd_p10), against its plain version and timed
OSD_K1 = dict(code="n882", batch=20480, iters=100, cn_type="minsum", factor=0.8, seed=1)
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
# float32 K1's output hashes (output_hash of the three marginals stacked) at
# k1_timing's shapes on random_inputs(seed=2), taken with the kernel as it
# was before the bfloat16 carry (tools/k1_fingerprint.py on the parent
# checkout; torch 2.11.0+cu128): the float32 instances must give the same bits
K1_F32_HASHES = {
    ("n882", 256, 64, None): "75b49c1ac1479f53", ("n882", 256, 16, None): "8e4ed12c343703fb",
    ("n1270", 20480, 12, None): "ca497b12f1f61c96", ("n1270", 3072, 64, None): "adb8c23e592a8088",
    ("n1270", 1024, 16, None): "de16f6d3c803c65c", ("n882", 512, 64, "tf"): "4d55991aec28c26d",
    ("n882", 512, 16, "accurate"): "2cf1613fb6ea3de2",
}
PREVIOUS_COUNTS = {"main path": (300, 4096), "bp2_path": (3143, 61440), "bp4_plain_path": (2139, 61440)}
GRID_REPS = 10  # calls per plan of the launch-plan grid, in one CUDA graph
# shared memory of all SMs: 128 B per clock per SM x 132 SMs x 1.98 GHz
# (the boost clock), for the loop probes' on-chip bound
H100_SMEM_BYTES = 128 * 132 * 1.98e9

# The probes: back-to-back calls per timing, and float32 operations per
# element of each phi form (transcendentals counted as one each, as for K1)
PROBE_REPS, PROBE_PLAIN_REPS = 200, 20
PHI_OPS = {"phi_softplus_expm1": 10, "phi_log_tanh": 6, "phi_exp_log1p": 10}
# An accurate transcendental is tens of instructions, not one operation, so
# the phi rows' bound also charges the SASS instructions an element of the
# instance that runs (read from the built library in the build phase) at
# the card's issue rate: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz (the
# boost clock) lane-instructions a second
H100_ISSUE = 132 * 4 * 32 * 1.98e9
# phi's throughput shape, neither launch-bound nor held in the 50 MB L2
# (126 MB read, 126 MB written), timed in graphs of PHI_WIDE_REPS calls;
# the plan grid: units a thread x threads a block
PHI_WIDE, PHI_WIDE_REPS = (3840, 128 * 64), 20
PHI_GRID = [(pt, threads) for pt in (1, 2, 4) for threads in (32, 64, 128, 256, 512)]
# ragged and misaligned phi inputs (rows, cols, offset in floats into a
# flat buffer): n = 1, 3, 5 (fewer than a float4, one float4 and a tail),
# n % 4 = 1 and 3, a short, wide array
PHI_RAGGED = [(1, 1, 0), (1, 3, 0), (1, 5, 0), (517, 17, 0), (2, 300001, 0), (3840, 128, 1),
              (1000, 37, 3), (1, 4, 2)]
# shared-memory bytes per element and iteration of the loops (csrc/probes.cu's
# resident_loop): the element read and written.  The index does not change
# across iterations and need be read only once (the loops hold it in
# registers); the bound that also charged a gather's index read every
# iteration, 12 B, is printed beside for comparison with older records.
LOOP_SMEM_BYTES = {"gather_loop": 8, "take_along_loop": 8, "roll_loop": 8}
LOOP_SMEM_BYTES_WITH_INDEX = {"gather_loop": 12, "take_along_loop": 12}
# The probe kernels' times before their redesign, microseconds, by this
# script on an NVIDIA H100 80GB HBM3 at 700 W (graphs of 200): the gather
# and shift kernels before theirs (single passes a thread an element, loops
# a block loading its column alone), phi (k5, kc, kd) before its own (a
# thread an element, the form a runtime argument); a probe slower than
# before shows here
PROBE_BEFORE_US = {"k1": 3.11, "k2": 1.91, "k2b": 1.95, "k3": 3.08, "k4": 1.53, "k5": 3.23, "k6": 43.78,
                   "ka": 3.31, "kb": 3.22, "kc": 2.57, "kd": 2.95, "ke": 45.40, "kf": 38.64}

# The fused feedback-GNN step (csrc/gnn_feedback.cu) against its plain
# version: the benchmark's round shapes ([[1270,28]] at B=1024, [[882,24]]
# at 1664) and the cascade miner's ([[882,24]] at 8192), the shipped
# weights, the cascade's input layout; every row, pad rows included,
# within |fused - plain| / max(|plain|, 1) <= tol.  Times: the kernel in a
# CUDA graph of `reps` calls, the plain version by events over
# `plain_reps`; host microseconds a call over `host_calls` (fused) and
# `plain_host_calls` (plain, ~60 launches each) calls queued without a
# sync.  Two issue bounds, both lane-instructions a (VN, sample) pair over
# H100_ISSUE: the function's (its FMAs and its tanhf, each tanhf counted
# as GNN_TANHF_INSTRUCTIONS: two MUFU and the FMA, compare and select
# around them, an assumed count) and the built kernel's SASS (each loop
# counted once a trip).
GNN = dict(shapes=[("n1270", 1024), ("n882", 1664), ("n882", 8192)], tol=1e-5, reps=20, plain_reps=5,
           host_calls=100, plain_host_calls=10, row=("n1270", 1024))
GNN_TANHF_INSTRUCTIONS = 16

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


def reset_counts():
    from feedback_gnn_tpu_torch import obs

    obs.reset()


def read_counts():
    """Launches since the last reset_counts: K1, K2, the fused GNN step
    (GNN) and the GNN steps the card ran on the plain version (GNN_plain:
    an edge shard or a gradient), the OSD-0 kernel (OSD) and OSD-0's plain
    loop on the card (OSD_plain), GNN_BP4's CN and VN update kernels
    (GNN_BP4_CN, GNN_BP4_VN) and the updates the card ran on the plain
    version (GNN_BP4_plain: a gradient, an edge shard, no instance), and
    each probe wrapper."""
    from feedback_gnn_tpu_torch import obs, probes

    keys = obs.snapshot()["keys"]
    gnn, osd = keys.get("gnn.launches", {}), keys.get("osd.launches", {})
    bp4 = keys.get("gnn_bp4.launches", {})
    return {"K1": obs.counter("k1.launches"), "K2": obs.counter("k2.launches"),
            "GNN": sum(n for (path, _), n in gnn.items() if path == "fused"),
            "GNN_plain": sum(n for (path, _), n in gnn.items() if path == "plain"),
            "OSD": sum(n for (path, _), n in osd.items() if path == "kernel"),
            "OSD_plain": sum(n for (path, _), n in osd.items() if path == "plain"),
            **{f"GNN_BP4_{update.upper()}": sum(n for (path, u, _), n in bp4.items()
                                               if path == "kernel" and u == update) for update in ("cn", "vn")},
            "GNN_BP4_plain": sum(n for (path, _, _), n in bp4.items() if path == "plain"),
            **{name: obs.counter(f"probe.{name}.launches") for name in probes.WRAPPERS}}


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


def sass_functions(library):
    """[(function name, code)] of the built library (cuobjdump -sass), code
    a list of (address, opcode, backward-branch target or None), NOPs left
    out; None without cuobjdump in the toolkit."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: no cuobjdump in this toolkit")
        return None
    dump = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300).stdout
    functions = []
    for section in re.split(r"\n\s*Function : ", dump)[1:]:
        code = []
        for addr, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", section):
            op = [t for t in ins.split() if not t.startswith("@")][0]
            target = re.search(r"BRA\S*\s+(?:\S+\s+)?0x([0-9a-f]+)", ins)
            back = int(target.group(1), 16) if target and int(target.group(1), 16) < int(addr, 16) else None
            if op != "NOP":
                code.append((int(addr, 16), op, back))
        functions.append((section.split("\n", 1)[0].strip(), code))
    return functions


def sass_counts(functions):
    """SASS instructions (NOPs left out) of each K1/K2 instance in the built
    library (``sass_functions``), cut at its barrier instructions: the load,
    the VN pass, the CN pass and the final marginals each fall between two
    BARs.  For each segment: its instructions and MUFU (special-function)
    instructions, and the same for every loop in it (a backward branch and
    its target).  The smallest loop of a pass is one node visit with its
    loop control: nvcc unrolls a node loop into a body of several visits
    plus a remainder loop of one."""
    for name, code in functions or ():
        k = re.search(r"(bp[24]_qc_kernel)I((?:Li-?\d+E)+)E", name)
        if not k:
            continue
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


# SASS opcodes by the unit that runs them: float32 (two 16-lane datapaths a
# scheduler), integer (one of them), MUFU (special functions), memory
SASS_KINDS = (("MUFU", "mufu"), ("F", "fp32"), ("HF", "fp32"), ("I", "int"), ("LOP", "int"), ("SHF", "int"),
              ("LEA", "int"), ("SEL", "int"), ("PRMT", "int"), ("LD", "memory"), ("ST", "memory"))
# probe_phi_kernel<FORM, FAST, VEC, PT>'s mangled template arguments
PHI_KERNEL = re.compile(r"probe_phi_kernelILi(\d+)ELb([01])ELb([01])ELi(\d+)EE")


def phi_sass_counts(functions, registers):
    """SASS instructions an element of every phi instance: its grid-stride
    loop (the widest backward branch and the code it spans) over the floats
    one trip handles (PT float4s, or PT floats).  Prints one line an
    instance with the instructions' mix by unit (SASS_KINDS), its registers
    and spills; returns {(form, fast, vec, pt): instructions an element},
    empty without cuobjdump."""
    regs = {}
    for (kernel, _), rs in registers.items():
        m = PHI_KERNEL.search(kernel)
        if m:
            regs[tuple(int(v) for v in m.groups())] = rs
    counts = {}
    for name, code in functions or ():
        m = PHI_KERNEL.search(name)
        if not m:
            continue
        key = tuple(int(v) for v in m.groups())
        form, fast, vec, pt = key
        loops = [(addr - back, back, addr) for addr, _, back in code if back is not None]
        if not loops:
            print(f"  sass phi {key}: no loop found")
            continue
        _, lo, hi = max(loops)
        body = [op for a, op, _ in code if lo <= a <= hi]
        floats = pt * (4 if vec else 1)
        counts[key] = len(body) / floats
        mix = {}
        for op in body:
            kind = next((k for pre, k in SASS_KINDS if op.startswith(pre)), "other")
            mix[kind] = mix.get(kind, 0) + 1
        r, spill = regs.get(key, (None, None))
        print(f"  sass phi form={form} fast={fast} vec={vec} pt={pt}: {len(body)} instructions a loop trip "
              f"of {floats} floats, {counts[key]:.2f} an element ("
              + ", ".join(f"{k} {v / floats:.2f}" for k, v in sorted(mix.items()))
              + f"); registers {r}, spill stores {spill} B")
    return counts


# tensor-core (matrix) SASS opcodes: Ampere-style warp MMAs and Hopper's
# warpgroup MMAs, of every input type
TENSOR_CORE_OPS = ("HMMA", "IMMA", "DMMA", "BMMA", "HGMMA", "IGMMA", "QGMMA", "BGMMA")
# nvcc flags that trade float32 rounding for speed
FAST_MATH_FLAGS = ("--use_fast_math", "-use_fast_math", "--ftz=true", "--prec-div=false", "--prec-sqrt=false")


def gnn_bp4_sass(functions):
    """Each GNN_BP4 update kernel's SASS (csrc/gnn_bp4.cu, every instance):
    its instructions, FFMAs and tensor-core instructions (TENSOR_CORE_OPS),
    printed; raises AssertionError where an instance issues a tensor-core
    instruction or the build passes a fast-math flag (the kernels are
    float32 FFMA only).  Returns {instance name: (instructions, FFMA,
    tensor-core)}, empty without cuobjdump."""
    from feedback_gnn_tpu_torch import _build

    fast = [f for f in _build.NVCC_FLAGS if f in FAST_MATH_FLAGS]
    counts = {}
    for name, code in functions or ():
        if not re.search(r"gnn_bp4_(cn|vn)_kernel", name):
            continue
        ops = [op for _, op, _ in code]
        mma = sum(op.split(".")[0] in TENSOR_CORE_OPS for op in ops)
        ffma = sum(op.split(".")[0] == "FFMA" for op in ops)
        counts[name] = (len(ops), ffma, mma)
        print(f"  sass {name}: {len(ops)} instructions, FFMA {ffma}, tensor-core {mma}")
    print(f"GNN_BP4 sass: {len(counts)} instances, tensor-core instructions "
          f"{sum(c[2] for c in counts.values())}, fast-math flags {fast}", flush=True)
    if fast or any(c[2] for c in counts.values()):
        raise AssertionError(f"GNN_BP4 kernels: tensor-core instructions {counts}, fast-math flags {fast}")
    return counts


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


def same_k1_hash(label, key, out):
    """Print whether float32 K1's output at a k1_timing shape hashes as the
    kernel's before the bfloat16 carry (K1_F32_HASHES) did."""
    h = output_hash(torch.stack(out))
    before = K1_F32_HASHES.get(key)
    print(f"  K1 {label} output hash {h}"
          + (f": before the carry {before}, {'the same' if h == before else 'DIFFERENT'}" if before else ""))


def time_carry(codes, shapes, registers, device, card):
    """K1 with the bfloat16 message carry at each (code, batch, iterations,
    phi form, instance or None for the launch plan's): bit for bit against
    its plain version, timed beside the float32 carry on the same inputs
    and plan (CUDA events over 10 calls, and a CUDA graph of GRID_REPS),
    the plain version, the bound, the instance's occupancy, and the share
    of marginals the carry moves.  Returns {shape: row}."""
    from feedback_gnn_tpu_torch.decoders import bp4_qc

    rows = {}
    for nm, batch, iters, phi, instance in shapes:
        qc_s = codes[nm][1]
        llr, sx, sz = random_inputs(qc_s, batch, device, seed=2)
        plan = bp4_qc._launch_plan(qc_s, batch, instance=instance)
        label = f"{nm} B={batch} iters={iters}" + (f" phi={phi}" if phi else "") + f" instance {plan.instance}"

        def launch(msg_dtype, plan=plan, qc_s=qc_s, llr=llr, sx=sx, sz=sz, iters=iters, phi=phi):
            return bp4_qc._launch_kernel(qc_s, llr, sx, sz, iters, "boxplus-phi", 1.0, phi, plan, msg_dtype)

        out = launch("bfloat16")
        ref = bp4_qc.bp4_qc_marginals_plain(qc_s, llr, sx, sz, iters, phi_impl=phi, msg_dtype="bfloat16")
        err = check_against_plain(f"bfloat16 carry {label}", out, ref)
        f32 = launch("float32")
        moved = float(torch.cat([(a != b).flatten() for a, b in zip(out, f32)]).float().mean())
        del out, ref, f32
        k_ms, f_ms = time_ms(lambda: launch("bfloat16"), reps=10), time_ms(lambda: launch("float32"), reps=10)
        g_ms, gf_ms = graph_ms(lambda: launch("bfloat16"), GRID_REPS), graph_ms(lambda: launch("float32"), GRID_REPS)
        p_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals_plain(qc_s, llr, sx, sz, iters, phi_impl=phi,
                                                             msg_dtype="bfloat16"), reps=2)
        b_ms, b_by = k1_bound_ms(qc_s.qx, qc_s.qz, batch, iters, phi_impl=phi, msg_dtype="bfloat16")
        blocks, regs, spill = bp4_qc._occupancy(qc_s, "boxplus-phi", phi, plan, "bfloat16")
        key = ("bp4_qc_kernel", bp4_qc._kernel_codes("boxplus-phi", phi, plan.instance, "bfloat16"))
        print(f"K1 bfloat16 carry {label}: kernel {k_ms:.4f} ms (graph {g_ms:.4f}), float32 carry "
              f"{f_ms:.4f} ms (graph {gf_ms:.4f}), ratio {k_ms / f_ms:.4f} (graphs {g_ms / gf_ms:.4f}); "
              f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); resident blocks per SM {blocks} (planned "
              f"{plan.blocks_per_sm}), registers {regs} (ptxas {registers.get(key)}), local {spill} B; "
              f"{moved:.4f} of the marginals differ from the float32 carry's on {card}", flush=True)
        rows[(nm, batch, iters, phi, instance)] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                                       bound_by=b_by, graph_ms=g_ms, f32_ms=f_ms)
    return rows


def gnn_inputs(graph, batch, device, seed):
    """The cascade's GNN inputs: marginals [3, n_pad, B], check logits on
    every padded row, int32 syndromes [m, B]."""
    g = torch.Generator(device=device).manual_seed(seed)
    gx, gz = graph.gx, graph.gz
    return (torch.randn((3, gx.n_pad, batch), generator=g, device=device) * 3.0,
            torch.randn((gx.c_pad, batch), generator=g, device=device) * 2.0,
            torch.randn((gz.c_pad, batch), generator=g, device=device) * 2.0,
            torch.randint(0, 2, (gx.num_cn, batch), generator=g, device=device, dtype=torch.int32),
            torch.randint(0, 2, (gz.num_cn, batch), generator=g, device=device, dtype=torch.int32))


def gnn_function_counts(hidden, msg, dv):
    """(FMAs, tanhf) of one (VN, sample) pair of the step at VN degree dv on
    both sides: per side the hidden pre-activation (3 a unit), each edge's
    shift and masked sum (2 a unit and edge) and tanhf, layer 1 (hidden x
    msg) and the mean; the embed MLP (2 msg + 3 inputs a unit) and its
    tanhf; the output layer (3 a unit)."""
    side = 3 * hidden + 2 * hidden * dv + hidden * msg + msg
    return 2 * side + hidden * (2 * msg + 3) + 3 * hidden, 2 * hidden * dv + hidden


def gnn_sass_counts(functions):
    """{(hidden, msg, slots): {opcode: SASS instructions a (VN, sample)
    pair}} of the fused step's instances in the built library
    (``sass_functions``): each loop (a backward branch and its target)
    counted once a trip, hidden / 2 trips for the loops over hidden units
    (``#pragma unroll 2``: the loops that hold MUFU), ceil(packed float4s /
    128) for the weights' copy into shared memory.  Opcodes without their
    modifiers (FFMA, MUFU, LDS, ...)."""
    from feedback_gnn_tpu_torch._build import load_kernels

    out = {}
    for name, code in functions or ():
        m = re.search(r"gnn_feedback_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        hidden, msg, slots = (int(v) for v in m.groups())
        floats = load_kernels().fgt_gnn_feedback_packed_floats(hidden, msg, slots)
        ops = {}
        for _, op, _ in code:
            ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        for addr, _, back in code:
            if back is None:
                continue
            body = [op.split(".")[0] for a, op, _ in code if back <= a <= addr]
            trips = hidden // 2 if "MUFU" in body else -(-floats // 4 // 128)
            for op in body:
                ops[op] += trips - 1
        out[(hidden, msg, slots)] = ops
    return out


def host_us(fn, calls):
    """Host microseconds a call of fn(), ``calls`` calls queued without a
    sync (the card's work left out, as long as the launch queue holds it)."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t1
    torch.cuda.synchronize()
    return dt / calls * 1e6


def run_gnn(codes, device, card, registers, functions, G=GNN):
    """The fused feedback-GNN step against its plain version at G's
    shapes: the widest gap within G["tol"] on every row, two calls bit for
    bit, one ``fused`` launch counted a call; the kernel's and the plain
    version's times, host microseconds a call, occupancy, registers and
    spills, the SASS a pair by opcode and both issue bounds.  Returns the
    kernels line's row at G["row"]'s shape."""
    import ctypes

    from feedback_gnn_tpu_torch._build import load_kernels
    from feedback_gnn_tpu_torch.decoders import gnn_feedback as gf

    for (name, args), (regs, spill) in sorted(registers.items()):
        if "gnn_" in name:
            print(f"GNN ptxas {name}: {regs} registers, spill stores {spill} B")
    sass = gnn_sass_counts(functions)
    worst, rows = 0.0, {}
    for code, batch in G["shapes"]:
        graph, _, params = codes[code]
        args = gnn_inputs(graph, batch, device, seed=batch)
        label = f"GNN {code} B={batch}"
        with torch.no_grad():
            reset_counts()
            out = gf.feedback_gnn_apply(params, graph, *args)
            again = gf.feedback_gnn_apply(params, graph, *args)
            counts = read_counts()
            ref = gf.feedback_gnn_apply_plain(params, graph, *args)
            gap = float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())
            same = torch.equal(out, again)
            del out, again, ref
            k_ms = graph_ms(lambda: gf.feedback_gnn_apply(params, graph, *args), G["reps"])
            p_ms = time_ms(lambda: gf.feedback_gnn_apply_plain(params, graph, *args), G["plain_reps"])
            k_host = host_us(lambda: gf.feedback_gnn_apply(params, graph, *args), G["host_calls"])
            p_host = host_us(lambda: gf.feedback_gnn_apply_plain(params, graph, *args), G["plain_host_calls"])
        instance, _ = gf._fused_instance(params, graph, *args)
        occ = (ctypes.c_int * 3)()
        err = load_kernels().fgt_gnn_feedback_occupancy(*instance, occ)
        pairs = graph.gx.num_vn * batch
        fmas, tanhs = gnn_function_counts(instance[0], instance[1], max(graph.gx.max_vn_deg, graph.gz.max_vn_deg))
        f_ms = (fmas + tanhs * GNN_TANHF_INSTRUCTIONS) * pairs / H100_ISSUE * 1e3
        ops = sass.get(instance, {})
        per_pair = sum(ops.values())
        s_ms = per_pair * pairs / H100_ISSUE * 1e3 if per_pair else None
        top = ", ".join(f"{op} {n}" for op, n in sorted(ops.items(), key=lambda kv: -kv[1])[:12])
        print(f"{label}: instance {instance}, occupancy (blocks an SM, registers, local B) "
              f"{list(occ) if err == 0 else f'error {err}'}; gap {gap:.3e} (limit {G['tol']}), two calls "
              f"{'equal' if same else 'DIFFERENT'}, launches={counts}", flush=True)
        print(f"{label}: kernel {k_ms:.4f} ms (in a CUDA graph), plain {p_ms:.4f} ms ({p_ms / k_ms:.2f}x); "
              f"host {k_host:.2f} us a call (plain {p_host:.2f}); function {fmas} FMA + {tanhs} tanhf a pair, "
              f"bound {f_ms:.4f} ms ({f_ms / k_ms:.1%} of the kernel's time); SASS {per_pair} a pair, bound "
              + (f"{s_ms:.4f} ms ({s_ms / k_ms:.1%})" if s_ms else "not counted") + f"; by opcode: {top} on {card}",
              flush=True)
        if gap > G["tol"] or not same:
            raise AssertionError(f"{label}: the fused step is {gap:.3e} from the plain version "
                                 f"(limit {G['tol']}), two calls {'equal' if same else 'differ'}")
        if counts != expected_counts(GNN=2):
            raise AssertionError(f"{label}: launches {counts}, expected GNN=2")
        worst = max(worst, gap)
        rows[(code, batch)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=s_ms, function_bound_ms=f_ms,
                                   host_us=k_host, plain_host_us=p_host, sass_a_pair=per_pair)
    return {"max_rel_gap": worst, **rows[G["row"]]}


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


def compare_osd_k1(codes, device, card, K=OSD_K1):
    """K1's min-sum instance at the BP4 + OSD-0 decode's shape against its
    plain version, bit for bit, with the kernel's time, the plain
    version's and the bound.  Returns them and the largest error."""
    from feedback_gnn_tpu_torch.decoders import bp4_qc

    qc = codes[K["code"]][1]
    llr, sx, sz = random_inputs(qc, K["batch"], device, seed=K["seed"])
    args = (qc, llr, sx, sz, K["iters"], K["cn_type"], K["factor"])
    plan = bp4_qc._launch_plan(qc, K["batch"])
    label = f"{K['code']} B={K['batch']} iters={K['iters']} {K['cn_type']} f={K['factor']} (BP4 + OSD-0)"
    err = check_against_plain(label, bp4_qc.bp4_qc_marginals(*args), bp4_qc.bp4_qc_marginals_plain(*args))
    k_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals(*args), reps=5)
    p_ms = time_ms(lambda: bp4_qc.bp4_qc_marginals_plain(*args), reps=1)
    b_ms, b_by = k1_bound_ms(qc.qx, qc.qz, K["batch"], K["iters"], cn_type=K["cn_type"])
    print(f"K1 {label}: instance (DC, DV)={plan.instance}, {plan.regime} batch, {plan.threads} threads x "
          f"{plan.samples_per_block} samples per block; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}, {b_ms / k_ms:.1%} of the kernel's time) on {card}", flush=True)
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


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


def cpu_model():
    """The host CPU's model, for host-clock numbers: /proc/cpuinfo's model
    name, else lscpu's, else the machine's architecture."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("model name", "hardware")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    for line in out.splitlines():
        if line.startswith(("Model name:", "Vendor ID:")):
            return line.split(":", 1)[1].strip()
    return f"{platform.machine()} CPU, model not reported"


def run_native(card, N=NATIVE):
    """The host GF(2) core (feedback_gnn_tpu_torch/native): its g++ build
    into an empty directory, then row_echelon_native against the NumPy path
    (reduced and not) on the paper codes' hx.T and hz.T and a seeded random
    matrix, and gf2_matmul_native against NumPy; each held bit for bit,
    both paths timed on the host's clock."""
    from feedback_gnn_tpu_torch import native
    from feedback_gnn_tpu_torch.codes import ghp_1270_28, ghp_882_24, gf2

    host = cpu_model()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        native.build(d)
        build_s = time.perf_counter() - t0
    print(f"native: g++ {' '.join(native.CXX_FLAGS)} built the core in {build_s:.3f} s on the host "
          f"({host}; {os.cpu_count()} cores; {platform.machine()}), beside {card}")
    rng = np.random.default_rng(N["seed"])
    mats = {}
    for name, make in (("n882", ghp_882_24), ("n1270", ghp_1270_28)):
        code = make()
        mats[f"{name} hx.T"] = np.asarray(code.hx).T
        mats[f"{name} hz.T"] = np.asarray(code.hz).T
    mats["random {}x{} (seed {})".format(*N["random"], N["seed"])] = rng.integers(0, 2, N["random"])
    rows = []
    for label, mat in mats.items():
        for reduced in (False, True):
            t0 = time.perf_counter()
            core = native.row_echelon_native(mat, reduced)
            core_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = gf2.row_echelon(mat, reduced, use_native=False)
            numpy_s = time.perf_counter() - t0
            same = (core[1] == ref[1] and list(core[3]) == list(ref[3]) and np.array_equal(core[0], ref[0])
                    and np.array_equal(core[2], ref[2]))
            print(f"native row_echelon {label} {list(mat.shape)} reduced={reduced}: rank {core[1]}, core "
                  f"{core_s:.4f} s, NumPy {numpy_s:.4f} s ({numpy_s / core_s:.1f}x), "
                  f"{'equal' if same else 'DIFFERENT'} (host clock, {host})", flush=True)
            if not same:
                raise AssertionError(f"row_echelon_native disagrees with the NumPy path: {label}")
            rows.append((label, reduced, core_s, numpy_s))
    h = mats["n882 hx.T"].T
    v = rng.integers(0, 2, (h.shape[1], N["matmul_batch"]))
    t0 = time.perf_counter()
    out = native.gf2_matmul_native(h, v)
    core_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = (h.astype(np.float32) @ v.astype(np.float32) % 2).astype(int)  # exact: sums < 2**24
    numpy_s = time.perf_counter() - t0
    print(f"native gf2_matmul n882 hx {list(h.shape)} @ [{h.shape[1]}, {N['matmul_batch']}]: core "
          f"{core_s:.4f} s, NumPy (float32 matmul) {numpy_s:.4f} s, {'equal' if np.array_equal(out, ref) else 'DIFFERENT'} "
          f"(host clock, {host})")
    if not np.array_equal(out, ref):
        raise AssertionError("gf2_matmul_native disagrees with NumPy")
    return rows


def run_carry(codes, fp32_rates, device, card, env=None):
    """The bfloat16 message carry end to end: bench.py's workload through
    cli/bench.py with BENCH_MSG_DTYPE=bfloat16 (syndromes/s beside
    ``fp32_rates``, the float32 run's windows; overflow 0), and the main
    path's cascade (entry()'s configuration) with the carry at p=0.12, its
    LER beside the TF original's (printed only: the JAX package calls the
    carry an accuracy trade and publishes no rate for it).  Launch counts
    reset just before each and read just after.  Returns the main path's K1
    launches."""
    from feedback_gnn_tpu_torch.cli import bench
    from feedback_gnn_tpu_torch.cli.bench import timed_windows
    from feedback_gnn_tpu_torch.decoders import CascadeConfig, sandwich_eval_step

    settings = bench.bench_settings({"BENCH_MSG_DTYPE": "bfloat16", **(env or {})})
    graph, qc, params = codes["n1270"]
    step = bench.make_step(graph, qc, params, settings)
    gen = torch.Generator(device=device).manual_seed(0)
    step(gen, settings.p)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    rates, step_ms, counts = timed_windows(step, (gen, settings.p), settings.batch)
    launched = read_counts()
    overflow = sum(int(c[2]) for c in counts)
    report_rate(f"bench bfloat16 carry [[1270,28]] nG=5 p={settings.p} B={settings.batch}", rates, step_ms, card)
    ratio = statistics.median(rates) / statistics.median(fp32_rates)
    print(f"bench bfloat16 carry: {len(counts)} steps, flagged={sum(int(c[0]) for c in counts)} "
          f"logical={sum(int(c[1]) for c in counts)} overflow={overflow} launches={launched}; "
          f"{statistics.median(rates):.1f} against float32's {statistics.median(fp32_rates):.1f} "
          f"syndromes/s in this run ({ratio:.4f}x) on {card}")
    if overflow != 0:
        raise AssertionError(f"compaction overflow {overflow} with the bfloat16 carry")
    if launched != expected_counts(K1=len(counts) * (2 + settings.cfg.num_rounds),
                                   GNN=len(counts) * settings.cfg.num_rounds):
        raise AssertionError(f"kernel launches {launched} in {len(counts)} bfloat16 bench steps")

    graph, qc, params = codes["n882"]
    cfg = CascadeConfig(num_iter1=64, num_iter2=16, num_rounds=3, p0=0.05, qc_msg_dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(7)
    reset_counts()
    flagged = logical = 0
    for _ in range(LER_STEPS):
        f, lg = sandwich_eval_step(graph, [params], cfg, gen, LER_P, 256, qc=qc)
        flagged += int(f)
        logical += int(lg)
    launched = read_counts()
    samples = LER_STEPS * 256
    rate, sig = sigmas(logical, samples, LER_REF)
    print(f"main path bfloat16 carry [[882,24]] nG=3 p={LER_P}: flagged={flagged} logical={logical}/{samples} "
          f"LER={rate:.5f}, {sig:.2f} sigma from the TF original's {LER_REF} (printed only) "
          f"launches={launched}")
    if launched != expected_counts(K1=LER_STEPS * (1 + 3), GNN=LER_STEPS * 3):
        raise AssertionError(f"kernel launches {launched} on the main path with the carry")
    return launched["K1"]


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
    """Stands in for osd0_decode where the OSD steps call it
    (decoders/osd.py) and keeps the first ``keep`` calls' inputs and
    outputs (``calls``; ``first`` the first)."""

    def __init__(self, keep=1):
        from feedback_gnn_tpu_torch.decoders import osd

        self.module, self.real, self.keep, self.calls = osd, osd.osd0_decode, keep, []

    @property
    def first(self):
        return self.calls[0] if self.calls else None

    def __call__(self, llr, pcm, syndrome):
        out = self.real(llr, pcm, syndrome)
        if len(self.calls) < self.keep:
            self.calls.append((llr.clone(), pcm, syndrome.clone(), out.clone()))
        return out

    def __enter__(self):
        self.module.osd0_decode = self
        return self

    def __exit__(self, *exc):
        self.module.osd0_decode = self.real


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


def osd_kernel_vs_plain(device, card, spec=OSD_KERNEL):
    """OSD-0's kernel against its plain version at the BP+OSD cell's
    shapes: one ``bp4_osd_eval_step`` batch ([[882,24]], B=20480, p=0.10,
    sub-batch 1024, K1 min-sum 0.8 x 100) with both of its osd0_decode
    calls recorded.  The batch must launch K1 once and the OSD kernel twice
    (one a side) and never the plain loop.  Each side's kernel equals the
    plain version on the card bit for bit on the whole sub-batch; both are
    timed by CUDA events, beside the bound (benchmark/osd_counts.py: the
    reference's integer operations of the flagged samples, at 64 a clock an
    SM) and the kernel's occupancy.  Returns the kernels line's row: both
    sides' kernel, plain and bound ms."""
    from benchmark import osd_counts
    from benchmark.reference import osd as ref_osd
    from feedback_gnn_tpu_torch import models
    from feedback_gnn_tpu_torch._build import load_kernels
    from feedback_gnn_tpu_torch.codes import QuantumGraph, ghp_882_24, qc_pair_from_code
    from feedback_gnn_tpu_torch.decoders.osd import osd0_decode, osd0_decode_plain, pack_columns, shared_bytes

    code = ghp_882_24()
    graph = QuantumGraph.from_code(code, stage_mode=True).to(device)
    qc = qc_pair_from_code(code)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    reset_counts()
    with OsdRecorder(keep=2) as rec:
        out = models.bp4_osd_eval_step(graph, code, gen, spec["p"], spec["batch"], num_iter=100,
                                       cn_type="minsum", normalization_factor=0.8, osd_compact_cap=spec["cap"],
                                       qc=qc)
        flagged = int(out[0])
    counts = read_counts()
    print(f"osd_kernel: one bp4_osd_eval_step batch B={spec['batch']} p={spec['p']} cap {spec['cap']}: "
          f"flagged {flagged}, launches={counts} on {card}")
    if counts != expected_counts(K1=1, OSD=2):
        raise AssertionError(f"osd_kernel: the batch launched {counts}; expected K1 once and OSD twice, no plain")
    lib = load_kernels()
    row = dict(launches=counts["OSD"], ms=0.0, graph_ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="operations")
    for side, (llr, pcm, syn, kernel_out) in zip("zx", rec.calls):
        rank, n = pcm.shape
        plain = osd0_decode_plain(llr, pcm, syn)
        ok = torch.equal(kernel_out, plain) and torch.equal(osd0_decode(llr, pcm, syn), plain)
        kernel_ms = time_ms(lambda: osd0_decode(llr, pcm, syn), reps=20)
        plain_ms = time_ms(lambda: osd0_decode_plain(llr, pcm, syn), reps=1)
        # the launch alone, in a CUDA graph: no basis copied from the host, no packing
        cols, bare = pack_columns(torch.as_tensor(pcm, device=device)), torch.empty_like(kernel_out)
        syn32, llr_c = syn.to(torch.int32).contiguous(), llr.contiguous()
        launch_ms = graph_ms(lambda: lib.fgt_osd0_launch(
            llr_c.data_ptr(), cols.data_ptr(), cols.shape[1], syn32.data_ptr(), bare.data_ptr(), llr.shape[0], n,
            rank, torch.cuda.current_stream().cuda_stream), reps=20)
        ok = ok and torch.equal(bare, plain)
        _, ops = ref_osd.osd0(llr[:flagged].cpu(), pcm, syn[:, :flagged].cpu())
        bound_ms = osd_counts.osd_bound_ms(1, int(ops.sum()))
        occ = (ctypes.c_int * 3)()
        err = lib.fgt_osd0_occupancy(n, rank, occ)
        print(f"osd_kernel side {side}: [{llr.shape[0]}, {n}], basis [{rank}, {n}]: kernel == plain "
              f"{'yes' if ok else 'NO'}; osd0_decode {kernel_ms:.4f} ms (the kernel alone, graph {launch_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({int(ops.sum())} integer operations of {flagged} "
              f"flagged samples; {100 * bound_ms / launch_ms:.4f} % of the kernel's time); "
              f"{shared_bytes(rank, n)} B shared, occupancy {list(occ) if err == 0 else err} "
              f"(blocks an SM, registers, spill bytes) on {card}")
        if not ok:
            raise AssertionError(f"osd_kernel side {side}: the kernel differs from the plain version")
        row["ms"] += kernel_ms
        row["graph_ms"] += launch_ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound_ms
    return row


def run_gf2(device, card, G=GF2):
    """The GF(2) product's kernel (csrc/gf2mat.cu) at the cells' full-batch
    shapes: each code's hx, hz, hx_perp and hz_perp on a [n_pad, B] int32
    batch.  Each must equal mod2_matmul_plain bit for bit, through
    ``mod2_matmul`` and launched bare, and count one ``gf2.launches`` a call
    (path ``kernel``).  Timed in CUDA graphs of ``reps`` calls: the kernel
    through ``mod2_matmul`` and launched bare, the plain version (float32
    copies, matmul, cast) and ``torch.matmul`` of the float32 operands
    alone (the library yardstick), beside the bytes bound (v read once, the
    int32 result written once, at 3.35 TB/s) and the kernel's occupancy.
    Returns the kernels line's row: [[1270,28]]'s hx product."""
    from feedback_gnn_tpu_torch import obs
    from feedback_gnn_tpu_torch._build import load_kernels
    from feedback_gnn_tpu_torch.codes import QuantumGraph
    from feedback_gnn_tpu_torch.config import build_code
    from feedback_gnn_tpu_torch.ops import gf2mat

    lib = load_kernels()
    b = G["batch"]
    row = None
    for name in G["codes"]:
        graph = QuantumGraph.from_code(build_code(name), stage_mode=True).to(device)
        gen = torch.Generator(device=device).manual_seed(G["seed"])
        v = (torch.rand((graph.n_pad, b), generator=gen, device=device) < G["p"]).to(torch.int32)
        for mat in G["matrices"]:
            h = getattr(graph, mat)
            m, n = h.shape
            obs.reset()
            out = gf2mat.mod2_matmul(h, v)
            keys = obs.snapshot()["keys"].get("gf2.launches", {})
            plain = gf2mat.mod2_matmul_plain(h, v)
            ok = torch.equal(out, plain) and keys == {("kernel", m, n, b): 1}
            slices, cols = gf2mat.row_lists(h)
            bare = torch.full_like(out, -1)

            def launch():
                err = lib.fgt_gf2_matmul_launch(v.data_ptr(), v.stride(0), 4, slices.data_ptr(), cols.data_ptr(),
                                                bare.data_ptr(), m, n, b, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"gf2 launch: {lib.fgt_cuda_error_string(err).decode()}")

            launch_ms = graph_ms(launch, G["reps"])
            ok = ok and torch.equal(bare, plain)
            occ = (ctypes.c_int * 3)()
            occ_err = lib.fgt_gf2_occupancy(4, n, occ)
            kernel_ms = graph_ms(lambda: gf2mat.mod2_matmul(h, v), G["reps"])
            eager_ms = time_ms(lambda: gf2mat.mod2_matmul(h, v), G["reps"])
            plain_ms = graph_ms(lambda: gf2mat.mod2_matmul_plain(h, v), G["reps"])
            hf, vf = h.to(torch.float32), v.to(torch.float32)
            library_ms = graph_ms(lambda: torch.matmul(hf, vf), G["reps"])
            bound_ms = 1e3 * (n * b * v.element_size() + m * b * 4) / H100_BYTES
            weights = (h != 0).sum(dim=1)
            print(f"gf2 {name} {mat} [{m}, {n}] x [{n}, {b}] ({int(weights.sum())} nonzeros, row weight up to "
                  f"{int(weights.max())}; {cols.shape[0]} slots in the row lists): kernel == plain "
                  f"{'yes' if ok else 'NO'}; mod2_matmul {kernel_ms * 1e3:.2f} us (graph; eager {eager_ms * 1e3:.2f}; "
                  f"the launch alone {launch_ms * 1e3:.2f}), bound {bound_ms * 1e3:.2f} us (bytes; "
                  f"{100 * bound_ms / kernel_ms:.1f} % of it), plain {plain_ms * 1e3:.2f} us, torch.matmul "
                  f"{library_ms * 1e3:.2f} us; occupancy {list(occ) if occ_err == 0 else occ_err} (blocks an SM, "
                  f"registers, spill bytes) on {card}", flush=True)
            if not ok:
                raise AssertionError(f"gf2 {name} {mat}: the kernel differs from the plain version or miscounts")
            if row is None:
                row = dict(shape=f"[[1270,28]] hx [{m}, {n}] x B={b}", ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes")
    return row


def gnn_bp4_update_bounds_ms(graph, widths, batch):
    """(CN update, VN update) least times on an H100 of one update at
    ``batch``: benchmark/gnn_bp4_counts.py's operations of the update (the
    message MLP on every edge of both sides and the update's embed MLP on
    every true node) at the float32 peak."""
    from benchmark import gnn_bp4_counts as gc

    e, m, h = (int(widths[k]) for k in ("num_embed_dims", "num_msg_dims", "num_hidden_units"))
    depth = int(widths["num_mlp_layers"])
    gx, gz = graph.gx, graph.gz
    msg = gc._mlp(2 * e, h, depth, m) * (gx.num_edges + gz.num_edges)
    cn = msg + (gx.num_cn + gz.num_cn) * gc._mlp(m + e + 1, h, depth, e)
    vn = msg + gx.num_vn * gc._mlp(2 * m + e, h, depth, e)
    return tuple(1e3 * batch * ops / H100_F32_OPS for ops in (cn, vn))


def run_gnn_bp4_kernel(device, card, registers, G=GNN_BP4_KERNEL):
    """GNN_BP4's update kernels (csrc/gnn_bp4.cu) at G's shape: each
    update's kernel within G["tol"] of its plain version on every row and
    counted as one ``kernel`` launch of ``gnn_bp4.launches``; its time by
    events beside its bound (``gnn_bp4_update_bounds_ms``) and the plain
    version's; ptxas registers and spills, occupancy; one whole decode of
    G's traffic on the kernels, its time, peak memory and launches beside
    the decode's bound (benchmark/gnn_bp4_counts.py).  Returns the kernels
    line's rows."""
    from benchmark import gnn_bp4_counts as gc
    from feedback_gnn_tpu_torch import obs
    from feedback_gnn_tpu_torch._build import load_kernels
    from feedback_gnn_tpu_torch.channels.pauli import depolarizing_probs, pauli_iid
    from feedback_gnn_tpu_torch.cli.train_gnn_bp4 import build_code
    from feedback_gnn_tpu_torch.codes import QuantumGraph
    from feedback_gnn_tpu_torch.decoders import gnn_full
    from feedback_gnn_tpu_torch.ops import mod2_matmul

    for (name, _), (regs, spill) in sorted(registers.items()):
        if "gnn_bp4" in name:
            print(f"GNN_BP4 ptxas {name}: {regs} registers, spill stores {spill} B", flush=True)
    host = QuantumGraph.from_code(build_code(G["code"]), stage_mode=True)
    graph, rs = host.to(device), gnn_full.make_logit_rowsets(host, device)
    params, cfg = gnn_full.load_shipped(G["code"], device)
    gx, gz, b = graph.gx, graph.gz, G["batch"]
    gen = torch.Generator(device=device).manual_seed(G["seed"])
    h_vn = torch.randn((cfg.num_embed_dims, gx.n_pad, b), generator=gen, device=device)
    h_cn_x, h_cn_z = (torch.randn((cfg.num_embed_dims, s.c_pad, b), generator=gen, device=device) for s in (gx, gz))
    logit_x, logit_z = (torch.randn((s.c_pad, b), generator=gen, device=device) * 3.0 for s in (gx, gz))
    sign_x, sign_z = (1.0 - 2.0 * torch.randint(0, 2, (s.c_pad, b), generator=gen, device=device).float()
                      for s in (gx, gz))
    updates = {
        "cn": (lambda: gnn_full._update_cn(params, graph, cfg, h_vn, h_cn_x, h_cn_z, logit_x, logit_z),
               lambda: gnn_full._update_cn_plain(params, graph, cfg, h_vn, h_cn_x, h_cn_z, logit_x, logit_z)),
        "vn": (lambda: gnn_full._update_vn(params, graph, cfg, h_cn_x, h_cn_z, h_vn, sign_x, sign_z),
               lambda: gnn_full._update_vn_plain(params, graph, cfg, h_cn_x, h_cn_z, h_vn, sign_x, sign_z)),
    }
    bounds = dict(zip(("cn", "vn"), gnn_bp4_update_bounds_ms(graph, cfg._asdict(), b)))
    (widths, slots) = gnn_full.kernel_instance(cfg, graph)
    lib = load_kernels()
    rows = {}
    with torch.no_grad():
        for update, (kernel, plain) in updates.items():
            reset_counts()
            out = kernel()
            keys = dict(obs.snapshot()["keys"].get("gnn_bp4.launches", {}))
            ref = plain()
            outs, refs = (out, ref) if update == "cn" else ([out], [ref])
            gap = max(float(((o - r).abs() / r.abs().clamp_min(1.0)).max()) for o, r in zip(outs, refs))
            equal = all(torch.equal(o, r) for o, r in zip(outs, refs))
            del out, ref, outs, refs
            k_ms = time_ms(kernel, G["reps"])
            p_ms = time_ms(plain, G["plain_reps"])
            which = 0 if update == "cn" else 1
            occ = (ctypes.c_int * 3)()
            err = lib.fgt_gnn_bp4_occupancy(which, *widths, slots[which], gnn_full.KERNEL_SLOTS[slots][which], occ)
            print(f"GNN_BP4 {update} update [[882,24]] B={b}: kernel {k_ms:.4f} ms, bound {bounds[update]:.4f} ms "
                  f"(operations; {100 * bounds[update] / k_ms:.1f} % of it), plain {p_ms:.4f} ms ({p_ms / k_ms:.2f}x); "
                  f"gap {gap:.3e} (limit {G['tol']}), bit for bit {'yes' if equal else 'no'}; occupancy (blocks an SM, "
                  f"registers, local B) {list(occ) if err == 0 else f'error {err}'}; launches {keys} on {card}",
                  flush=True)
            if gap > G["tol"] or keys != {("kernel", update, b): 1}:
                raise AssertionError(f"GNN_BP4 {update} update: gap {gap:.3e} (limit {G['tol']}), launches {keys}")
            rows[update] = dict(shape=f"[[882,24]] B={b}", ms=k_ms, plain_ms=p_ms, bound_ms=bounds[update],
                                bound_by="operations", max_rel_gap=gap, registers=occ[1], local_bytes=occ[2])
        del h_vn, h_cn_x, h_cn_z, logit_x, logit_z, sign_x, sign_z
        # one decode of the cell's traffic on the kernels
        nx, nz = pauli_iid(torch.Generator(device=device).manual_seed(G["seed"]), *depolarizing_probs(G["p"]),
                           graph.n, b)
        nx, nz = (torch.nn.functional.pad(t.to(torch.int32), (0, 0, 0, graph.n_pad - graph.n)) for t in (nx, nz))
        sx, sz = mod2_matmul(graph.hx, nz), mod2_matmul(graph.hz, nx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        d_ms = time_ms(lambda: gnn_full.gnn_bp4_apply(params, graph, rs, sx, sz, cfg), G["decode_reps"])
        peak = torch.cuda.max_memory_allocated()
        keys = dict(obs.snapshot()["keys"].get("gnn_bp4.launches", {}))
    dims = gc.Dims(graph.n, gx.num_cn, gz.num_cn, gx.num_edges, gz.num_edges, host.lx_rows, host.lz_rows)
    d_bound = gc.gnn_bp4_bound_ms(dims, cfg._asdict(), b)[0]
    calls = G["decode_reps"] + 1
    print(f"GNN_BP4 decode [[882,24]] B={b} p={G['p']}: {d_ms:.2f} ms ({b / d_ms * 1e3:.1f} syndromes/s), bound "
          f"{d_bound:.2f} ms ({100 * d_bound / d_ms:.1f} %), peak memory {peak / 1e9:.2f} GB; launches {keys} in "
          f"{calls} decodes on {card}", flush=True)
    if keys != {("kernel", "cn", b): cfg.num_iter * calls, ("kernel", "vn", b): cfg.num_iter * calls}:
        raise AssertionError(f"GNN_BP4 decode: launches {keys}, expected {cfg.num_iter * calls} of each on the kernel")
    rows["decode"] = dict(ms=d_ms, bound_ms=d_bound, peak_gb=peak / 1e9)
    return rows


def probe_library(p):
    """The one PyTorch call that computes the probe's function, as a thunk
    on its inputs (index tables widened to int64 beforehand), or None."""
    from feedback_gnn_tpu_torch.probes import CIRC_LEN, ROLL_SHIFT

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
    if p.name == "circulant_copy":  # one gather through a precomputed row index
        rows = torch.arange(a[0].shape[0], device=a[0].device)
        idx = torch.where(rows < CIRC_LEN, (rows + ROLL_SHIFT) % CIRC_LEN, rows)
        return lambda: torch.index_select(a[0], 0, idx)
    return None


def probe_bounds_ms(p, out, smem_bytes=LOOP_SMEM_BYTES, issue=0.0):
    """The probe's least time on an H100, (ms, by, memory), the largest of:
    its inputs read once and its output written once over the memory rate;
    its float32 operations (one multiply per element and iteration in the
    loops, phi's PHI_OPS) over the f32 rate; for the loops the bytes each
    iteration moves through shared memory (``smem_bytes`` an element) over
    its rate; and ``issue`` SASS instructions an element (phi's instance)
    over the card's issue rate.  ``by`` is "bytes", "operations" or
    "issue"; ``memory`` names the memory whose bytes bind, else None."""
    nbytes = sum(t.numel() * t.element_size() for t in p.args if torch.is_tensor(t))
    nbytes += out.numel() * out.element_size()
    ops = out.numel() * (PHI_OPS.get(p.name, 0) + (p.iters if p.iters > 1 else 0))
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_F32_OPS
    t_smem = p.iters * smem_bytes.get(p.name, 0) * out.numel() / H100_SMEM_BYTES
    t_issue = out.numel() * issue / H100_ISSUE
    t = max(t_bytes, t_ops, t_smem, t_issue)
    if t == t_issue:
        return 1e3 * t, "issue", None
    if t == t_ops:
        return 1e3 * t, "operations", None
    return 1e3 * t, "bytes", ("shared memory" if t == t_smem else "device memory")


def output_hash(t):
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def phi_issue(phi_sass, p, plan, fast=False):
    """SASS instructions an element of the phi instance ``plan`` runs for
    probe ``p`` (0.0 where the build phase counted none)."""
    from feedback_gnn_tpu_torch.probes import PHI_FORMS

    form = PHI_FORMS.index(p.name[len("phi_"):])
    return phi_sass.get((form, int(fast), int(plan.vec), plan.per_thread), 0.0)


def phi_probe(p, k_ms, phi_sass, card):
    """What a phi probe shows beyond its row: the plan and its accurate
    instance's SASS count, the bound old and new, the fast transcendentals
    against float64, the throughput shape's ns an element beside its issue
    and memory bounds, a plan grid at both shapes, ragged and misaligned
    inputs (each held to the plain version, the plan checked against the
    launch the library made), and the accurate output's hash.  Returns the
    row's added fields."""
    from feedback_gnn_tpu_torch import probes

    x = p.args[0]
    form = p.name[len("phi_"):]
    sms = probes._sms(x.device.index)
    out = p.fn(*p.args)
    plan = probes._phi_plan(x.numel(), sms, probes._aligned(x, out))
    if probes.phi_last_launch() != plan:
        raise AssertionError(f"{p.key}: the library launched {probes.phi_last_launch()}, the plan is {plan}")
    ipe = phi_issue(phi_sass, p, plan)
    old_ms = probe_bounds_ms(p, out)[0]
    b_ms, b_by, _ = probe_bounds_ms(p, out, issue=ipe)
    print(f"  {p.key} plan {plan}: {ipe:.2f} SASS instructions an element (fast "
          f"{phi_issue(phi_sass, p, plan, True):.2f}); bound {b_ms:.5f} ms ({b_by}), the older bound "
          f"(bytes and operations alone) {old_ms:.5f} ms; hash of the accurate output {output_hash(out)}")

    f_ms = graph_ms(lambda: p.fn(*p.args, fast=True), reps=PROBE_REPS)
    ref64 = probes.phi_reference(x)
    fast_out = p.fn(*p.args, fast=True)
    acc_err = float((out.double() - ref64).abs().max())
    fast_err = float((fast_out.double() - ref64).abs().max())
    if not bool(torch.isfinite(fast_out).all()) or fast_err >= 1.0:
        raise AssertionError(f"{p.key}: the fast transcendentals are {fast_err:.3e} from float64 phi")
    print(f"  {p.key} fast transcendentals: {f_ms:.5f} ms against {k_ms:.5f} ms; max abs error "
          f"against float64 phi: accurate {acc_err:.3e}, fast {fast_err:.3e} on {card}")

    g = torch.Generator(device=x.device).manual_seed(13)
    wide = torch.randn(PHI_WIDE, generator=g, device=x.device)
    n = wide.numel()
    wout = p.fn(wide)
    wplan = probes.phi_last_launch()
    if wplan != probes._phi_plan(n, sms, probes._aligned(wide, wout)):
        raise AssertionError(f"{p.key}: the library launched {wplan} at {list(PHI_WIDE)}")
    err = probes.compare(p, wout, p.plain(wide))
    w_ms = graph_ms(lambda: p.fn(wide), reps=PHI_WIDE_REPS)
    wf_ms = graph_ms(lambda: p.fn(wide, fast=True), reps=PHI_WIDE_REPS)
    w_ipe = phi_issue(phi_sass, p, wplan)
    issue_ns, hbm_ns = w_ipe / H100_ISSUE * 1e9, 8 / H100_BYTES * 1e9
    print(f"  {p.key} throughput shape {list(PHI_WIDE)} plan {wplan}: accurate {w_ms * 1e6 / n:.6f} ns an "
          f"element ({w_ms:.5f} ms, max_abs_err {err:.3e}), fast {wf_ms * 1e6 / n:.6f} ns; bounds an element: "
          f"issue {issue_ns:.6f} ns ({w_ipe:.2f} instructions), memory {hbm_ns:.6f} ns (8 B); "
          f"{issue_ns / (w_ms * 1e6 / n):.3f} of the issue bound on {card}")

    times = {}
    for shape_x, reps in ((x, PROBE_REPS), (wide, PHI_WIDE_REPS)):
        chosen = probes._phi_plan(shape_x.numel(), sms)
        want = p.fn(shape_x)
        for pt, threads in PHI_GRID:
            gp = probes._phi_plan(shape_x.numel(), sms, True, pt, threads)
            got = probes._launch_phi(p.name, shape_x, form, False, gp)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            if not same:
                probes.compare(p, got, p.plain(shape_x))
            times[(shape_x.numel(), gp)] = (graph_ms(lambda: probes._launch_phi(p.name, shape_x, form, False, gp),
                                                     reps=reps), same, gp == chosen)
            torch.cuda.empty_cache()  # each graph of the wide shape held 20 outputs of 126 MB
    for size in (x.numel(), n):
        rows = {gp: v for (sz, gp), v in times.items() if sz == size}
        best = min(rows, key=lambda gp: rows[gp][0])
        for gp, (ms, same, is_chosen) in rows.items():
            print(f"  {p.key} grid n={size} {gp.per_thread} units a thread x {gp.threads} threads, "
                  f"{gp.grid} blocks: {ms * 1e3:.4f} us" + ("" if same else " (other bits, within PHI_TOL)")
                  + (" <- fastest" if gp == best else "") + (" <- chosen" if is_chosen else "") + f" on {card}")
    del wide, wout

    for rows, cols, offset in PHI_RAGGED:
        buf = torch.randn(rows * cols + offset, generator=g, device=x.device)
        r = buf[offset:].view(rows, cols)
        for fast in (False, True):
            o = p.fn(r, fast=fast)
            if probes.phi_last_launch() != probes._phi_plan(r.numel(), sms, probes._aligned(r, o)):
                raise AssertionError(f"{p.key} [{rows}, {cols}] +{offset}: launched {probes.phi_last_launch()}")
            if fast:
                if float((o.double() - probes.phi_reference(r)).abs().max()) >= 1.0:
                    raise AssertionError(f"{p.key} fast [{rows}, {cols}] +{offset} far from float64 phi")
            else:
                probes.compare(p, o, p.plain(r))
    print(f"  {p.key} ragged and misaligned inputs (rows, cols, float offset) {PHI_RAGGED}: accurate within "
          f"PHI_TOL of the plain version, fast near float64 phi, each launched by its plan")
    return {"old_bound_ms": old_ms, "sass_per_element": ipe, "fast_ms": f_ms,
            "wide_ns_per_element": w_ms * 1e6 / n, "wide_fast_ns_per_element": wf_ms * 1e6 / n,
            "wide_issue_ns_per_element": issue_ns, "hash": output_hash(out)}


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


def run_probes(device, card, phi_sass):
    """probes.main(), the entry point of the Pallas probe scripts' port, with
    the launch counts reset just before and read just after; then each probe
    against its plain version, the kernel's, the plain version's and the
    library call's times, the bounds, and for phi what ``phi_probe`` shows
    (``phi_sass``: the build phase's instructions an element of each phi
    instance).  Returns the probes' rows of the kernels line."""
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
        issue = 0.0
        if not p.exact:
            x = p.args[0]
            issue = phi_issue(phi_sass, p, probes._phi_plan(x.numel(), probes._sms(x.device.index),
                                                            probes._aligned(x, out)))
        b_ms, b_by, b_mem = probe_bounds_ms(p, out, issue=issue)
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
        if not p.exact:
            row = phi_probe(p, k_ms, phi_sass, card)
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
    share at each compaction level and the throughput."""
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
    if counts != expected_counts(K1=steps * (2 + E["rounds"]), GNN=steps * E["rounds"]):  # prepass, subset, rounds
        raise AssertionError(f"kernel launches {counts} in {steps} evaluate batches")


def run_rescue(codes, device, card, R=RESCUE, rounds=EVALUATE["rounds"]):
    """One seeded step of the compacted cascade per rescue setting: none,
    tf, tf then accurate at capacity 0.02, and tf at one sample of
    capacity.  The flagged count never rises, the overflow is 0 at 0.02
    and not at one sample, and K1 runs (1 + nG) launches per stage.
    Returns the rescue capacity at 0.02."""
    from dataclasses import replace

    from feedback_gnn_tpu_torch.decoders.cascade import CascadeConfig, sandwich_eval_step
    from feedback_gnn_tpu_torch.decoders.compact import capacity

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
        print(f"rescue {rescue} (capacity {capacity(fraction, R['batch'], tile)}) p={R['p']} "
              f"B={R['batch']}: flagged={flagged} logical={logical} overflow={overflow}, {ms:.3f} ms, "
              f"launches={counts} on {card}")
        if counts != expected_counts(K1=(1 + rounds) * (1 + stages), GNN=rounds * (1 + stages)):
            raise AssertionError(f"rescue {rescue}: kernel launches {counts}, expected K1="
                                 f"{(1 + rounds) * (1 + stages)}, GNN={rounds * (1 + stages)}")
        rows[(rescue, tile)] = (flagged, overflow, ms)
    f_none, f_tf, f_both = (rows[(k, 128)][0] for k in (None, "tf", "tf,accurate"))
    under = rows[("tf", 1)]
    if not f_both <= f_tf <= f_none:
        raise AssertionError(f"rescue raised the flagged count: {f_none}, {f_tf}, {f_both}")
    if any(rows[(k, 128)][1] for k in (None, "tf", "tf,accurate")):
        raise AssertionError("rescue: overflow at rescue_fraction 0.02")
    if not (under[1] > 0 and under[0] <= f_none):
        raise AssertionError(f"rescue at one sample of capacity: overflow {under[1]}, flagged {under[0]}")
    return capacity(0.02, R["batch"], 128)


def run_gather_cascade(device, card, G=GATHER, rounds=EVALUATE["rounds"]):
    """One step of the evaluate step on the gather backend (no
    --qc-kernel): LER within LER_SIGMAS of the main path's reference, no
    BP kernel launched, the fused GNN step once a round."""
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
    if counts != expected_counts(GNN=rounds):
        raise AssertionError(f"gather_cascade launched kernels: {counts}, expected GNN={rounds}")


def run_osd(bp_rates, device, card, specs=None):
    """cli/osd_eval.py's main() for bp2-osd and bp4-osd, to 100 errors or a
    fixed number of batches, each OSD sub-batch sized from ``bp_rates``,
    the flagged rates of its BP; checks the LER, the overflow and the
    kernels (bp4-osd: K1's float32 min-sum instance once a batch at the
    whole batch; bp2-osd: none), and holds the card's osd0_decode to the
    CPU's on one recorded sub-batch; prints OSD's share of a batch's time."""
    from feedback_gnn_tpu_torch import obs
    from feedback_gnn_tpu_torch.cli import osd_eval

    specs = specs or {"bp2-osd": OSD_BP2, "bp4-osd": OSD_BP4}
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
        k1_keys = obs.snapshot()["keys"].get("k1.launches", {})
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
        if mode == "bp4-osd":
            want = {(spec["batch"], 100, "minsum", None, "float32"): steps}
            if counts != expected_counts(K1=steps, OSD=2 * steps) or k1_keys != want:
                raise AssertionError(f"{mode} launched kernels: {counts}, K1 shapes {k1_keys}; expected K1's "
                                     f"launches {want}")
        elif counts != expected_counts(OSD=steps):
            raise AssertionError(f"{mode} launched kernels: {counts}")
        calls = 2 if mode == "bp4-osd" else 1
        print(f"osd {mode}: osd0_decode {calls} x {osd_ms:.3f} ms of a {step_ms:.3f} ms batch "
              f"(OSD share {calls * osd_ms / step_ms:.3f}) on {card}")


@contextlib.contextmanager
def plain_k1():
    """K1's wrapper replaced by its plain version, which runs on the tensors'
    own device: a path run against itself without the kernel."""
    from feedback_gnn_tpu_torch.decoders import bp4_qc

    wrapper = bp4_qc.bp4_qc_marginals

    def plain(qc, llr, sx, sz, num_iter, cn_type="boxplus-phi", factor=1.0, msg_dtype="float32",
              phi_impl=None):
        return bp4_qc.bp4_qc_marginals_plain(qc, llr, sx, sz, num_iter, cn_type, factor, phi_impl,
                                             msg_dtype)

    bp4_qc.bp4_qc_marginals = plain
    try:
        yield
    finally:
        bp4_qc.bp4_qc_marginals = wrapper


def check_miner(label, make, batch, launches, gnn, device, card, T=TRAIN):
    """A K1 miner (compacted) against itself on K1's plain version, on the
    same injected noise: the same kept count and columns, bit for bit, and
    ``launches`` K1 launches and ``gnn`` fused GNN steps.  Prints how far its flagged set agrees with
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
    if counts != expected_counts(K1=launches, GNN=gnn):
        raise AssertionError(f"{label} miner: kernel launches {counts}, expected K1={launches}, GNN={gnn}")
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
    row of K1 at the miners' shape and a train step's ms."""
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
    check_miner("easy", easy, T["easy_batch"], 1, 0, device, card)
    check_miner("hard", hard, T["hard_batch"], 2, 1, device, card)
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
    b_ms, b_by = k1_bound_ms(qc.qx, qc.qz, T["mine_batch"], T["iters"])
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
    if counts != expected_counts(GNN_plain=T["rate_steps"]):  # its GNN step carries a gradient
        raise AssertionError(f"the train step launched kernels: {counts}, expected GNN_plain={T['rate_steps']}")

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
        # easy: one launch a batch; hard: two and a GNN step; evaluation (the trained
        # and the shipped weights): 1 + nG=3 a batch and nG GNN steps; the train
        # steps' GNN steps run plain (a gradient), one a step
        want = len(weights) * mine_batches * 3 + 4 * eval_batches
        want_gnn = len(weights) * mine_batches + 3 * eval_batches
        print(f"train_from_scratch [[882,24]] {' '.join(CURRICULUM)}: {first_s:.2f} s, artifacts {made}, "
              f"launches={counts} (K1 counted from the code {want}, GNN {want_gnn})")
        for name, r in res.items():
            print(f"  {name}: p={r['ps']} LER={r['ler']} errors={r['errors']} blocks={r['blocks']} "
                  f"overflow={r['overflow']}")
        if made != sorted(CURRICULUM_ARTIFACTS):
            raise AssertionError(f"train_from_scratch wrote {made}")
        if any(sum(r["overflow"]) for r in res.values()) or set(res) != {"trained", "shipped"}:
            raise AssertionError(f"train_from_scratch evaluation: {res}")
        if counts["GNN_plain"] < 1 or counts != expected_counts(K1=want, GNN=want_gnn,
                                                               GNN_plain=counts["GNN_plain"]):
            raise AssertionError(f"train_from_scratch: kernel launches {counts}, expected K1={want}, "
                                 f"GNN={want_gnn}, GNN_plain at least 1")
        stamps = {a: os.stat(os.path.join(d, a)).st_mtime_ns for a in CURRICULUM_ARTIFACTS[:-1]}
        reset_counts()
        t1 = time.perf_counter()
        again = train_from_scratch.main(argv + ["--skip-shipped-eval"])
        again_s = time.perf_counter() - t1
        counts = read_counts()
        again_batches = sum(again["trained"]["blocks"]) // eval_batch
        want = 4 * again_batches
        kept = {a: os.stat(os.path.join(d, a)).st_mtime_ns for a in CURRICULUM_ARTIFACTS[:-1]} == stamps
        print(f"train_from_scratch resumed: {again_s:.2f} s, artifacts "
              f"{'untouched' if kept else 'REWRITTEN'}, "
              f"trained LER {again['trained']['ler']} (first call {res['trained']['ler']}), launches={counts} "
              f"(the evaluation's {want})")
        if (not kept or counts != expected_counts(K1=want, GNN=3 * again_batches)
                or again["trained"] != res["trained"]):
            raise AssertionError("train_from_scratch did not resume from its artifacts")
    return {"k1": (k_ms, p_ms, b_ms, b_by), "ms": step_ms}


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
    matmul computes them; the updates on the plain path, whose dense layers
    these are."""
    from feedback_gnn_tpu_torch.decoders import gnn_full

    plain, takes = gnn_full.dense_bl, gnn_full.takes_kernel

    def rounded(x, kernel, bias=None, activation=None):
        return plain(x.to(torch.bfloat16).float(), kernel.to(torch.bfloat16).float(), bias, activation)

    gnn_full.dense_bl = rounded
    gnn_full.takes_kernel = lambda *args, **kw: False  # the kernels' products are float32 only
    try:
        yield
    finally:
        gnn_full.dense_bl, gnn_full.takes_kernel = plain, takes


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
    cli/n1270.py --qc-kernel.  Returns the eval and train steps' ms, the
    eval step's CN and VN kernel launches a batch and K1's rows at
    cli/n1270.py's shapes."""
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

    def bp4_counts(**launched):
        """expected_counts with GNN_BP4's updates ``launched``: the counter
        counts the card's calls only."""
        return expected_counts(**(launched if device.type == "cuda" else {}))

    # 1.-2. the shipped trained weights against the JAX package's runs, each
    # CN and VN update of the eval step on its kernel (on the plain version
    # where ``plain`` is set: the bf16 diagnostic)
    def ler_rows(tag, table, plain=False):
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
            updates = cfg.num_iter * batches
            want = (bp4_counts(GNN_BP4_plain=2 * updates) if plain
                    else bp4_counts(GNN_BP4_CN=updates, GNN_BP4_VN=updates))
            if counts != want:
                raise AssertionError(f"the GNN_BP4 eval step's launches {counts}, expected {want}")
            out.setdefault("launches", {"cn": counts["GNN_BP4_CN"] // batches,
                                        "vn": counts["GNN_BP4_VN"] // batches})
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
        ler_rows("bf16 dense inputs (diagnostic) ", G["precision_diag"], plain=True)
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
    out["train_ms"] = dt / G["rate_steps"] * 1e3
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
    # the training steps' updates carry a gradient (the plain version), the
    # evaluation's run on the kernels: both sweeps, every point's batches
    decodes = 2 * len(written["trained"]) * int(G["cli"][G["cli"].index("--eval-batches") + 1])
    iters = written["cfg"]["num_iter"]
    want = bp4_counts(GNN_BP4_CN=iters * decodes, GNN_BP4_VN=iters * decodes,
                      GNN_BP4_plain=2 * iters * written["steps"])
    cli_p = float(G["cli"][G["cli"].index("--eval-p") + 1])
    init_ler, trained_ler = results["init"][cli_p]["ler"], results["trained"][cli_p]["ler"]
    print(f"gnn_bp4 cli/train_gnn_bp4.py {' '.join(G['cli'])}: {secs:.2f} s; loss step 0 {losses[0]:.4f}, "
          f"step {len(losses) - 1} {losses[-1]:.4f}; LER at p={cli_p} init {init_ler:.4e}, trained "
          f"{trained_ler:.4e}; weights loaded back {'equal' if same else 'DIFFERENT'}; JSON keys "
          f"{list(written)}; launches={counts} (expected {want})", flush=True)
    point = next(iter(written["trained"].values()))
    if not (np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0] and trained_ler < init_ler and same
            and list(written) == ["code", "cfg", "steps", "train_p", "init", "trained"]
            and list(written["cfg"]) == list(GNNBP4Config._fields)
            and list(point) == ["flagged", "logical", "blocks", "ler"] and counts == want):
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
          f"(K1 counted from the code: {batches * 6}, GNN {batches * 5})", flush=True)
    if overflow != 0 or counts != expected_counts(K1=batches * 6, GNN=batches * 5) or batches < 1:
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
        b_ms, b_by = k1_bound_ms(qc.qx, qc.qz, bs, iters)
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
    functions = sass_functions(info["library"])
    sass_counts(functions)
    phi_sass = phi_sass_counts(functions, registers)
    gnn_bp4_mma = sum(c[2] for c in gnn_bp4_sass(functions).values()) if functions else None
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

    # the host GF(2) core that builds the codes
    t0 = time.perf_counter()
    run_native(card)
    phase("native", t0)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    max_err = compare_kernel(codes, device)
    osd_k1 = compare_osd_k1(codes, device, card)
    max_err = max(max_err, osd_k1["max_abs_err"])
    phase("kernel_vs_plain", t0)

    t0 = time.perf_counter()
    k2_err = compare_k2(k2_specs, device)
    phase("k2_vs_plain", t0)

    t0 = time.perf_counter()
    gnn_row = run_gnn(codes, device, card, registers, functions)
    phase("gnn_vs_plain", t0)

    t0 = time.perf_counter()
    gf2_row = run_gf2(device, card)
    phase("gf2_kernel_vs_plain", t0)

    t0 = time.perf_counter()
    gnn_bp4_rows = run_gnn_bp4_kernel(device, card, registers)
    phase("gnn_bp4_kernel_vs_plain", t0)

    # 4. the main path
    t0 = time.perf_counter()
    reset_counts()
    fn, gen, flagged, logical, samples = run_main_path(device)
    counts = read_counts()
    launches, gnn_launches = counts["K1"], counts["GNN"]
    ler = logical / samples
    sigma = (LER_REF * (1 - LER_REF) / samples) ** 0.5
    print(f"main path [[882,24]] nG=3 p={LER_P}: flagged={flagged} logical={logical}/{samples} "
          f"LER={ler:.5f} ref={LER_REF} ({abs(ler - LER_REF) / sigma:.2f} sigma) launches={counts}")
    if abs(ler - LER_REF) >= LER_SIGMAS * sigma:
        raise AssertionError(f"LER {ler} outside {LER_SIGMAS} sigma of {LER_REF}")
    same_counts("main path", logical, samples)
    if counts != expected_counts(K1=LER_STEPS * (1 + 3), GNN=LER_STEPS * 3):
        raise AssertionError(f"kernel launches {counts}, expected K1={LER_STEPS * 4}, GNN={LER_STEPS * 3}")
    rates, step_ms, _ = timed_windows(fn, (gen, 0.08), 256)
    report_rate("main path throughput [[882,24]] B=256 p=0.08", rates, step_ms, card)
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
    report_rate(f"bench [[1270,28]] nG=5 p={settings.p} B={settings.batch}", rates, step_ms, card)
    print(f"bench: {len(counts)} steps, flagged={flagged_b} logical={logical_b} overflow={overflow} "
          f"launches={launches_b}; metric {bench.METRIC}, vs_baseline "
          f"{statistics.median(rates) / bench.BASELINE_SYNDROMES_PER_S:.2f}")
    if overflow != 0:
        raise AssertionError(f"compaction overflow {overflow}")
    if launches_b != expected_counts(K1=len(counts) * (2 + cfg.num_rounds), GNN=len(counts) * cfg.num_rounds):
        raise AssertionError(f"kernel launches {launches_b} in {len(counts)} bench steps")
    phase("bench", t0)

    # 5b. the same workload and the main path with the bfloat16 message carry
    t0 = time.perf_counter()
    bf16_launches = run_carry(codes, rates, device, card)
    phase("bf16_carry", t0)

    # 6.-8. the evaluate CLI to 100 logical errors, the rescue stage, the
    # evaluate step on the gather backend
    t0 = time.perf_counter()
    run_evaluate(codes, device, card)
    phase("evaluate", t0)
    t0 = time.perf_counter()
    rescue_cap = run_rescue(codes, device, card)
    phase("rescue", t0)
    t0 = time.perf_counter()
    run_gather_cascade(device, card)
    phase("gather_cascade", t0)

    # 9. K1 against its plain version, and both times, at every shape the
    # main path, the bench, the evaluate CLI, the rescue and phase
    # parallel's ranks give it
    t0 = time.perf_counter()
    from feedback_gnn_tpu_torch.cli import bench_scaling
    from feedback_gnn_tpu_torch.decoders.compact import capacity

    E = EVALUATE
    cap1 = capacity(cfg.compact_fraction, settings.batch, cfg.qc_batch_tile)
    cap2 = capacity(cfg.round_fraction, settings.batch, cfg.qc_batch_tile)
    ecap1 = capacity(E["compact"], E["batch"], 128)
    ecap2 = capacity(E["rounds_cap"], E["batch"], 128)
    local = PARALLEL["batch"] // 2  # (a) and (c): the evaluate cascade on each of 2 data ranks
    scale = bench_scaling._parser().parse_args(PARALLEL["scaling"])  # no compaction, no prepass
    shapes = [  # (code, batch, iterations, phi form, time the plan grid)
        ("n882", 256, 64, None, True), ("n882", 256, 16, None, True),
        ("n1270", settings.batch, 12, None, True), ("n1270", cap1, 64, None, True),
        ("n1270", cap2, 16, None, True),
        ("n882", E["batch"], E["prepass"], None, False), ("n882", ecap1, 64, None, False),
        ("n882", ecap2, 16, None, False),
        ("n882", local, E["prepass"], None, False), ("n882", capacity(E["compact"], local, 128), 64, None, False),
        ("n882", capacity(E["rounds_cap"], local, 128), 16, None, False),
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
        same_k1_hash(label, (nm, batch, iters, phi), out)
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
        b_ms, b_by = k1_bound_ms(qc_s.qx, qc_s.qz, batch, iters, phi_impl=phi)
        timing[(nm, batch, iters, phi)] = (k_ms, p_ms, b_ms, b_by)
        old = PREVIOUS_K1_MS.get((nm, batch, iters)) if phi is None else None
        print(f"K1 {label}: kernel {k_ms:.4f} ms ("
              + (f"previous design {old:.4f} ms, ratio {k_ms / old:.3f}; " if old else "")
              + f"in a CUDA graph {g_ms:.4f} ms), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) on {card}")
    bf16_rows = time_carry(codes, [
        ("n882", 256, 64, None, None), ("n1270", settings.batch, 12, None, None),
        ("n1270", cap1, 64, None, None), ("n1270", cap2, 16, None, None),
        ("n882", rescue_cap, 64, "tf", None), ("n882", rescue_cap, 16, "accurate", None),
        ("n882", 256, 64, None, (0, 0)),
    ], registers, device, card)
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
    report_rate(f"bp2_path throughput [[882,24]] hx B={BP2['batch']} p={BP2['p']}",
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
    phase("bp4_plain_path", t0)

    # 12. BP + OSD-0 through cli/osd_eval.py, OSD sub-batches sized from
    # the flagged rates bp2_path and bp4_plain_path measured for their BP
    t0 = time.perf_counter()
    run_osd({"bp2-osd": flagged2 / (BP2["steps"] * BP2["batch"]),
                        "bp4-osd": flagged4 / (BP4_PLAIN["steps"] * BP4_PLAIN["batch"])}, device, card)
    osd_row = osd_kernel_vs_plain(device, card)
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
    probe_rows = run_probes(device, card, phi_sass)
    phase("probes", t0)

    # 15. training: the K1 miners, the train step, the curriculum CLI
    t0 = time.perf_counter()
    run_train(codes, code882, device, card)
    phase("train", t0)

    # 16. GNN_BP4 and the example CLIs
    t0 = time.perf_counter()
    gnn_bp4_out = run_gnn_bp4(codes, device, card)
    phase("gnn_bp4", t0)

    # 17. multi-device: data-parallel and edge-sharded ranks
    t0 = time.perf_counter()
    run_parallel(codes, code882, device, card)
    phase("parallel", t0)

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
            "name": "bp4_qc_marginals (minsum, BP4 + OSD-0)",
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/bp4_qc.cu",
            "replaces": "feedback_gnn_tpu/decoders/bp4_qc.py:329",
            "shape": "[[882,24]] B=%d x %d, factor %s" % (OSD_K1["batch"], OSD_K1["iters"], OSD_K1["factor"]),
            **osd_k1,
            "library_ms": None,
        },
        {
            "name": "bp4_qc_marginals (msg_dtype=bfloat16)",
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/bp4_qc.cu",
            "replaces": "feedback_gnn_tpu/decoders/bp4_qc.py:329",
            "launches": bf16_launches,
            "max_abs_err": max(r["max_abs_err"] for r in bf16_rows.values()),
            **{k: bf16_rows[("n882", 256, 64, None, None)][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
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
        {
            "name": "feedback_gnn_apply",
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/gnn_feedback.cu",
            "replaces": "feedback_gnn_tpu/decoders/gnn_feedback.py:93",
            "launches": gnn_launches,
            "shape": "[[1270,28]] B=%d" % GNN["row"][1],
            "max_rel_gap": gnn_row["max_rel_gap"],
            "ms": gnn_row["ms"],
            "plain_ms": gnn_row["plain_ms"],
            "bound_ms": gnn_row["bound_ms"],
            "bound_by": "issue",
            "function_bound_ms": gnn_row["function_bound_ms"],
            "host_us": gnn_row["host_us"],
            "plain_host_us": gnn_row["plain_host_us"],
            "library_ms": None,
        },
        {
            "name": "osd0_decode",
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/osd0.cu",
            "replaces": "feedback_gnn_tpu/decoders/osd.py osd0_decode (XLA ops)",
            "shape": "[[882,24]] sub-batch %d, both sides" % OSD_KERNEL["cap"],
            **osd_row,
            "library_ms": None,
        },
        {
            "name": "mod2_matmul",
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/gf2mat.cu",
            "replaces": "feedback_gnn_tpu/ops/gf2mat.py mod2_matmul (XLA dot)",
            "max_abs_err": 0,
            **gf2_row,
        },
        *({
            "name": f"gnn_full._update_{update} (GNN_BP4 {update.upper()} update)",
            "route": "cuda",
            "source": "feedback_gnn_tpu_torch/csrc/gnn_bp4.cu",
            "replaces": "feedback_gnn_tpu/decoders/gnn_full.py _update_%s (XLA ops)" % update,
            "launches": gnn_bp4_out["launches"][update],  # a batch of models.gnn_bp4_eval_step
            "tensor_core_sass": gnn_bp4_mma,
            **gnn_bp4_rows[update],
            "library_ms": None,
        } for update in ("cn", "vn")),
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
