"""Benchmark of the port: decoded syndromes/s of bench.py's workload on the
CUDA card.

Workload: [[1270,28]] QC-GHP code, nG=5 feedback-GNN cascade (BP4-64 +
5 x (GNN + BP4-16), boxplus-phi, factor 1.0) with the BP-12 prepass and
compaction 0.15/0.05, depolarizing p=0.05, B=20480, end to end including
channel sampling, syndromes and error accounting.  The environment
overrides of bench.py apply: BENCH_BATCH, BENCH_P, BENCH_ITERS (here the
number of timed windows), BENCH_NO_QC (the gather BP backend), BENCH_CN,
QC_TILE, BENCH_MSG_DTYPE, BENCH_COMPACT, BENCH_PREPASS, BENCH_ROUNDS and
BENCH_PROFILE (a directory for a torch.profiler trace of the timed
windows).

Timing: the median of 5 windows of at least 1 s of back-to-back steps, each
window ending in a fetch of the last counts and a synchronize.  A nonzero
compaction overflow voids the number: the run raises.

    python -m feedback_gnn_tpu_torch.cli.bench

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass

import torch

from .. import resolve_device
from ..decoders.cascade import CascadeConfig, sandwich_eval_step

__all__ = ["METRIC", "BASELINE_SYNDROMES_PER_S", "BenchSettings", "bench_settings", "make_step",
           "timed_windows", "main"]

METRIC = "n1270_nG5_cascade_syndromes_per_s_torch"
BASELINE_SYNDROMES_PER_S = 4460.0  # BASELINE.md: the TF original, n1270 nG=5 cascade, RTX 4090
WINDOWS, WINDOW_S = 5, 1.0


@dataclass(frozen=True)
class BenchSettings:
    batch: int
    p: float
    windows: int
    use_qc: bool
    cfg: CascadeConfig


def bench_settings(env=os.environ) -> BenchSettings:
    """The workload with bench.py's environment overrides applied."""
    cfg = CascadeConfig(
        num_iter1=64,
        num_iter2=16,
        num_rounds=5,
        p0=0.05,
        cn_type=env.get("BENCH_CN", "boxplus-phi"),
        qc_batch_tile=int(env.get("QC_TILE", 128)),
        qc_msg_dtype=env.get("BENCH_MSG_DTYPE", "float32"),
        # flagged after the 12-iteration prepass at p=0.05 is ~12.6 % on
        # [[1270,28]], after the full 64 ~2.8 %: 15 % and 5 % leave margin
        compact_fraction=float(env.get("BENCH_COMPACT", 0.15)) or None,
        stage1_prepass=int(env.get("BENCH_PREPASS", 12)) or None,
        round_fraction=float(env.get("BENCH_ROUNDS", 0.05)) or None,
    )
    return BenchSettings(
        batch=int(env.get("BENCH_BATCH", 20480)),
        p=float(env.get("BENCH_P", 0.05)),
        windows=int(env.get("BENCH_ITERS", WINDOWS)),
        use_qc=not env.get("BENCH_NO_QC"),
        cfg=cfg,
    )


def make_step(graph, qc, params, settings: BenchSettings):
    """The workload's step(generator, p) -> (flagged, logical, overflow);
    ``qc`` None (or ``settings.use_qc`` false) runs the gather backend."""
    qc = qc if settings.use_qc else None

    def step(generator, p):
        return sandwich_eval_step(graph, [params], settings.cfg, generator, p, settings.batch, qc=qc,
                                  return_overflow=True)

    return step


def _synchronize():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_windows(step, args, batch, windows=WINDOWS, window_s=WINDOW_S):
    """Syndromes/s of back-to-back steps over ``windows`` windows of at
    least ``window_s`` seconds each (each window ends with a fetch of the
    last step's counts and a synchronize); returns the per-window rates,
    the per-window ms per step, and every step's output."""
    rates, step_ms, outs = [], [], []
    for _ in range(windows):
        _synchronize()
        t1 = time.perf_counter()
        n = 0
        while True:
            outs.append(step(*args))
            n += 1
            if time.perf_counter() - t1 >= window_s:
                break
        int(outs[-1][0])
        _synchronize()
        dt = time.perf_counter() - t1
        rates.append(n * batch / dt)
        step_ms.append(dt / n * 1e3)
    return rates, step_ms, outs


def main():
    from ..entry import load_code

    device = resolve_device()  # the card: the bench measures nothing else
    s = bench_settings()
    graph, qc, params = load_code("n1270", device)
    step = make_step(graph, qc, params, s)
    gen = torch.Generator(device=device).manual_seed(0)

    t0 = time.perf_counter()
    for _ in range(2):  # warm-up: allocator and first launches
        int(step(gen, s.p)[0])
    _synchronize()
    name = torch.cuda.get_device_name(device)
    print(f"# warm-up: {time.perf_counter() - t0:.1f}s  device={name}", file=sys.stderr)

    profile_dir = os.environ.get("BENCH_PROFILE")
    prof = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       on_trace_ready=tensorboard_trace_handler(profile_dir))
    with prof:
        rates, step_ms, outs = timed_windows(step, (gen, s.p), s.batch, s.windows)
    overflow = sum(int(o[2]) for o in outs)
    if overflow:
        raise RuntimeError(f"compaction overflow {overflow} in {len(outs)} steps: the number is void; "
                           "raise BENCH_COMPACT/BENCH_ROUNDS")
    value = statistics.median(rates)
    print(f"# {len(outs)} steps of {s.batch} in {s.windows} windows; per window: "
          + ", ".join(f"{r:.1f}" for r in rates) + f" syndromes/s; median step "
          f"{statistics.median(step_ms):.3f} ms on {name}", file=sys.stderr)
    print(json.dumps({
        "metric": METRIC,
        "value": round(value, 1),
        "unit": "syndromes/s",
        "vs_baseline": round(value / BASELINE_SYNDROMES_PER_S, 2),
    }))
    return value


if __name__ == "__main__":
    main()
