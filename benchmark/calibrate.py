"""Readings that the check's limits are set from, on the card, in one
process: the compared numbers of the program as it is over many seeds (the
lower readings), of the program's lower-precision path or the reference in
a lower precision (the control) and of planted faults (the upper readings).

    python3 -m benchmark.calibrate --workload n1270_nG5.mc_p05 --seeds 1 2 3 --control bf16
    python3 -m benchmark.calibrate --workload n882_nG3.train_b100 --seeds 1 2 3 \\
        --control tf32 --faults half_batch altered_loss    # once BENCHMARK.json holds the cell

Monte-Carlo cells read the batches a run checks (``check_batches`` of the
mix) with no window around them; training cells the set-up's steps.  One
JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .harness import load_json

__all__ = ["main"]


def _mc(workload, seed, control):
    from .run import run_cell

    _, out = run_cell(workload, seed, 1e-6, False, control=control, t_start=time.perf_counter())
    return {c.name: c.value for c in out.checks} | {"notes": out.notes[1:4]}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3, help="how many of the seeds the control and faults read")
    ap.add_argument("--control", default=None)
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    manifest = load_json("BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    kind = load_json(f"benchmark/traffic/{cell['traffic']}.json")["kind"]
    modes = [("program", None)] + ([("control", args.control)] if args.control else []) \
        + [("fault", f) for f in args.faults]
    for i, seed in enumerate(args.seeds):
        for mode, what in modes:
            if mode != "program" and i >= args.control_seeds:
                continue
            t0 = time.perf_counter()
            if kind == "mc":
                got = _mc(args.workload, seed, what)
            else:
                from . import train
                from .run import load_run

                r = load_run(args.workload, seed, 0.0, False, t_start=time.perf_counter(), manifest=manifest)
                got = train.readings(r, fault=what if mode == "fault" else None,
                                     control=what if mode == "control" else None)
            print(json.dumps({"seed": seed, "mode": mode, "what": what, "s": round(time.perf_counter() - t0, 2),
                              **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
