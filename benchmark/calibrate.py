"""Readings that the check's limits are set from, on the card, in one
process: the compared numbers of the program as it is over many seeds (the
lower readings), of the program's lower-precision path or the reference in
a lower precision (the control) and of planted faults (the upper readings).

    python3 -m benchmark.calibrate --workload n1270_nG5.mc_p05 --seeds 1 2 3 --control bf16
    python3 -m benchmark.calibrate --workload n882_nG3.train_b100 --seeds 1 2 3 \\
        --control tf32 --faults half_batch altered_loss    # once BENCHMARK.json holds the cell

Each reading is the ``readings(r, fault=None, control=None)`` of the
cell's traffic kind, found by name as ``benchmark.run`` finds its ``run``:
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
from .run import find_kind, load_run

__all__ = ["main", "readings"]


def readings(workload, seeds, control=None, faults=(), control_seeds=3, manifest=None):
    """One dict a reading: the program on every seed, then the control and
    each fault on the first ``control_seeds`` seeds."""
    manifest = manifest or load_json("BENCHMARK.json")
    modes = [("program", None)] + ([("control", control)] if control else []) + [("fault", f) for f in faults]
    for i, seed in enumerate(seeds):
        for mode, what in modes:
            if mode != "program" and i >= control_seeds:
                continue
            t0 = time.perf_counter()
            r = load_run(workload, seed, 0.0, False, t_start=t0, manifest=manifest)
            got = find_kind(r.traffic["kind"]).readings(r, fault=what if mode == "fault" else None,
                                                        control=what if mode == "control" else None)
            yield {"seed": seed, "mode": mode, "what": what, "s": round(time.perf_counter() - t0, 2), **got}


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
    for line in readings(args.workload, args.seeds, args.control, args.faults, args.control_seeds, manifest):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
