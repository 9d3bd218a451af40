"""Time the probe kernels on the card, one JSON line.

    python tools/time_probe_kernels.py TAG

Run from the root of a checkout (it imports that checkout's
feedback_gnn_tpu_torch and chip_smoke.py), so that two checkouts can be
timed in turns on one card in one session: parent, change, change, parent.
Each probe is first held bit for bit against its plain version, then timed
as chip_smoke.py times it (a CUDA graph of 200 calls): the single passes,
the loops at 64 and at 2 iterations (their time an iteration, and the rest
of the call), k6 on the identity permutation, and the launch floor
(take_rows on [1, 1]).  Where the checkout's loops take a launch plan with
a cluster, also the loop kernel with no iteration (its load and store
alone), and on one row (its launch and cluster barriers alone).  The three
phi forms (k5, kc, kd), accurate and fast, at the probe shape [3840, 128]
and at a throughput shape [3840, 8192] (PHI_WIDE, neither launch-bound nor
held in L2), the accurate output held to its plain version within PHI_TOL
and hashed, so that two checkouts show whether they give the same bits.
Prints "TIMES TAG {...}" in microseconds (the keys ending in /ps in
picoseconds an element), then "HASHES TAG {...}".
"""

import ctypes
import hashlib
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())  # the checkout this runs from, not tools/
import chip_smoke  # noqa: E402
from feedback_gnn_tpu_torch import probes  # noqa: E402

REPS = 200
PHI_WIDE, WIDE_REPS = (3840, 128 * 64), 20


def us(fn):
    return chip_smoke.graph_ms(fn, REPS) * 1e3


def loop_alone(x, idx, plan):
    """The gather loop kernel with no iteration, by ``plan``: a thunk."""
    from feedback_gnn_tpu_torch._build import load_kernels

    lib, out = load_kernels(), torch.empty_like(x)

    def go():
        err = lib.fgt_probe_gather_launch(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), *x.shape, 0, 0, 0, ctypes.c_float(1.0), 0,
            plan.rows_per_thread, plan.cluster, plan.threads, plan.blocks, 1, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"loop launch failed: {err}")

    go()
    torch.cuda.synchronize()
    if not torch.equal(out, x):
        raise AssertionError("the loop with no iteration is not a copy")
    return go


def main(tag):
    cases = {p.key: p for p in probes.probe_cases(probes.probe_inputs("cuda"))}
    res = {}
    for key in ["k1", "k2", "k2b", "k3", "k4", "k6", "ka", "kb", "ke", "kf"]:
        p = cases[key]
        out, ref = p.fn(*p.args), p.plain(*p.args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{key} disagrees with its plain version")
        res[key] = us(lambda: p.fn(*p.args))
        if p.iters > 1:
            res[key + "@2"] = us(lambda: p.fn(*p.args, iters=2))
    x, perm = cases["k6"].args
    ident = torch.arange(x.shape[0], dtype=torch.int32, device="cuda")
    res["k6id"] = us(lambda: probes.gather_loop(x, ident))
    res["k6id@2"] = us(lambda: probes.gather_loop(x, ident, iters=2))
    for k in ["k6", "ke", "kf", "k6id"]:
        res[k + "/it"] = (res[k] - res[k + "@2"]) / (probes.LOOP_ITERS - 2)
        res[k + "/fixed"] = res[k] - probes.LOOP_ITERS * res[k + "/it"]
    one, zero = torch.ones((1, 1), device="cuda"), torch.zeros(1, dtype=torch.int32, device="cuda")
    res["floor"] = us(lambda: probes.take_rows(one, zero))
    if hasattr(probes, "LoopPlan") and "cluster" in probes.LoopPlan.__dataclass_fields__:
        plan = probes._loop_plan(*x.shape)
        res["loop0"] = us(loop_alone(x, perm, plan))
        row = x[:1].contiguous()
        res["loop0_one_row"] = us(loop_alone(row, perm[:1].contiguous(),
                                             probes.LoopPlan(plan.cluster, plan.blocks, plan.threads,
                                                             plan.rows_per_thread, plan.smem_bytes)))
    hashes = {}
    wide = torch.randn(PHI_WIDE, generator=torch.Generator(device="cuda").manual_seed(13), device="cuda")
    for key in ["k5", "kc", "kd"]:
        p = cases[key]
        for shape, x, reps in (("", p.args[0], REPS), ("@wide", wide, WIDE_REPS)):
            out = p.fn(x)
            probes.compare(p, out, p.plain(x))
            hashes[key + shape] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
            res[key + shape] = chip_smoke.graph_ms(lambda: p.fn(x), reps) * 1e3
            res[key + shape + "/fast"] = chip_smoke.graph_ms(lambda: p.fn(x, fast=True), reps) * 1e3
            torch.cuda.empty_cache()
        res[key + "@wide/ps"] = res[key + "@wide"] * 1e6 / wide.numel()  # picoseconds an element
        res[key + "@wide/fast/ps"] = res[key + "@wide/fast"] * 1e6 / wide.numel()
    print("TIMES", tag, json.dumps({k: round(v, 4) for k, v in res.items()}), flush=True)
    print("HASHES", tag, json.dumps(hashes), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
