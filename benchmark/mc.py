"""Monte-Carlo traffic: the program's LER sweep loop over its cascade step,
as users' evaluation runs drive it, and the check of what it produced.

The mix's file gives the depolarizing strength ``p``, the batch, and the
cascade's prepass and compaction capacities at that strength.  The window
is one call of the program's ``sim_ler`` (one generator reseed and one
host read of the counts a batch, no stopping rule) over as many batches as
fill ``--seconds`` at the warm-up's pace; its rate is every syndrome the
call reports decoded over its whole wall time, ended by a synchronize, and
a call that reports another count than it was asked for, or another number
of steps than it ran, is not correct.

Wrappers around the program's public entries record what the timed path
does: each K1 decode's shape (for the roofline and the operation counts),
each GNN step's and GF(2) product's batch, and, in the batches drawn from
the seed for the check, the sampled noise, every decode's inputs and
outputs, and the counts the step returned.  The check runs once the window
has closed and the peak memory is read (reference/cascade.py).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from . import counts
from .harness import Check, Outcome, ROOT, Run, peak_memory, synchronize
from .trace import Tracer

__all__ = ["KIND", "run", "readings", "Recorder"]

KIND = "mc"
WARMUP_BATCHES = 2


class Recorder:
    """Wraps the program's K1 entry, channel sampler, GNN step and GF(2)
    product; ``batch`` is the index of the batch in progress."""

    def __init__(self):
        self.batch = -1
        self.capture = set()
        self.captured = {}
        self.k1 = {}
        self.gnn = {}
        self.gf2 = {}
        self.tracer = None
        self._undo = []

    def reset(self, capture, tracer):
        """Start the window: batch indices from 0, these captured, and the
        tracer stepped at each batch's start."""
        self.batch = -1
        self.tracer = tracer
        self.capture = set(capture)
        self.captured, self.k1, self.gnn, self.gf2 = {}, {}, {}, {}

    def _patch(self, module, name, fn):
        self._undo.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def install(self, nnz_by_ptr):
        from feedback_gnn_tpu_torch.decoders import bp4_qc, cascade

        orig_k1, orig_noise = bp4_qc.bp4_qc_marginals, cascade.pauli_iid
        orig_gnn, orig_gf2 = cascade.feedback_gnn_apply, cascade.mod2_matmul

        def k1(qc, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type="boxplus-phi",
               normalization_factor=1.0, msg_dtype="float32", phi_impl=None):
            out = orig_k1(qc, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type, normalization_factor,
                          msg_dtype=msg_dtype, phi_impl=phi_impl)
            rec = dict(batch=int(llr_ch.shape[-1]), iters=int(num_iter), cn_type=cn_type,
                       phi_impl=phi_impl, msg_dtype=msg_dtype)
            self.k1.setdefault(self.batch, []).append(rec)
            if self.batch in self.capture:
                self.captured[self.batch]["launches"].append(
                    dict(rec, llr=llr_ch, sx=syndrome_x, sz=syndrome_z, out=out))
            return out

        def noise(generator, px, py, pz, n, batch):
            out = orig_noise(generator, px, py, pz, n, batch)
            if self.batch in self.capture:
                self.captured[self.batch]["noise"] = out
            return out

        def gnn(params, graph, h_vn, *args, **kw):
            self.gnn.setdefault(self.batch, []).append(int(h_vn.shape[-1]))
            return orig_gnn(params, graph, h_vn, *args, **kw)

        def gf2(h, v):
            self.gf2.setdefault(self.batch, []).append((nnz_by_ptr.get(h.data_ptr(), 0), int(v.shape[-1])))
            return orig_gf2(h, v)

        self._patch(bp4_qc, "bp4_qc_marginals", k1)
        self._patch(cascade, "pauli_iid", noise)
        self._patch(cascade, "feedback_gnn_apply", gnn)
        self._patch(cascade, "mod2_matmul", gf2)

    def uninstall(self):
        while self._undo:
            module, name, fn = self._undo.pop()
            setattr(module, name, fn)

    def wrap(self, step):
        def wrapped(generator, p):
            self.batch += 1
            if self.tracer is not None:
                self.tracer.step()
            if self.batch in self.capture:
                self.captured[self.batch] = {"launches": []}
            out = step(generator, p)
            if self.batch in self.capture:
                self.captured[self.batch]["counts"] = out
            return out

        return wrapped


def _cascade_settings(config, traffic):
    c = dict(config["cascade"])
    c.update(stage1_prepass=traffic.get("stage1_prepass"), compact_fraction=traffic.get("compact_fraction"),
             round_fraction=traffic.get("round_fraction"))
    return c


def run(r: Run) -> Outcome:
    from feedback_gnn_tpu_torch import resolve_device
    from feedback_gnn_tpu_torch.codes import QuantumGraph, qc_pair_from_code
    from feedback_gnn_tpu_torch.config import build_code
    from feedback_gnn_tpu_torch.decoders.cascade import CascadeConfig, sandwich_eval_step
    from feedback_gnn_tpu_torch.decoders.gnn_feedback import load_weights
    from feedback_gnn_tpu_torch.sim.montecarlo import sim_ler

    dev, traffic = resolve_device(str(r.device)), r.traffic
    batch = r.batch or int(traffic["batch"])
    p = float(np.asarray([traffic["p"]], np.float64)[0])
    s = _cascade_settings(r.config, traffic)
    cfg = CascadeConfig(
        num_iter1=s["num_iter1"], num_iter2=s["num_iter2"], factor1=s["factor"], factor2=s["factor"],
        cn_type=s["cn_type"], num_rounds=s["num_rounds"], p0=s["p0"], qc_batch_tile=s["tile"],
        qc_msg_dtype="bfloat16" if r.control == "bf16" else s["msg_dtype"],
        compact_fraction=s["compact_fraction"], stage1_prepass=s["stage1_prepass"],
        round_fraction=s["round_fraction"])
    weights = os.path.join(ROOT, r.config["weights"])

    pcode = build_code(r.config["port_code"])
    graph = QuantumGraph.from_code(pcode, stage_mode=True).to(dev)
    qc = qc_pair_from_code(pcode)
    if qc is None:
        raise ValueError(f"{r.config['port_code']} has no block-circulant structure for K1")
    params = load_weights(weights, dev)
    nnz = {t.data_ptr(): int((t != 0).sum()) for t in (graph.hx, graph.hz, graph.hx_perp, graph.hz_perp)}

    def step(generator, pp):
        return sandwich_eval_step(graph, [params], cfg, generator, pp, batch, qc=qc, return_overflow=True)

    trace_skip, trace_steps = int(traffic["trace_skip"]), int(traffic["trace_steps"])
    tracer = Tracer(r.trace, trace_skip, trace_steps)
    rec = Recorder()
    rec.install(nnz)
    try:
        wrapped = rec.wrap(step)
        gen = torch.Generator(device=dev)
        for i in range(WARMUP_BATCHES):
            gen.manual_seed(2**63 + i)  # seeds a sweep never draws
            t_b = time.perf_counter()
            int(wrapped(gen, p)[0])
            synchronize(dev)
            t_batch = time.perf_counter() - t_b
        k = int(traffic["check_batches"])
        least = max(k, trace_skip + trace_steps + 2 if r.trace else 1)
        nbatches = max(least, int(round(r.seconds / max(t_batch, 1e-6))))
        picked = np.random.default_rng([r.seed, 1]).choice(nbatches, size=k, replace=False)
        rec.reset(sorted(int(i) for i in picked), tracer)
        synchronize(dev)

        t0 = time.perf_counter()
        setup_s = t0 - r.t_start
        with tracer:
            res = sim_ler(wrapped, [p], batch, nbatches, num_target_block_errors=None, early_stop=False,
                          seed=r.seed, verbose=False, device=dev)
        synchronize(dev)
        window = time.perf_counter() - t0
    finally:
        rec.uninstall()
    mem = peak_memory(dev)
    overflow = int(res.overflow[0])
    # the rate counts what the loop reports it decoded; a loop that skips
    # batches or stops early, or reports more than its steps ran, is wrong
    decoded, stepped = int(res.num_blocks[0]), rec.batch + 1
    short = int(decoded != nbatches * batch) + int(stepped != nbatches)
    notes = [f"{nbatches} batches of {batch} in {window:.3f} s; flagged {int(res.flagged_errors[0])}, "
             f"logical {int(res.logical_errors[0])}, overflow {overflow}; checked batches {sorted(rec.captured)}; "
             f"decoded {decoded} syndromes in {stepped} steps"]
    last = nbatches - 1
    launches, gnn_batches, gf2 = rec.k1.get(last, []), rec.gnn.get(last, []), rec.gf2.get(last, [])
    del graph, params, qc, step, wrapped, res

    from .reference import cascade as ref_cascade
    from .reference.codes import build_code as ref_build_code
    from .reference.gnn_bp import graph_on, load_gnn

    code = ref_build_code(r.config["code"])
    ref = ref_cascade.make_ref(code, graph_on(code, dev), load_gnn(weights, dev), dev)
    worst = {"mismatches": short, "llr_gap": 0.0}
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, cap in sorted(rec.captured.items()):
        try:
            got = ref_cascade.check_batch(ref, s, p, batch, ref_cascade.batch_seed(r.seed, i), cap)
        except (RuntimeError, ValueError, IndexError, KeyError) as e:
            got = {"mismatches": 1, "llr_gap": 0.0, "notes": [f"check failed: {e!r}"]}
        worst["mismatches"] += got["mismatches"]
        worst["llr_gap"] = max(worst["llr_gap"], got["llr_gap"])
        notes += [f"batch {i}: {x}" for x in got["notes"][:20]]
    nums = dict(worst, overflow=overflow, batches_unchecked=max(0, k - len(rec.captured)))
    checks = [Check(name, nums[name], limit) for name, limit in r.limits.items()]

    hidden = int(r.config["gnn"]["hidden"])
    msg_dims = int(r.config["gnn"]["msg_dims"])
    ops_k1 = sum(counts.k1_ops(code.qx, code.qz, x["batch"], x["iters"], x["cn_type"], x["phi_impl"],
                               x["msg_dtype"]) for x in launches)
    bound_k1 = sum(counts.k1_bound_ms(code.qx, code.qz, x["batch"], x["iters"], x["cn_type"], x["phi_impl"],
                                      x["msg_dtype"])[0] for x in launches)
    ops_gnn = sum(counts.gnn_ops(code.n, code.qx.num_edges, code.qz.num_edges, hidden, msg_dims,
                                 int(r.config["gnn"]["mlp_layers"]) - 1, b) for b in gnn_batches)
    ops_gf2 = sum(counts.gf2_ops(z, b) for z, b in gf2)
    context = dict(kind=KIND, loop="eval", k1_bound_ms=bound_k1,
                   ops={"k1": ops_k1, "gnn": ops_gnn, "gf2": ops_gf2}, k1_launches=len(launches))
    metrics = {"syndromes_per_s": decoded / window, "setup_s": setup_s}
    return Outcome(metrics, decoded, overflow, checks, mem, tracer.data, context, notes)


def readings(r: Run, fault: str | None = None, control: str | None = None) -> dict:
    """The compared numbers of the checked batches with no window around
    them (calibration), and three lines of the notes: the program as it is,
    or (``control`` "bf16") with its bfloat16 carry.  This kind plants no
    fault here; the tests plant them (benchmark/tests/test_bench_check.py)."""
    if fault is not None or control not in (None, "bf16"):
        raise ValueError(f"the mc kind reads no fault and no control but bf16 (fault {fault!r}, "
                         f"control {control!r})")
    out = run(dataclasses.replace(r, control=control))
    return {c.name: c.value for c in out.checks} | {"notes": out.notes[1:4]}
