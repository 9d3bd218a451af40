"""BP4 + OSD-0 traffic: the program's LER sweep loop over its BP4 + OSD-0
step, as evaluators of the BP+OSD baseline drive it (``cli/osd_eval.py
--mode bp4-osd``), and the check of what it produced.

The configuration gives the decoder (BP4 iterations, CN rule, factor,
message carry); the mix's file the depolarizing strength ``p``, the batch
and the OSD sub-batch's capacity ``osd_cap``.  BP decodes on the program's
fused QC decode (K1 on the card).  The window is one call of the program's
``sim_ler`` over as many batches as fill ``--seconds`` at the warm-up's
pace, with the rate and the loop's checks of the mc kind (mc.py).

Wrappers around the program's entries record what the timed path does:
each K1 decode's shape, each GF(2) product's batch, and, in the batches
drawn from the seed for the check, the sampled noise, the decode's input
and marginals, the OSD sub-batch (flags, indices, validity), both
eliminations' inputs and solutions, and the counts the step returned.  The
check runs once the window has closed and the peak memory is read
(reference/osd.py); its eliminations also count the operations of OSD-0's
least form, which osd_counts.py charges the flagged samples decoded.

``readings`` (calibrate.py) reads the program as it is, its bfloat16 carry
(control ``bf16``) and the fault ``unstable_sort`` (OSD's columns sorted
with ties in reverse column order, as a sort that is not stable may leave
them).
"""

from __future__ import annotations

import dataclasses
import inspect
import time

import numpy as np
import torch

from . import counts, osd_counts
from .harness import Check, Outcome, Run, peak_memory, synchronize
from .trace import Tracer

__all__ = ["KIND", "FAULTS", "run", "readings", "Recorder", "plant_fault"]

KIND = "osd"
WARMUP_BATCHES = 2
FAULTS = ("unstable_sort",)


class Recorder:
    """Wraps the program's K1 entry, channel sampler, GF(2) products, the
    OSD sub-batch's selection and OSD-0; ``batch`` is the index of the
    batch in progress."""

    def __init__(self):
        self.batch = -1
        self.capture = set()
        self.captured = {}
        self.k1 = {}
        self.gf2 = {}
        self.tracer = None
        self._undo = []

    def reset(self, capture, tracer):
        self.batch = -1
        self.tracer = tracer
        self.capture = set(capture)
        self.captured, self.k1, self.gf2 = {}, {}, {}

    def _patch(self, module, name, fn):
        self._undo.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def _cap(self):
        return self.captured[self.batch] if self.batch in self.capture else None

    def install(self, nnz_by_ptr):
        from feedback_gnn_tpu_torch import models
        from feedback_gnn_tpu_torch.decoders import bp4_qc
        from feedback_gnn_tpu_torch.decoders import osd as osd_mod

        orig_k1, orig_noise = bp4_qc.bp4_qc_marginals, models.pauli_iid
        orig_first, orig_osd = osd_mod._flagged_first, osd_mod.osd0_decode

        def k1(qc, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type="boxplus-phi",
               normalization_factor=1.0, msg_dtype="float32", phi_impl=None):
            out = orig_k1(qc, llr_ch, syndrome_x, syndrome_z, num_iter, cn_type, normalization_factor,
                          msg_dtype=msg_dtype, phi_impl=phi_impl)
            rec = dict(batch=int(llr_ch.shape[-1]), iters=int(num_iter), cn_type=cn_type,
                       phi_impl=phi_impl, msg_dtype=msg_dtype)
            self.k1.setdefault(self.batch, []).append(rec)
            cap = self._cap()
            if cap is not None:
                cap["launches"].append(dict(rec, llr=llr_ch, sx=syndrome_x, sz=syndrome_z, out=out))
            return out

        def noise(generator, px, py, pz, n, batch):
            out = orig_noise(generator, px, py, pz, n, batch)
            cap = self._cap()
            if cap is not None:
                cap["noise"] = out
            return out

        def first(flags, cap_size):
            idx, valid = orig_first(flags, cap_size)
            cap = self._cap()
            if cap is not None:
                cap["flagged_first"] = (flags, idx, valid)
            return idx, valid

        def osd0(llr, pcm, syndrome):
            out = orig_osd(llr, pcm, syndrome)
            cap = self._cap()
            if cap is not None:
                cap["osd"].append(dict(llr=llr, syndrome=syndrome, out=out))
            return out

        def gf2_for(orig):
            def gf2(h, v):
                self.gf2.setdefault(self.batch, []).append((nnz_by_ptr.get(h.data_ptr(), 0), int(v.shape[-1])))
                return orig(h, v)
            return gf2

        self._patch(bp4_qc, "bp4_qc_marginals", k1)
        self._patch(models, "pauli_iid", noise)
        self._patch(osd_mod, "_flagged_first", first)
        self._patch(osd_mod, "osd0_decode", osd0)
        self._patch(models, "mod2_matmul", gf2_for(models.mod2_matmul))
        self._patch(osd_mod, "mod2_matmul", gf2_for(osd_mod.mod2_matmul))

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
                self.captured[self.batch] = {"launches": [], "osd": []}
            out = step(generator, p)
            if self.batch in self.capture:
                self.captured[self.batch]["counts"] = out
            return out

        return wrapped


def plant_fault(fault):
    """Plant a fault in the program's OSD; returns its undo."""
    from feedback_gnn_tpu_torch.decoders import osd as osd_mod

    if fault != "unstable_sort":
        raise ValueError(f"the osd kind plants no fault {fault!r} (it knows {', '.join(FAULTS)})")
    orig = osd_mod.osd0_decode

    def reversed_ties(llr, pcm, syndrome):
        # the columns reversed, sorted stably, and turned back: ties in reverse column order
        pcm = torch.as_tensor(pcm, device=llr.device)
        return orig(llr.flip(-1), pcm.flip(-1), syndrome).flip(-1)

    osd_mod.osd0_decode = reversed_ties
    return lambda: setattr(osd_mod, "osd0_decode", orig)


def _supported():
    """Whether the program's BP4 + OSD-0 step can decode on the fused QC
    decode (its ``qc`` argument)."""
    from feedback_gnn_tpu_torch import models

    return "qc" in inspect.signature(models.bp4_osd_eval_step).parameters


def run(r: Run) -> Outcome:
    if not _supported():
        raise RuntimeError("this program's bp4_osd_eval_step takes no qc: it cannot decode BP4 + OSD-0 on K1")
    from feedback_gnn_tpu_torch import models, resolve_device
    from feedback_gnn_tpu_torch.codes import QuantumGraph, qc_pair_from_code
    from feedback_gnn_tpu_torch.config import build_code
    from feedback_gnn_tpu_torch.sim.montecarlo import sim_ler

    dev, traffic, dec = resolve_device(str(r.device)), r.traffic, r.config["decoder"]
    batch = r.batch or int(traffic["batch"])
    cap = min(batch, int(traffic["osd_cap"]))
    p = float(np.asarray([traffic["p"]], np.float64)[0])
    iters, cn_type, factor = int(dec["num_iter"]), dec["cn_type"], float(dec["factor"])
    msg_dtype = "bfloat16" if r.control == "bf16" else dec["msg_dtype"]

    pcode = build_code(r.config["port_code"])
    graph = QuantumGraph.from_code(pcode, stage_mode=True).to(dev)
    qc = qc_pair_from_code(pcode)
    if qc is None:
        raise ValueError(f"{r.config['port_code']} has no block-circulant structure for K1")
    nnz = {t.data_ptr(): int((t != 0).sum()) for t in (graph.hx, graph.hz, graph.lx, graph.lz)}

    def step(generator, pp):
        return models.bp4_osd_eval_step(graph, pcode, generator, pp, batch, num_iter=iters, cn_type=cn_type,
                                        normalization_factor=factor, osd_compact_cap=cap, qc=qc,
                                        msg_dtype=msg_dtype)

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
    decoded, stepped = int(res.num_blocks[0]), rec.batch + 1
    short = int(decoded != nbatches * batch) + int(stepped != nbatches)
    notes = [f"{nbatches} batches of {batch} in {window:.3f} s; flagged {int(res.flagged_errors[0])}, "
             f"logical {int(res.logical_errors[0])}, overflow {overflow}; checked batches {sorted(rec.captured)}; "
             f"decoded {decoded} syndromes in {stepped} steps"]
    last = nbatches - 1
    launches, gf2 = rec.k1.get(last, []), rec.gf2.get(last, [])
    del graph, qc, step, wrapped, res

    from .reference import cascade as ref_cascade
    from .reference import osd as ref_osd
    from .reference.codes import build_code as ref_build_code

    code = ref_build_code(r.config["code"])
    ref = ref_osd.make_ref(code, dev)
    worst = {"mismatches": short, "llr_gap": 0.0}
    osd_decoded = osd_ops = 0
    for i, capd in sorted(rec.captured.items()):
        try:
            got = ref_osd.check_batch(ref, dec, p, batch, cap, ref_cascade.batch_seed(r.seed, i), capd)
        except (RuntimeError, ValueError, IndexError, KeyError) as e:
            got = {"mismatches": 1, "llr_gap": 0.0, "notes": [f"check failed: {e!r}"]}
        worst["mismatches"] += got["mismatches"]
        worst["llr_gap"] = max(worst["llr_gap"], got["llr_gap"])
        osd_decoded += got.get("osd_decoded", 0)
        osd_ops += got.get("osd_ops", 0)
        notes += [f"batch {i}: {x}" for x in got["notes"][:20]]
    nums = dict(worst, overflow=overflow, batches_unchecked=max(0, k - len(rec.captured)))
    checks = [Check(name, nums[name], limit) for name, limit in r.limits.items()]

    bound_k1 = sum(counts.k1_bound_ms(code.qx, code.qz, x["batch"], x["iters"], x["cn_type"], x["phi_impl"],
                                      x["msg_dtype"])[0] for x in launches)
    ops_gf2 = sum(counts.gf2_ops(z, b) for z, b in gf2)
    context = dict(kind=KIND, loop="eval", k1_bound_ms=bound_k1, k1_launches=len(launches),
                   gf2_bound_ms=osd_counts.gf2_bound_ms(ops_gf2), osd_ranks=(len(ref.piv_x), len(ref.piv_z)),
                   n=code.n, osd_ops_per_sample=osd_ops / osd_decoded if osd_decoded else None)
    if osd_decoded:
        notes[0] += (f"; OSD-0's least form: {osd_ops / osd_decoded:.1f} integer operations a decoded sample "
                     f"(both sides) over the {osd_decoded} samples checked")
    metrics = {"syndromes_per_s": decoded / window, "setup_s": setup_s}
    return Outcome(metrics, decoded, overflow, checks, mem, tracer.data, context, notes)


def readings(r: Run, fault: str | None = None, control: str | None = None) -> dict:
    """The compared numbers of the checked batches with no window around
    them (calibration), and three lines of the notes: the program as it is,
    with its bfloat16 carry (``control`` "bf16"), or with a planted fault
    (``FAULTS``)."""
    if control not in (None, "bf16"):
        raise ValueError(f"the osd kind reads no control but bf16 (control {control!r})")
    undo = plant_fault(fault) if fault is not None else (lambda: None)
    try:
        out = run(dataclasses.replace(r, control=control))
    finally:
        undo()
    return {c.name: c.value for c in out.checks} | {"notes": out.notes[1:4]}
