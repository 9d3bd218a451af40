"""Gather BP4 traffic: the program's LER sweep loop over its plain BP4 step
on a code the fused QC decode cannot take, as evaluators of BP4 on
Panteleev and Kalachev's overcomplete check matrices drive it
(``cli/osd_eval.py --code <port_code> --mode bp4``), and the check of what
it produced.

The configuration gives the code (a reference family, reference/codes.py),
its name in the CLI's code table (``port_code``) and the decoder's
schedule; the mix's file the depolarizing strength ``p`` and the batch.
The step is the one the CLI mode builds (``osd_eval.make_step``): noise,
syndromes, the gather BP4 decode (``decoders/bp4.py`` ``bp4_decode``) of
every sample for the configured iterations, no early stop, and the counts.
The window is one call of the program's ``sim_ler`` over as many batches
as fill ``--seconds`` at the warm-up's pace, with the rate and the loop's
checks of the mc kind (mc.py).

Wrappers around the program's entries record what the timed path does:
each decode's batch and iterations, each GF(2) product's batch, and, in the
batches drawn from the seed for the check, the sampled noise, the
decode's syndromes, input LLRs, last marginals and decisions, its count of
VN and CN updates, the counts the step returned, and on ``check_samples``
samples the messages into and out of the VN and CN updates of the
iterations drawn from the seed (the first, the second, one more and the
last; ``bp4._vn_update`` and ``bp4.cn_update_phi``), read into the
reference's edge lists as they are made.  What the capture can compare at
once it counts on the device without a host sync (nonzero pad slots, a CN
update's input other than the VN update's output, a VN update's input
other than the last CN update's output) and keeps only the count, so that
two batches' capture stays near 2 GB.  The check runs once the window has
closed and the peak memory is read (reference/gather_bp4.py).

``readings`` (calibrate.py) reads the program as it is, under the control
``bf16`` (each CN output rounded to bfloat16 where it is carried) or with a
planted fault (``FAULTS``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import counts, gather_bp4_counts, osd_counts
from .harness import Check, Outcome, Run, peak_memory, synchronize
from .trace import Tracer

__all__ = ["KIND", "FAULTS", "CONTROLS", "run", "readings", "Recorder", "plant_fault", "apply_control"]

KIND = "gather_bp4"
WARMUP_BATCHES = 2
FAULTS = ("pad_slot_leak", "syndrome_sign_dropped", "iteration_left_out")
CONTROLS = ("bf16",)


class Recorder:
    """Wraps the program's channel sampler, gather BP4 decode, its VN and
    CN updates and the GF(2) products; ``batch`` is the index of the batch
    in progress, ``sides`` the reference's edge lists on the device."""

    def __init__(self, sides, n):
        self.sides, self.n = sides, n
        self.batch = -1
        self.capture, self.captured, self.decodes, self.gf2, self.nnz = {}, {}, {}, {}, {}
        self.calls = [0, 0, 0]  # VN updates, CN updates of hx and of hz, in the decode in progress
        self.tracer = None
        self._undo = []

    def reset(self, capture, tracer):
        """Start the window: batch indices from 0, and of batch i the samples
        and iterations ``capture[i] = (cols, iterations)`` captured."""
        self.batch = -1
        self.tracer = tracer
        self.capture = dict(capture)
        self.captured, self.decodes, self.gf2 = {}, {}, {}

    def _patch(self, module, name, fn):
        self._undo.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def _cap(self):
        return self.captured[self.batch] if self.batch in self.capture else None

    def _vn(self, cap, it, msg_in, out):
        cols, n = cap["cols"], self.n
        rec = cap["iters"].setdefault(it, {"vn_in": None})
        prev = cap["iters"].get(it - 1, {}).get("cn_out")
        for k, m_in, m_out in zip("xz", msg_in, out[:2]):
            side = self.sides[k]
            m_in = m_in[..., cols]
            cap["exact"].append((f"VN update {it} side {k}: nonzero pad slots in", side.pads_set(m_in, "vn")))
            e_in = side.from_vn_frame(m_in)
            if it == 0:
                cap["exact"].append((f"VN update 0 side {k}: nonzero messages in", (e_in != 0).sum()))
            elif prev is not None:
                cap["exact"].append((f"VN update {it} side {k}: input other than CN update {it - 1}'s output",
                                     (e_in != prev[k]).sum()))
            else:
                rec["vn_in"] = dict(rec["vn_in"] or {}, **{k: e_in})
            rec.setdefault("vn_out", {})[k] = side.from_vn_frame(m_out[..., cols])
        rec["marg"] = tuple(v[:n, cols] for v in out[2:5])

    def _cn(self, cap, it, k, msg_in, out):
        cols, side = cap["cols"], self.sides[k]
        rec = cap["iters"][it]
        m_in, m_out = msg_in[..., cols], out[..., cols]
        cap["exact"] += [(f"CN update {it} side {k}: nonzero pad slots in", side.pads_set(m_in, "cn")),
                         (f"CN update {it} side {k}: nonzero pad slots out", side.pads_set(m_out, "cn")),
                         (f"CN update {it} side {k}: input other than the VN update's output",
                          (side.from_cn_frame(m_in) != rec["vn_out"][k]).sum())]
        rec.setdefault("cn_out", {})[k] = side.from_cn_frame(m_out)

    def install(self):
        from feedback_gnn_tpu_torch import models
        from feedback_gnn_tpu_torch.decoders import bp4

        orig_noise, orig_decode, orig_gf2 = models.pauli_iid, models.bp4_decode, models.mod2_matmul
        orig_vn, orig_cn = bp4._vn_update, bp4.cn_update_phi

        def noise(generator, px, py, pz, n, batch):
            out = orig_noise(generator, px, py, pz, n, batch)
            cap = self._cap()
            if cap is not None:
                cap["noise"] = out
            return out

        def decode(graph, llr_ch, syndrome_x, syndrome_z, num_iter, *args, **kw):
            self.decodes.setdefault(self.batch, []).append(dict(batch=int(llr_ch.shape[-1]), iters=int(num_iter)))
            self.calls = [0, 0, 0]
            out = orig_decode(graph, llr_ch, syndrome_x, syndrome_z, num_iter, *args, **kw)
            cap = self._cap()
            if cap is not None:
                cap.update(syndromes=(syndrome_x, syndrome_z), llr=llr_ch, final=(out.llrx, out.llry, out.llrz),
                           decisions=(out.x_hat, out.z_hat), updates=tuple(self.calls))
            return out

        def vn_update(msg_x, msg_z, llr_ch, graph, axis=None):
            it = self.calls[0]
            self.calls[0] += 1
            out = orig_vn(msg_x, msg_z, llr_ch, graph, axis)
            cap = self._cap()
            if cap is not None and it in cap["at"]:
                self._vn(cap, it, (msg_x, msg_z), out)
            return out

        def cn_update(msg_cn, syndrome_pm, mask, phi_impl=None):
            k = "xz"[(self.calls[1] + self.calls[2]) % 2]  # each iteration updates hx's checks, then hz's
            it = self.calls[1 + "xz".index(k)]
            self.calls[1 + "xz".index(k)] += 1
            out = orig_cn(msg_cn, syndrome_pm, mask, phi_impl)
            cap = self._cap()
            if cap is not None and it in cap["at"]:
                self._cn(cap, it, k, msg_cn, out)
            return out

        def gf2(h, v):
            key = h.data_ptr()
            if key not in self.nnz:  # seen first in the warm-up, outside the window
                self.nnz[key] = int((h != 0).sum())
            self.gf2.setdefault(self.batch, []).append((self.nnz[key], int(v.shape[-1])))
            return orig_gf2(h, v)

        self._patch(models, "pauli_iid", noise)
        self._patch(models, "bp4_decode", decode)
        self._patch(bp4, "_vn_update", vn_update)
        self._patch(bp4, "cn_update_phi", cn_update)
        self._patch(models, "mod2_matmul", gf2)

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
                cols, at = self.capture[self.batch]
                self.captured[self.batch] = {"cols": cols, "at": at, "iters": {}, "exact": []}
            out = step(generator, p)
            if self.batch in self.capture:
                self.captured[self.batch]["counts"] = out
            return out

        return wrapped


def plant_fault(fault):
    """Plant a fault in the program's gather BP4; returns its undo."""
    from feedback_gnn_tpu_torch import models
    from feedback_gnn_tpu_torch.decoders import bp4

    if fault == "pad_slot_leak":
        module, name = bp4, "scatter_from_cn"
        orig = bp4.scatter_from_cn

        def fn(msg_cn, graph):
            # each qubit's first pad slot holds its first message, which the VN sums then count
            out = orig(msg_cn, graph).clone()
            deg = graph.vn_deg[:graph.num_vn].to(torch.int64)
            v = torch.arange(graph.num_vn, device=out.device)[deg < graph.max_vn_deg]
            out[deg[v], v] = out[0, v]
            return out
    elif fault == "syndrome_sign_dropped":
        module, name = bp4, "cn_update_phi"
        orig = bp4.cn_update_phi

        def fn(msg_cn, syndrome_pm, mask, phi_impl=None):
            return orig(msg_cn, torch.ones_like(syndrome_pm), mask, phi_impl)
    elif fault == "iteration_left_out":
        module, name = models, "bp4_decode"
        orig = models.bp4_decode

        def fn(graph, llr_ch, syndrome_x, syndrome_z, num_iter, *args, **kw):
            return orig(graph, llr_ch, syndrome_x, syndrome_z, num_iter - 1, *args, **kw)
    else:
        raise ValueError(f"the gather_bp4 kind plants no fault {fault!r} (it knows {', '.join(FAULTS)})")
    setattr(module, name, fn)
    return lambda: setattr(module, name, orig)


def apply_control(control):
    """Round each CN output of the program to bfloat16 where it is carried
    (and widen it back to float32); returns the undo."""
    from feedback_gnn_tpu_torch.decoders import bp4

    if control not in CONTROLS:
        raise ValueError(f"the gather_bp4 kind reads no control {control!r} (it knows {', '.join(CONTROLS)})")
    orig = bp4.cn_update_phi

    def fn(msg_cn, syndrome_pm, mask, phi_impl=None):
        return orig(msg_cn, syndrome_pm, mask, phi_impl).to(torch.bfloat16).to(torch.float32)

    bp4.cn_update_phi = fn
    return lambda: setattr(bp4, "cn_update_phi", orig)


def _supported(port_code):
    """Whether the program's evaluation CLI offers the code ``port_code``."""
    from feedback_gnn_tpu_torch.cli import osd_eval

    code = next((a for a in osd_eval.make_parser()._actions if "--code" in a.option_strings), None)
    return code is not None and port_code in (code.choices or ())


def run(r: Run) -> Outcome:
    port_code = r.config["port_code"]
    if not _supported(port_code):
        raise RuntimeError(f"this program's cli/osd_eval.py has no --code {port_code}: it cannot run the gather "
                           "BP4 on the configured code through sim_ler")
    from feedback_gnn_tpu_torch import resolve_device
    from feedback_gnn_tpu_torch.cli import osd_eval
    from feedback_gnn_tpu_torch.sim.montecarlo import sim_ler

    from .reference import gather_bp4 as ref
    from .reference.cascade import batch_seed
    from .reference.codes import build_code as ref_build_code

    dev, traffic, dec = resolve_device(str(r.device)), r.traffic, r.config["decoder"]
    batch = r.batch or int(traffic["batch"])
    p = float(traffic["p"])
    iters = int(dec["num_iter"])
    args = osd_eval.make_parser().parse_args(["--code", port_code, "--mode", "bp4", "-bs", str(batch), "--iters",
                                              str(iters), "--cn-type", dec["cn_type"], "--factor", str(dec["factor"])])
    pcode = osd_eval.build_code(port_code)
    code = ref_build_code(r.config["code"])
    trace_skip, trace_steps = int(traffic["trace_skip"]), int(traffic["trace_steps"])
    tracer = Tracer(r.trace, trace_skip, trace_steps)
    rec = Recorder(ref.sides_of(code, dev), code.n)
    undo_control = apply_control(r.control) if r.control is not None else (lambda: None)
    rec.install()
    try:
        step, _ = osd_eval.make_step(args, pcode, dev)
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
        rng = np.random.default_rng([r.seed, 1])
        picked = sorted(int(i) for i in rng.choice(nbatches, size=k, replace=False))
        samples = min(batch, int(traffic["check_samples"]))
        capture = {}
        for i in picked:
            cols = torch.as_tensor(np.sort(rng.choice(batch, size=samples, replace=False)), device=dev)
            capture[i] = (cols, {0, 1, int(rng.integers(2, max(3, iters - 1))), iters - 1})
        rec.reset(capture, tracer)
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
        undo_control()
    mem = peak_memory(dev)
    decoded, stepped = int(res.num_blocks[0]), rec.batch + 1
    short = int(decoded != nbatches * batch) + int(stepped != nbatches)
    logical = int(res.logical_errors[0])
    notes = [f"{nbatches} batches of {batch} in {window:.3f} s; flagged {int(res.flagged_errors[0])}, "
             f"logical {logical} (LER {logical / max(decoded, 1):.4g}); checked batches {sorted(rec.captured)} at "
             f"iterations {sorted(capture[picked[0]][1])}; decoded {decoded} syndromes in {stepped} steps"]
    last = nbatches - 1
    decodes, gf2 = rec.decodes.get(last, []), rec.gf2.get(last, [])
    del step, wrapped, res

    worst = {"mismatches": short, "llr_gap": 0.0}
    for i, cap in sorted(rec.captured.items()):
        try:
            got = ref.check_batch(rec.sides, code, p, batch, batch_seed(r.seed, i), cap, iters)
        except (RuntimeError, ValueError, IndexError, KeyError, TypeError) as e:
            got = {"mismatches": 1, "llr_gap": 0.0, "notes": [f"check failed: {e!r}"]}
        worst["mismatches"] += got["mismatches"]
        worst["llr_gap"] = max(worst["llr_gap"], got["llr_gap"])
        notes += [f"batch {i}: {x}" for x in got["notes"][:20]]
    nums = dict(worst, batches_unchecked=max(0, k - len(rec.captured)))
    checks = [Check(name, nums[name], limit) for name, limit in r.limits.items()]

    dims = gather_bp4_counts.dims_of(code)
    bound = sum(gather_bp4_counts.gather_bp4_bound_ms(dims, x["batch"], x["iters"], dec["cn_type"], dec["phi"])[0]
                for x in decodes)
    ops_gf2 = sum(counts.gf2_ops(z, b) for z, b in gf2)
    context = dict(kind=KIND, loop="eval", gather_bp4_bound_ms=bound, gather_bp4_decodes=len(decodes),
                   gf2_bound_ms=osd_counts.gf2_bound_ms(ops_gf2), gf2_products=len(gf2))
    metrics = {"syndromes_per_s": decoded / window, "setup_s": setup_s}
    return Outcome(metrics, decoded, 0, checks, mem, tracer.data, context, notes)


def readings(r: Run, fault: str | None = None, control: str | None = None) -> dict:
    """The compared numbers of the checked batches with no window around
    them (calibration), and three lines of the notes: the program as it is,
    under a control (``CONTROLS``) or with a planted fault (``FAULTS``)."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"the gather_bp4 kind reads no control {control!r} (it knows {', '.join(CONTROLS)})")
    undo = plant_fault(fault) if fault is not None else (lambda: None)
    try:
        out = run(dataclasses.replace(r, control=control))
    finally:
        undo()
    return {c.name: c.value for c in out.checks} | {"notes": out.notes[1:4]}
