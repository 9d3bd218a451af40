"""GNN_BP4 traffic: the program's LER sweep loop over its GNN_BP4 step, as
evaluators of the learned decoder drive it (``cli/osd_eval.py --mode
gnn-bp4``), and the check of what it produced.

The configuration gives the code, the trained weights and their widths;
the mix's file the depolarizing strength ``p`` and the batch.  The step is
the one the CLI mode builds (``osd_eval.make_step``).  The window is one
call of the program's ``sim_ler`` over as many batches as fill
``--seconds`` at the warm-up's pace, with the rate and the loop's checks of
the mc kind (mc.py).

Wrappers around the program's entries record what the timed path does:
each decode's batch and iterations, each GF(2) product's batch, and, in the
batches drawn from the seed for the check, the sampled noise, the decode's
syndromes, its last LLRs and decisions, the counts the step returned, and
on ``check_samples`` samples of the batch drawn from the seed every state
the decode computed: each CN update's and VN update's output and each
iteration's perp logits (the decoder's ``_update_cn``, ``_update_vn`` and
``_cal_logit``).  The check runs once the window has closed and the peak
memory is read (reference/gnn_bp4.py): every update from the program's own
states before it, since a float32 network run for eight iterations turns
last-bit differences into gaps of order 1 by its end.

``readings`` (calibrate.py) reads the program as it is, under a control
(``bf16``: the dense layers' operands rounded to bfloat16; ``tf32``: TF32
on, which the CPU does not have: there the operands are rounded to TF32's
10 mantissa bits instead) or with a planted fault (``FAULTS``).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from . import counts, gnn_bp4_counts, osd_counts
from .harness import Check, Outcome, ROOT, Run, peak_memory, synchronize
from .trace import Tracer

__all__ = ["KIND", "FAULTS", "CONTROLS", "run", "readings", "Recorder", "plant_fault", "apply_control"]

KIND = "gnn_bp4"
WARMUP_BATCHES = 2
FAULTS = ("iteration_left_out", "sum_not_mean", "syndrome_sign_dropped")
CONTROLS = ("bf16", "tf32")


class Recorder:
    """Wraps the program's channel sampler, GNN_BP4 decode, its logits and
    the GF(2) products; ``batch`` is the index of the batch in progress."""

    def __init__(self):
        self.batch = -1
        self.capture = {}
        self.captured = {}
        self.decodes = {}
        self.gf2 = {}
        self.nnz = {}
        self.tracer = None
        self._undo = []

    def reset(self, capture, tracer):
        """Start the window: batch indices from 0, and the samples ``cols``
        of batch i captured where ``capture`` maps i to them."""
        self.batch = -1
        self.tracer = tracer
        self.capture = dict(capture)
        self.captured, self.decodes, self.gf2 = {}, {}, {}

    def _patch(self, module, name, fn):
        self._undo.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def _cap(self):
        return self.captured[self.batch] if self.batch in self.capture else None

    def install(self):
        from feedback_gnn_tpu_torch import models
        from feedback_gnn_tpu_torch.decoders import gnn_full

        orig_noise, orig_apply = models.pauli_iid, models.gnn_bp4_apply
        orig_logit, orig_gf2 = gnn_full._cal_logit, models.mod2_matmul
        orig_cn, orig_vn = gnn_full._update_cn, gnn_full._update_vn

        def noise(generator, px, py, pz, n, batch):
            out = orig_noise(generator, px, py, pz, n, batch)
            cap = self._cap()
            if cap is not None:
                cap["noise"] = out
            return out

        def decode(params, graph, lrowsets, syndrome_x, syndrome_z, cfg, *args, **kw):
            self.decodes.setdefault(self.batch, []).append(dict(batch=int(syndrome_x.shape[-1]),
                                                                iters=int(cfg.num_iter)))
            out = orig_apply(params, graph, lrowsets, syndrome_x, syndrome_z, cfg, *args, **kw)
            cap = self._cap()
            if cap is not None:
                cap.update(syndromes=(syndrome_x, syndrome_z), decisions=out[:2])
            return out

        def logit(params, lrowsets, h_vn, axis=None):
            out = orig_logit(params, lrowsets, h_vn, axis)
            cap = self._cap()
            if cap is not None:
                cols = cap["cols"]
                cap["perp"].append((out[2][:, cols], out[3][:, cols]))
                cap.update(llrs=out[4], rows=lrowsets)
            return out

        def update_cn(*args, **kw):
            out = orig_cn(*args, **kw)
            cap = self._cap()
            if cap is not None:
                cap["cn"].append(tuple(h[..., cap["cols"]] for h in out))
            return out

        def update_vn(*args, **kw):
            out = orig_vn(*args, **kw)
            cap = self._cap()
            if cap is not None:
                cap["vn"].append(out[..., cap["cols"]])
            return out

        def gf2(h, v):
            key = h.data_ptr()
            if key not in self.nnz:  # seen first in the warm-up, outside the window
                self.nnz[key] = int((h != 0).sum())
            self.gf2.setdefault(self.batch, []).append((self.nnz[key], int(v.shape[-1])))
            return orig_gf2(h, v)

        self._patch(models, "pauli_iid", noise)
        self._patch(models, "gnn_bp4_apply", decode)
        self._patch(gnn_full, "_cal_logit", logit)
        self._patch(gnn_full, "_update_cn", update_cn)
        self._patch(gnn_full, "_update_vn", update_vn)
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
                self.captured[self.batch] = {"cols": self.capture[self.batch], "cn": [], "vn": [], "perp": []}
            out = step(generator, p)
            if self.batch in self.capture:
                self.captured[self.batch]["counts"] = out
            return out

        return wrapped


def plant_fault(fault):
    """Plant a fault in the program's GNN_BP4; returns its undo."""
    from feedback_gnn_tpu_torch import models
    from feedback_gnn_tpu_torch.decoders import gnn_full

    if fault == "syndrome_sign_dropped":
        module, name = gnn_full, "_syndrome_pm"
        orig = gnn_full._syndrome_pm

        def fn(syndrome, rows):
            return torch.ones_like(orig(syndrome, rows))
    elif fault in ("iteration_left_out", "sum_not_mean"):
        module, name = models, "gnn_bp4_apply"
        orig = models.gnn_bp4_apply

        def fn(params, graph, lrowsets, syndrome_x, syndrome_z, cfg, *args, **kw):
            cfg = (cfg._replace(num_iter=cfg.num_iter - 1) if fault == "iteration_left_out"
                   else cfg._replace(reduce_op="sum"))
            return orig(params, graph, lrowsets, syndrome_x, syndrome_z, cfg, *args, **kw)
    else:
        raise ValueError(f"the gnn_bp4 kind plants no fault {fault!r} (it knows {', '.join(FAULTS)})")
    setattr(module, name, fn)
    return lambda: setattr(module, name, orig)


def _round_mantissa(x, bits):
    """float32 ``x`` rounded to ``bits`` mantissa bits (to nearest, ties away
    from zero)."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def apply_control(control, device):
    """Run the program's dense layers in a lower precision; returns the undo.
    TF32 is switched on around each dense layer, since the program pins it
    off wherever it resolves its device (the weights' load, ``sim_ler``)."""
    from feedback_gnn_tpu_torch.decoders import gnn_full

    if control not in CONTROLS:
        raise ValueError(f"the gnn_bp4 kind reads no control {control!r} (it knows {', '.join(CONTROLS)})")
    orig = gnn_full.dense_bl
    if control == "tf32" and device.type == "cuda":
        def dense(x, kernel, bias=None, activation=None):
            flags = torch.backends.cuda.matmul
            old, flags.allow_tf32 = flags.allow_tf32, True
            try:
                return orig(x, kernel, bias, activation)
            finally:
                flags.allow_tf32 = old
    else:
        if control == "bf16":
            rnd = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
        else:
            rnd = lambda t: _round_mantissa(t, 10)  # noqa: E731

        def dense(x, kernel, bias=None, activation=None):
            return orig(rnd(x), rnd(kernel), bias, activation)

    gnn_full.dense_bl = dense
    return lambda: setattr(gnn_full, "dense_bl", orig)


def _true_rows(cap, n):
    """A captured batch with the program's padded rows taken out of the perp
    logits (their true rows, [hz; lz] and [hx; lx], by the row sets'
    validity), the LLRs and the decisions (the first ``n``)."""
    rows_hx, rows_hz, rows_lx, rows_lz = cap["rows"]
    keep_x = torch.cat([rows_hz.row_valid, rows_lz.row_valid]) > 0
    keep_z = torch.cat([rows_hx.row_valid, rows_lx.row_valid]) > 0
    return dict(cap, perp=[(x[keep_x], z[keep_z]) for x, z in cap["perp"]],
                llrs=tuple(v[:n] for v in cap["llrs"]), decisions=tuple(v[:n] for v in cap["decisions"]))


def _supported():
    """Whether the program's evaluation CLI has the GNN_BP4 mode."""
    from feedback_gnn_tpu_torch.cli import osd_eval

    mode = next(a for a in osd_eval.make_parser()._actions if "--mode" in a.option_strings)
    return "gnn-bp4" in mode.choices


def run(r: Run) -> Outcome:
    if not _supported():
        raise RuntimeError("this program's cli/osd_eval.py has no --mode gnn-bp4: it cannot run GNN_BP4 "
                           "through sim_ler")
    from feedback_gnn_tpu_torch import resolve_device
    from feedback_gnn_tpu_torch.cli import osd_eval
    from feedback_gnn_tpu_torch.config import build_code
    from feedback_gnn_tpu_torch.sim.montecarlo import sim_ler

    dev, traffic = resolve_device(str(r.device)), r.traffic
    batch = r.batch or int(traffic["batch"])
    p = float(np.asarray([traffic["p"]], np.float64)[0])
    weights = os.path.join(ROOT, r.config["weights"])

    pcode = build_code(r.config["port_code"])
    args = osd_eval.make_parser().parse_args(["--mode", "gnn-bp4", "-bs", str(batch), "--weights", weights])
    trace_skip, trace_steps = int(traffic["trace_skip"]), int(traffic["trace_steps"])
    tracer = Tracer(r.trace, trace_skip, trace_steps)
    rec = Recorder()
    undo_control = apply_control(r.control, dev) if r.control is not None else (lambda: None)
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
        rec.reset({i: torch.as_tensor(np.sort(rng.choice(batch, size=samples, replace=False)), device=dev)
                   for i in picked}, tracer)
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
             f"logical {logical} (LER {logical / max(decoded, 1):.4g}); checked batches {sorted(rec.captured)}; "
             f"decoded {decoded} syndromes in {stepped} steps"]
    last = nbatches - 1
    decodes, gf2 = rec.decodes.get(last, []), rec.gf2.get(last, [])
    del step, wrapped, res

    from .reference import cascade as ref_cascade
    from .reference import gnn_bp4 as ref_gnn
    from .reference.codes import build_code as ref_build_code

    code = ref_build_code(r.config["code"])
    widths = r.config["gnn_bp4"]
    net = ref_gnn.load_net(code, weights, widths, dev)
    worst = {"mismatches": short, "llr_gap": 0.0}
    for i, cap in sorted(rec.captured.items()):
        try:
            got = ref_gnn.check_batch(net, code, p, batch, ref_cascade.batch_seed(r.seed, i), _true_rows(cap, code.n))
        except (RuntimeError, ValueError, IndexError, KeyError) as e:
            got = {"mismatches": 1, "llr_gap": 0.0, "notes": [f"check failed: {e!r}"]}
        worst["mismatches"] += got["mismatches"]
        worst["llr_gap"] = max(worst["llr_gap"], got["llr_gap"])
        notes += [f"batch {i}: {x}" for x in got["notes"][:20]]
    nums = dict(worst, batches_unchecked=max(0, k - len(rec.captured)))
    checks = [Check(name, nums[name], limit) for name, limit in r.limits.items()]

    dims = gnn_bp4_counts.dims_of(code)
    bound = sum(gnn_bp4_counts.gnn_bp4_bound_ms(dims, dict(widths, num_iter=x["iters"]), x["batch"])[0]
                for x in decodes)
    ops_gf2 = sum(counts.gf2_ops(z, b) for z, b in gf2)
    context = dict(kind=KIND, loop="eval", gnn_bp4_bound_ms=bound, gnn_bp4_decodes=len(decodes),
                   gf2_bound_ms=osd_counts.gf2_bound_ms(ops_gf2), gf2_products=len(gf2))
    metrics = {"syndromes_per_s": decoded / window, "setup_s": setup_s}
    return Outcome(metrics, decoded, 0, checks, mem, tracer.data, context, notes)


def readings(r: Run, fault: str | None = None, control: str | None = None) -> dict:
    """The compared numbers of the checked batches with no window around
    them (calibration), and three lines of the notes: the program as it is,
    under a control (``CONTROLS``) or with a planted fault (``FAULTS``)."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"the gnn_bp4 kind reads no control {control!r} (it knows {', '.join(CONTROLS)})")
    undo = plant_fault(fault) if fault is not None else (lambda: None)
    try:
        out = run(dataclasses.replace(r, control=control))
    finally:
        undo()
    return {c.name: c.value for c in out.checks} | {"notes": out.notes[1:4]}
