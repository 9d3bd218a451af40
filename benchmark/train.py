"""Training traffic: the program's two-stage feedback-GNN train step
(frozen BP4 features, then GNN + BP4 under autograd, deep-supervision loss,
element-wise gradient clip, Adam) on batches of fixed-weight Pauli noise.

The mix's file gives the batch and the range of Pauli weights: each sample
has its own weight, drawn uniformly from the range, its positions a uniform
subset of the qubits, each hit X, Z or Y with probability 1/3.  The noise
and the initial GNN parameters are made on the device from the seed.

Set-up builds one train step with its parameters and optimizer state, and
drives it through its first ``check_steps`` steps, which warm up every
shape; the same step and state then run the window, step after step, until
``--seconds`` have passed, over a small pool of noise batches in turn (the
step's work does not depend on the noise's content).  The rate is the
samples of every step over the window's whole wall time, ended by a
synchronize.  Once the window has closed, the reference replays the first
steps from the same parameters and noise, and each of ``WINDOW_CHECKS``
steps of the window, drawn from the seed, from the parameters and Adam's
moments that the program held before it (copied then): each step's loss,
the clipped gradient (from the optimizer's first moment before and after
the step) and the parameters' change are compared leaf by leaf.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .harness import Check, Outcome, Run, peak_memory, synchronize
from .trace import Tracer

__all__ = ["KIND", "run", "readings", "make_noise", "make_params", "FAULTS"]

KIND = "train"
POOL_BATCHES = 8  # noise batches drawn beside the set-up's; the window cycles through all of them
WINDOW_CHECKS = 2  # window steps replayed by the reference
B1 = 0.9  # Adam's first-moment decay, the program's and the reference's
FAULTS = ("unchanged", "half_batch", "altered_loss")


def _word(*words) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])


def make_noise(seed: int, steps: int, batch: int, n: int, wmin: int, wmax: int, device):
    """(noise_x, noise_z) [steps, n, batch] bool: every sample with its own
    weight in wmin..wmax, at a uniform subset of positions, each X with
    probability 2/3 and Z with probability 2/3 (Y = both: 1/3)."""
    g = torch.Generator(device=device).manual_seed(_word(seed, 2))
    rows = steps * batch
    wt = torch.randint(wmin, wmax + 1, (rows, 1), generator=g, device=device)
    pos = torch.rand((rows, n), generator=g, device=device).argsort(dim=1)[:, :wmax]
    u = torch.rand((rows, wmax), generator=g, device=device)
    active = torch.arange(wmax, device=device)[None, :] < wt
    nx = torch.zeros((rows, n), dtype=torch.bool, device=device)
    nz = torch.zeros((rows, n), dtype=torch.bool, device=device)
    nx.scatter_(1, pos, (u < 2.0 / 3.0) & active)
    nz.scatter_(1, pos, (u > 1.0 / 3.0) & active)
    shape = (steps, batch, n)
    return nx.reshape(shape).transpose(1, 2), nz.reshape(shape).transpose(1, 2)


def make_params(seed: int, gnn: dict, device):
    """Initial GNN parameters in the published layout, from one uniform draw
    on the device: a fresh GNN as the program's training starts one (kernels
    glorot-uniform, biases ones), except that the output layer's kernel,
    which the program zeroes, is drawn too at a tenth of the glorot scale,
    so that every leaf has a first gradient and the first decode starts
    near the prior LLR of 1 whatever the seed."""
    h, m, layers = int(gnn["hidden"]), int(gnn["msg_dims"]), int(gnn["mlp_layers"])
    if layers != 2:
        raise ValueError("the published GNN has 2-layer MLPs")
    shapes = {"llr_inv_embed": [(h, 3)], "msg_mlp_x": [(4, h), (h, m)], "msg_mlp_z": [(4, h), (h, m)],
              "embed_mlp": [(2 * m + 3, h)]}
    total = sum(a * b for v in shapes.values() for a, b in v)
    g = torch.Generator(device=device).manual_seed(_word(seed, 3))
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for key, dims in shapes.items():
        scale = 0.1 if key == "llr_inv_embed" else 1.0
        layer_list = []
        for a, b in dims:
            k = u[at:at + a * b].reshape(a, b) * (scale * math.sqrt(6.0 / (a + b)))
            at += a * b
            layer_list.append({"kernel": k, "bias": torch.ones(b, device=device)})
        out[key] = layer_list[0] if key == "llr_inv_embed" else layer_list
    return out


def _leaves(tree):
    """Leaves in a fixed order with their names."""
    names = []
    for key in ("llr_inv_embed", "msg_mlp_x", "msg_mlp_z", "embed_mlp"):
        layers = tree[key] if isinstance(tree[key], list) else [tree[key]]
        for i, layer in enumerate(layers):
            for kb in ("kernel", "bias"):
                names.append((f"{key}/{i}/{kb}", layer[kb]))
    return names


def _settings(config):
    t = dict(config["train"])
    t.setdefault("factor", 1.0)
    return t


def _reference(r: Run, code, p0_leaves, batches, tf32=False, adam=None, k0=0):
    """The reference's losses, first clipped gradient and parameters after
    one step on each of ``batches`` [(noise_x, noise_z)], from the named
    leaves and Adam's moments ``adam`` (m, v) after ``k0`` steps (none:
    zero moments at step 0)."""
    from .reference.gnn_bp import bp4, check_logits, gnn_apply, graph_on, loss_terms

    t = _settings(r.config)
    dev = r.device
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        g = graph_on(code, dev)
        hx = torch.as_tensor(code.hx, dtype=torch.float32, device=dev)
        hz = torch.as_tensor(code.hz, dtype=torch.float32, device=dev)
        names = [k for k, _ in p0_leaves]
        leaves = [v.detach().clone().requires_grad_(True) for _, v in p0_leaves]

        def tree():
            d = dict(zip(names, leaves))
            lay = lambda key, i: {"kernel": d[f"{key}/{i}/kernel"], "bias": d[f"{key}/{i}/bias"]}  # noqa: E731
            return {"llr_inv_embed": lay("llr_inv_embed", 0),
                    **{k: [lay(k, i) for i in range(len([x for x in names if x.startswith(k + "/")]) // 2)]
                       for k in ("msg_mlp_x", "msg_mlp_z", "embed_mlp")}}

        m = [x.clone() for x in adam[0]] if adam else [torch.zeros_like(v) for v in leaves]
        v2 = [x.clone() for x in adam[1]] if adam else [torch.zeros_like(v) for v in leaves]
        b1, b2, eps = B1, 0.999, 1e-8
        losses, first_grad = [], None
        n = code.n
        for s, (nx, nz) in enumerate(batches):
            b = nx.shape[1]
            syn_x = torch.matmul(hx, nz.to(torch.float32)).to(torch.int32) & 1
            syn_z = torch.matmul(hz, nx.to(torch.float32)).to(torch.int32) & 1
            llr0 = torch.log(torch.tensor(3.0 * (1.0 - t["p0"]) / t["p0"], dtype=torch.float32,
                                          device=dev)).expand(3, n, b)
            with torch.no_grad():
                marg, _ = bp4(g, llr0, syn_x, syn_z, t["num_iter1"], t["factor"])
                x_logit, z_logit = check_logits(*marg, g)
            new_llr = gnn_apply(tree(), g, torch.stack(marg), z_logit, x_logit, syn_x, syn_z)
            _, stack = bp4(g, new_llr, syn_x, syn_z, t["num_iter2"], t["factor"], collect_logits=True)
            loss = loss_terms(stack, syn_x, syn_z, g, t["num_iter2"], t["loss_from"])
            grads = torch.autograd.grad(loss, leaves)
            grads = [gr.clamp(-t["grad_clip"], t["grad_clip"]) for gr in grads]
            losses.append(float(loss.detach()))
            if first_grad is None:
                first_grad = [gr.detach().clone() for gr in grads]
            with torch.no_grad():
                k = k0 + s + 1
                for p, gr, mm, vv in zip(leaves, grads, m, v2):
                    mm.mul_(b1).add_(gr, alpha=1 - b1)
                    vv.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                    mhat = mm / (1 - b1 ** k)
                    vhat = vv / (1 - b2 ** k)
                    p.sub_(t["lr"] * mhat / (vhat.sqrt() + eps))
        return losses, first_grad, [v.detach() for v in leaves]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _quarters(t0, stamps):
    """Steps a second in each quarter of the steps' span."""
    if len(stamps) < 8:
        return []
    t = np.array([t0] + stamps)
    q = np.linspace(0, len(stamps), 5).astype(int)
    return [(q[i + 1] - q[i]) / (t[q[i + 1]] - t[q[i]]) for i in range(4)]


def _moments(params, opt_state):
    """Copies of the leaves and of Adam's two moments, in ``_leaves``' order."""
    named = _leaves(params)
    st = [opt_state.state.get(v, {}) for _, v in named]
    return ([v.detach().clone() for _, v in named],
            [x.get("exp_avg", torch.zeros_like(v)).detach().clone() for x, (_, v) in zip(st, named)],
            [x.get("exp_avg_sq", torch.zeros_like(v)).detach().clone() for x, (_, v) in zip(st, named)])


def _clipped_grad(m_before, m_after):
    """The clipped gradient of the step between two first moments:
    m_after = B1 m_before + (1 - B1) g, in float64."""
    return [a.double() + (b.double() - a.double()) / (1.0 - B1) for a, b in zip(m_before, m_after)]


def _norms(ts):
    return np.array([float(torch.linalg.vector_norm(x.to(torch.float64))) for x in ts])


def _rel(a, b, floor):
    """|a - b| / max(b, floor), elementwise; 0 where both sides are 0."""
    den = np.maximum(b, floor)
    return np.where(den > 0, np.abs(a - b) / np.where(den > 0, den, 1.0), np.where(a == b, 0.0, np.inf))


def compare(prog, ref, p0):
    """The compared numbers of the program's (losses, first gradient,
    parameters) against the reference's, both from initial leaves ``p0``."""
    (pl, pg, pp), (rl, rg, rp) = prog, ref
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(pl, rl)]
    loss_gap = max(loss_gaps)
    gp, gr = _norms(pg), _norms(rg)
    gmed = float(np.median(gr))
    grad_gap = float(np.max(_rel(gp, gr, gmed)))
    # leaves the reference does not move (gradient nought to rounding) move
    # under Adam by round-off alone: left out of the change
    keep = gr >= 1e-3 * gmed
    cp = _norms([a - b for a, b in zip(pp, p0)])
    cr = _norms([a - b for a, b in zip(rp, p0)])
    cmed = float(np.median(cr[keep])) if keep.any() else 0.0
    change_gap = float(np.max(_rel(cp[keep], cr[keep], cmed), initial=0.0))
    worst = lambda a, b, ref_med: int(np.argmax(_rel(a, b, ref_med)))  # noqa: E731
    return {"first_loss_gap": float(loss_gaps[0]), "loss_gap": float(loss_gap),
            "loss_gaps": [float(x) for x in loss_gaps], "grad_gap": grad_gap,
            "change_gap": change_gap, "leaves_left_out": int((~keep).sum()),
            "grad_worst_leaf": worst(gp, gr, gmed), "change_worst_leaf": worst(cp, cr, cmed),
            "change_median_gap": float(np.median(_rel(cp[keep], cr[keep], cmed))) if keep.any() else 0.0}


def _patch_fault(fault):
    """Plant one of FAULTS in the program; returns the undo."""
    from feedback_gnn_tpu_torch.train import trainer

    if fault == "unchanged":
        orig = trainer.ClipAdam.update
        trainer.ClipAdam.update = lambda self, opt_state: None
        return lambda: setattr(trainer.ClipAdam, "update", orig)
    if fault == "half_batch":
        orig = trainer._one_update

        def half(graph, cfg, optimizer, params, opt_state, nx, nz):
            h = nx.shape[1] // 2
            return orig(graph, cfg, optimizer, params, opt_state, nx[:, :h], nz[:, :h])

        trainer._one_update = half
        return lambda: setattr(trainer, "_one_update", orig)
    if fault == "altered_loss":
        orig = trainer.deep_supervision_loss
        trainer.deep_supervision_loss = lambda *a, **k: orig(*a, **k) * 1.01
        return lambda: setattr(trainer, "deep_supervision_loss", orig)
    raise ValueError(f"unknown fault {fault!r}")


def run(r: Run, window: bool = True, fault: str | None = None) -> Outcome:
    """One run; ``window`` False stops after set-up's steps (calibration);
    ``fault`` plants one of FAULTS in the program (calibration, tests)."""
    from feedback_gnn_tpu_torch import resolve_device
    from feedback_gnn_tpu_torch.codes import QuantumGraph
    from feedback_gnn_tpu_torch.config import build_code
    from feedback_gnn_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

    from .reference.codes import build_code as ref_build_code

    dev = resolve_device(str(r.device))
    tr, t = r.traffic, _settings(r.config)
    batch = r.batch or int(tr["batch"])
    check_steps = int(tr["check_steps"])
    cfg = TrainConfig(num_iter1=t["num_iter1"], num_iter2=t["num_iter2"], loss_from=t["loss_from"],
                      cn_type=t["cn_type"], factor1=t["factor"], factor2=t["factor"], p0=t["p0"],
                      learning_rate=t["lr"], grad_clip=t["grad_clip"])
    undo = _patch_fault(fault) if fault else None
    try:
        graph = QuantumGraph.from_code(build_code(r.config["port_code"]), stage_mode=True).to(dev)
        n = graph.n
        total = check_steps + (POOL_BATCHES if window else 0)
        noise = make_noise(r.seed, total, batch, n, int(tr["weight_min"]), int(tr["weight_max"]), dev)
        params = make_params(r.seed, r.config["gnn"], dev)
        p0 = [(k, v.detach().clone()) for k, v in _leaves(params)]
        optimizer = make_optimizer(cfg)
        opt_state = optimizer.init(params)
        step = make_train_step(graph, cfg, optimizer)

        losses, first_grad = [], None
        for s in range(check_steps):
            params, opt_state, loss, _, _ = step(params, opt_state, noise[0][s], noise[1][s])
            losses.append(loss)
            if s == 0:
                m1 = _moments(params, opt_state)[1]
                first_grad = _clipped_grad([torch.zeros_like(x) for x in m1], m1)
        after = [v.detach().clone() for _, v in _leaves(params)]
        synchronize(dev)

        # window steps replayed by the reference: the first step to start
        # after each of these shares of the window
        picks = sorted(np.random.default_rng([r.seed, 4]).uniform(0.05, 0.5, WINDOW_CHECKS).tolist())
        checked = []  # (noise index, steps before, moments before, loss, moments after)
        skip, tsteps = int(tr["trace_skip"]), int(tr["trace_steps"])
        tracer = Tracer(r.trace and window, skip, tsteps)
        t0 = time.perf_counter()
        setup_s = t0 - r.t_start
        done, stamps = 0, []
        if window:
            with tracer:
                while True:
                    tracer.step()
                    k = (check_steps + done) % total
                    before = None
                    if picks and time.perf_counter() - t0 >= picks[0] * r.seconds:
                        while picks and time.perf_counter() - t0 >= picks[0] * r.seconds:
                            picks.pop(0)
                        before = _moments(params, opt_state)
                    params, opt_state, loss, _, _ = step(params, opt_state, noise[0][k], noise[1][k])
                    if before is not None:
                        checked.append((k, check_steps + done, before, loss, _moments(params, opt_state)))
                    done += 1
                    stamps.append(time.perf_counter())
                    if tracer.enabled and done in (skip, skip + tsteps):
                        synchronize(dev)
                    if time.perf_counter() - t0 >= r.seconds and (not tracer.enabled or done > skip + tsteps):
                        break
            synchronize(dev)
        elapsed = time.perf_counter() - t0
    finally:
        if undo:
            undo()
    mem = peak_memory(dev)
    prog = ([float(x) for x in losses], first_grad, after)
    del step, opt_state, graph, params

    code = ref_build_code(r.config["code"])
    names = [k for k, _ in p0]
    ref = _reference(r, code, p0, [(noise[0][s], noise[1][s]) for s in range(check_steps)])
    nums = compare(prog, ref, [v for _, v in p0])
    notes = [f"{done} steps of {batch} in {elapsed:.3f} s; losses {prog[0]} (reference {ref[0]}); "
             f"{nums['leaves_left_out']} leaves left out of the change",
             "steps/s by quarter of the window (host clock, before the last synchronize): "
             + ", ".join(f"{x:.3f}" for x in _quarters(t0, stamps))]
    window_losses = []
    for k, k0, (w0, m0, v0), loss, (w1, m1, _) in checked:
        w_loss = float(loss)
        window_losses.append(w_loss)
        w_ref = _reference(r, code, list(zip(names, w0)), [(noise[0][k], noise[1][k])], adam=(m0, v0), k0=k0)
        got = compare(([w_loss], _clipped_grad(m0, m1), w1), w_ref, w0)
        for key in ("first_loss_gap", "grad_gap", "change_gap"):
            nums[key] = max(nums[key], got[key])
        notes.append(f"window step {k0 - check_steps} (step {k0 + 1}, noise batch {k}): loss {w_loss} "
                     f"(reference {w_ref[0][0]}), gaps: loss {got['first_loss_gap']!r}, "
                     f"gradient {got['grad_gap']!r}, change {got['change_gap']!r}")
    if window and not checked:
        nums["first_loss_gap"] = math.inf
        notes.append("no window step was checked")
    nonfinite = int(sum(not math.isfinite(x) for x in prog[0] + window_losses))
    nums["nonfinite_losses"] = nonfinite
    checks = [Check(k, nums[k], v) for k, v in r.limits.items()]
    metrics = {"train_samples_per_s": done * batch / elapsed if done else 0.0, "setup_s": setup_s}
    return Outcome(metrics, done, nonfinite, checks, mem, tracer.data, {"kind": KIND, "numbers": nums}, notes)


def readings(r: Run, fault: str | None = None, control: str | None = None):
    """The compared numbers without a window (calibration): the program as
    it is, with a fault planted, or (``control`` "tf32") the reference in
    TF32 in the program's place."""
    if control:
        from .reference.codes import build_code as ref_build_code

        tr = r.traffic
        batch = r.batch or int(tr["batch"])
        code = ref_build_code(r.config["code"])
        steps = int(tr["check_steps"])
        noise = make_noise(r.seed, steps, batch, code.n, int(tr["weight_min"]), int(tr["weight_max"]),
                           r.device)
        batches = [(noise[0][s], noise[1][s]) for s in range(steps)]
        p0 = [(k, v.detach().clone()) for k, v in _leaves(make_params(r.seed, r.config["gnn"], r.device))]
        ctl = _reference(r, code, p0, batches, tf32=True)
        ref = _reference(r, code, p0, batches)
        return compare(ctl, ref, [v for _, v in p0])
    out = run(r, window=False, fault=fault)
    return out.context["numbers"]
