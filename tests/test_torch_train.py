"""The port's training (train/loss.py, train/trainer.py) against the JAX
package's, on GB-48 at small schedules.

Tolerances: losses at rtol 1e-5 (the same float32 sums in another order);
each gradient leaf at a relative L2 error of at most 1e-3; parameters
after clip + Adam at rtol 1e-6, atol 1e-7.

Stage 1 starts from the uniform prior, where BP sits on exact ties and
phi near its clip turns ulp differences between the math libraries into
logit differences of order 0.1 (ROADMAP C), so its features are held by
their hard decisions and by the share of values within 2e-3.  Stage 2 is
fed the same features in both packages.  Min-sum's gradient is
discontinuous wherever two message magnitudes nearly tie: the two GNN
outputs differ in their last bits, and JAX's own gradient moves by more
than the tolerance between them.  So for min-sum the reference is JAX's
chain evaluated at the
port's GNN output: JAX's value and gradient of BP + loss there, the
gradient pulled back through JAX's GNN.
"""

import numpy as np
import optax
import pytest
import torch

# torch.optim imports torch._dynamo at its first use; import it while the
# test modules are collected, before tests/refutil.py (run by
# tests/test_gf2.py) puts stub modules into sys.modules, whose source the
# import's inspection cannot read
import torch._dynamo  # noqa: F401

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders import cn_update as jcn
from feedback_gnn_tpu.decoders.bp4 import bp4_decode as j_bp4_decode
from feedback_gnn_tpu.decoders.gnn_feedback import feedback_gnn_apply as j_apply
from feedback_gnn_tpu.decoders.gnn_feedback import init_feedback_gnn as j_init
from feedback_gnn_tpu.ops.gf2mat import mod2_matmul
from feedback_gnn_tpu.train import loss as jloss
from feedback_gnn_tpu.train import trainer as jt

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.decoders import cn_update as tcn
from feedback_gnn_tpu_torch.decoders import params_from_numpy
from feedback_gnn_tpu_torch.decoders.bp4 import hard_decision
from feedback_gnn_tpu_torch.decoders.gnn_feedback import feedback_gnn_apply, init_feedback_gnn
from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
from feedback_gnn_tpu_torch.train import loss as tloss
from feedback_gnn_tpu_torch.train import trainer as tt

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
CN_TYPES = ["boxplus-phi", "boxplus", "minsum"]
GRAD_REL = 1e-3
SCHEDULE = dict(num_iter1=8, num_iter2=4, loss_from=1)


class Setup:
    def __init__(self):
        self.jcode = jc.create_generalized_bicycle_codes(*GB48)
        self.jg = JQuantumGraph.from_code(self.jcode, stage_mode=True)
        self.tg = tc.QuantumGraph.from_code(tc.create_generalized_bicycle_codes(*GB48),
                                            stage_mode=True).to("cpu")
        rng = np.random.default_rng(0)
        # the init with llr_inv_embed's zero kernel perturbed like every
        # other leaf, so that each leaf gets a gradient
        self.params_np = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.3 * rng.standard_normal(np.shape(a)).astype(np.float32),
            j_init(jax.random.PRNGKey(0)))
        self.jparams = jax.tree_util.tree_map(jnp.asarray, self.params_np)

    def noise(self, b, seed):
        rng = np.random.default_rng(seed)
        return [(rng.random((self.jg.n, b)) < 0.08).astype(np.float32) for _ in range(2)]

    def features(self, b, seed):
        """Random stage-2 inputs: h_vn [3, n, B], logit_hx, logit_hz."""
        rng = np.random.default_rng(seed)
        mx, mz = self.jcode.hx.shape[0], self.jcode.hz.shape[0]
        return ((rng.standard_normal((3, self.jg.n, b)) * 3.0).astype(np.float32),
                (rng.standard_normal((mx, b)) * 2.0).astype(np.float32),
                (rng.standard_normal((mz, b)) * 2.0).astype(np.float32))

    def tparams(self):
        params = params_from_numpy(self.params_np)
        for leaf in flatten_with_paths(params).values():
            leaf.requires_grad_(True)
        return params


@pytest.fixture(scope="module")
def setup():
    return Setup()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _grad_leaves(jgrads):
    """{path: array} of a JAX gradient tree, by the checkpoint's paths."""
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    return {"/".join(str(p).strip("[].'") for p in path): np.asarray(g) for path, g in flat}


def _assert_grads(tparams, ref):
    for key, leaf in flatten_with_paths(tparams).items():
        g, r = leaf.grad.numpy(), ref[key]
        err = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert err <= GRAD_REL, (key, err)


# ---- the loss --------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_bce_with_logits_matches_jax(masked):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, (24, 16)).astype(np.float32)
    logits = (rng.standard_normal((24, 16)) * 4.0).astype(np.float32)
    rv = (rng.random(24) < 0.7).astype(np.float32) if masked else None
    ref = jloss.bce_with_logits(jnp.asarray(labels), jnp.asarray(logits),
                                None if rv is None else jnp.asarray(rv))
    out = tloss.bce_with_logits(_t(labels), _t(logits), None if rv is None else _t(rv))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_deep_supervision_loss_matches_jax(setup, masked):
    rng = np.random.default_rng(2)
    r = setup.jg.logit_rows_x.r_pad
    xs, zs = ((rng.standard_normal((9, r, 16)) * 5.0).astype(np.float32) for _ in range(2))
    sx, sz = (rng.integers(0, 2, (r, 16)).astype(np.float32) for _ in range(2))
    rvx = setup.jg.logit_rows_x.row_valid if masked else None
    rvz = setup.jg.logit_rows_z.row_valid if masked else None
    ref = jloss.deep_supervision_loss((jnp.asarray(xs), jnp.asarray(zs)), jnp.asarray(sx), jnp.asarray(sz),
                                      8, 3, None if rvx is None else jnp.asarray(rvx),
                                      None if rvz is None else jnp.asarray(rvz))
    out = tloss.deep_supervision_loss((_t(xs), _t(zs)), _t(sx), _t(sz), 8, 3,
                                      None if rvx is None else _t(rvx), None if rvz is None else _t(rvz))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


# ---- gradient rules at ties --------------------------------------------------


@pytest.mark.parametrize("fn,x", [
    ("clip_lo", tcn.PHI_CLIP_MIN), ("clip_hi", tcn.PHI_CLIP_MAX), ("clip_atanh", tcn.ATANH_CLIP),
    ("softplus", 0.0),
])
def test_tie_gradients_follow_jax(fn, x):
    """At a clip bound and at softplus(0) the port's gradient is JAX's (1/2),
    and the forward value is torch.clamp's."""
    pairs = {
        "clip_lo": (lambda v: jnp.clip(v, jcn.PHI_CLIP_MIN, jcn.PHI_CLIP_MAX),
                    lambda v: tcn.clip(v, tcn.PHI_CLIP_MIN, tcn.PHI_CLIP_MAX)),
        "clip_hi": (lambda v: jnp.clip(v, jcn.PHI_CLIP_MIN, jcn.PHI_CLIP_MAX),
                    lambda v: tcn.clip(v, tcn.PHI_CLIP_MIN, tcn.PHI_CLIP_MAX)),
        "clip_atanh": (lambda v: jnp.clip(v, -jcn.ATANH_CLIP, jcn.ATANH_CLIP),
                       lambda v: tcn.clip(v, -tcn.ATANH_CLIP, tcn.ATANH_CLIP)),
        "softplus": (jax.nn.softplus, tcn.softplus),
    }
    jf, tf = pairs[fn]
    vals = np.float32([x, x * 0.5, x * 2.0, -x]) if x else np.float32([0.0, -1.5, 2.0])
    ref = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(vals)))
    v = torch.tensor(vals, requires_grad=True)
    out = tf(v)
    out.sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), ref, rtol=1e-6, atol=0)  # the tie: 0.5, not 1
    with torch.no_grad():
        plain = tf(torch.tensor(vals))
    assert torch.equal(out.detach(), plain)


# ---- stage 1 and stage 2 -----------------------------------------------------


@pytest.mark.parametrize("cn_type", CN_TYPES)
def test_stage_one_features_match_jax(setup, cn_type):
    nx, nz = setup.noise(32, seed=3)
    cfg = dict(num_iter1=8, cn_type=cn_type)
    ref = jax.jit(lambda a, b: jt.stage_one_features(setup.jg, jt.TrainConfig(**cfg), a, b))(
        jnp.asarray(nx), jnp.asarray(nz))
    out = tt.stage_one_features(setup.tg, tt.TrainConfig(**cfg), _t(nx), _t(nz))
    assert not any(o.requires_grad for o in out)  # no autograd graph
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        close = np.isclose(o.numpy(), r, rtol=2e-3, atol=2e-3)
        assert close.mean() >= 0.98, close.mean()
    h_ref = torch.tensor(np.asarray(ref[0]))
    for o, r in zip(hard_decision(*out[0]), hard_decision(*h_ref)):
        assert torch.equal(o, r)


def _jax_reference_at(setup, cfg, nx, nz, feats, tparams):
    """(loss, (s_hat, ls_hat), gradient leaves) of JAX's stage 2 with the
    BP run from the port's GNN output: JAX's value and gradient of BP + loss
    there, the gradient pulled back through JAX's GNN at the same
    parameters."""
    jnx, jnz = jt._pad_noise(setup.jg, jnp.asarray(nx)), jt._pad_noise(setup.jg, jnp.asarray(nz))
    sx, sz = jt._syndromes(setup.jg, jnx, jnz)
    with torch.no_grad():
        llr_t = feedback_gnn_apply(tparams, setup.tg, *(_t(f) for f in feats), _t(sx), _t(sz)).numpy()
    rv = (jnp.asarray(setup.jg.logit_rows_x.row_valid), jnp.asarray(setup.jg.logit_rows_z.row_valid))
    jg = setup.jg

    def bp_loss(llr):
        res = j_bp4_decode(jg, llr, sx, sz, cfg.num_iter2, cfg.cn_type, cfg.factor2, collect_logits=True)
        xd, zd = jnx ^ res.x_hat, jnz ^ res.z_hat
        aux = (jnp.concatenate([mod2_matmul(jg.hz, xd), mod2_matmul(jg.hx, zd)]),
               jnp.concatenate([mod2_matmul(jg.hx_perp, xd), mod2_matmul(jg.hz_perp, zd)]))
        return jloss.deep_supervision_loss(res.logit_stack, sx, sz, cfg.num_iter2, cfg.loss_from, *rv), aux

    (loss, aux), d_llr = jax.jit(jax.value_and_grad(bp_loss, has_aux=True))(jnp.asarray(llr_t))
    def gnn(p):
        return j_apply(p, jg, *map(jnp.asarray, feats), sx, sz)

    pull = jax.jit(lambda p, ct: jax.vjp(gnn, p)[1](ct)[0])
    return loss, aux, _grad_leaves(pull(setup.jparams, d_llr))


@pytest.mark.parametrize("cn_type", CN_TYPES)
def test_stage_two_loss_matches_jax(setup, cn_type):
    nx, nz = setup.noise(32, seed=4)
    feats = setup.features(32, seed=5)
    jcfg = jt.TrainConfig(cn_type=cn_type, **SCHEDULE)
    tparams = setup.tparams()
    loss, aux = tt.stage_two_loss(tparams, setup.tg, tt.TrainConfig(cn_type=cn_type, **SCHEDULE),
                                  _t(nx), _t(nz), *(_t(f) for f in feats))
    loss.backward()
    if cn_type == "minsum":
        ref_loss, ref_aux, ref = _jax_reference_at(setup, jcfg, nx, nz, feats, tparams)
    else:
        value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, *a: jt.stage_two_loss(p, setup.jg, jcfg, *a), has_aux=True))
        (ref_loss, ref_aux), grads = value_and_grad(setup.jparams, jnp.asarray(nx), jnp.asarray(nz),
                                                    *map(jnp.asarray, feats))
        ref = _grad_leaves(grads)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for o, r in zip(aux, ref_aux):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    _assert_grads(tparams, ref)


# ---- the optimizer and the step ----------------------------------------------


def test_optimizer_matches_optax(setup):
    """Three clip + Adam updates on the same gradients (some beyond the
    clip of 10) give optax's parameters."""
    cfg = tt.TrainConfig(learning_rate=1e-3)
    jopt = jt.make_optimizer(jt.TrainConfig(learning_rate=1e-3))
    jparams = setup.jparams
    jstate = jopt.init(jparams)
    jupdate = jax.jit(lambda g, st, p: jopt.update(g, st, p))
    opt = tt.make_optimizer(cfg)
    tparams = params_from_numpy(setup.params_np)
    state = opt.init(tparams)
    rng = np.random.default_rng(6)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(np.shape(a)) * 8.0).astype(np.float32), setup.params_np)
        updates, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat_g = flatten_with_paths(grads)
        for key, leaf in flatten_with_paths(tparams).items():
            leaf.grad = torch.as_tensor(flat_g[key])
        opt.update(state)
        ref = _grad_leaves(jparams)
        for key, leaf in flatten_with_paths(tparams).items():
            np.testing.assert_allclose(leaf.detach().numpy(), ref[key], rtol=1e-6, atol=1e-7,
                                       err_msg=key)


def test_optimizer_takes_leaves_in_checkpoint_order(setup):
    params = params_from_numpy(setup.params_np)
    state = tt.make_optimizer(tt.TrainConfig()).init(params)
    leaves = state.param_groups[0]["params"]
    assert [id(v) for v in leaves] == [id(v) for v in flatten_with_paths(params).values()]
    assert all(v.requires_grad for v in leaves)
    assert list(flatten_with_paths(params)) == list(_grad_leaves(setup.jparams))


def test_train_step_multi_matches_single(setup):
    """k updates per call equal k single steps on the same minibatches."""
    cfg = tt.TrainConfig(num_iter1=8, num_iter2=4, loss_from=2, learning_rate=1e-3)
    opt = tt.make_optimizer(cfg)
    k, b = 3, 16
    rng = np.random.default_rng(9)
    nx = _t((rng.random((k, setup.jg.n, b)) < 0.08).astype(np.float32))
    nz = _t((rng.random((k, setup.jg.n, b)) < 0.08).astype(np.float32))

    p1 = params_from_numpy(setup.params_np)
    s1 = opt.init(p1)
    step1 = tt.make_train_step(setup.tg, cfg, opt)
    ref = []
    for i in range(k):
        p1, s1, loss, fb, bl = step1(p1, s1, nx[i], nz[i])
        ref.append((float(loss), float(fb), float(bl)))

    pk = params_from_numpy(setup.params_np)
    pk, sk, losses, fbs, bls = tt.make_train_step_multi(setup.tg, cfg, opt, k)(pk, opt.init(pk), nx, nz)
    assert losses.shape == fbs.shape == bls.shape == (k,)
    np.testing.assert_array_equal(np.stack([losses, fbs, bls], 1), np.asarray(ref, np.float32))
    for a, c in zip(flatten_with_paths(p1).values(), flatten_with_paths(pk).values()):
        assert torch.equal(a, c)


def test_train_step_reduces_loss(setup):
    """A few Adam steps on a fixed batch reduce the deep-supervision loss
    (tests/test_training.py's check, from the port's own init)."""
    params = init_feedback_gnn(torch.Generator().manual_seed(0))
    cfg = tt.TrainConfig(num_iter1=16, num_iter2=8, loss_from=4, learning_rate=1e-3)
    opt = tt.make_optimizer(cfg)
    state = opt.init(params)
    step = tt.make_train_step(setup.tg, cfg, opt)
    nx, nz = (_t(a) for a in setup.noise(64, seed=2))
    losses = []
    for _ in range(15):
        params, state, loss, fb, bl = step(params, state, nx, nz)
        losses.append(float(loss))
        assert 0.0 <= float(fb) <= 1.0 and 0.0 <= float(bl) <= 1.0
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])
