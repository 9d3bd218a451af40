"""The port's sharded training (parallel/api.py's
``make_sharded_train_step``, the edge axis of train/ and decoders/) on the
CPU, ranks spawned as in tests/test_torch_parallel.py, on GB-48.

* Edge-sharded stage 2 on fixed stage-1 features, the test of the
  ``psum``/``pvary`` pair.  On test_sharding.py's own case (JAX's initial
  parameters, where only llr_inv_embed gets a gradient) it equals the
  port's unsharded gradient at that test's tolerance, atol 1e-8 and rtol
  1e-5.  With every leaf perturbed, so that every leaf gets a gradient
  (through the marked per-VN terms too), each leaf is within a relative
  L2 error of 1e-5 of the unsharded one: float32 noise from the order of
  the cross-shard sums (measured 0.3e-6 to 2.6e-6), where a misplaced mark
  would be off by a factor of the shard count.  Against JAX's unsharded
  ``jax.grad`` it is held to the rule that holds the port's unsharded
  gradient to JAX's (tests/test_torch_train.py: relative L2 <= 1e-3 a
  leaf; the two packages' math libraries differ by an ulp, which BP
  amplifies well past rtol 1e-5).
* Data-parallel stage 2 on shared stage-1 features: loss and gradients
  equal the single-process full-batch step's within PERF.md section 2's
  rule (rtol 1e-4; relative L2 <= 1e-3 a leaf).
* The whole sharded step, (data 2, edge 1) and (data 2, edge 2), against
  the single-process step as JAX holds it (test_sharding.py): loss at
  rtol 1e-5, flagged_bler equal, gradient cosine > 0.75 (stage 1 on
  summation-reordered features is chaotic).
* Two steps of Adam keep every rank's parameters identical.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders import init_feedback_gnn as j_init
from feedback_gnn_tpu.train.trainer import TrainConfig as JTrainConfig
from feedback_gnn_tpu.train.trainer import stage_two_loss as j_stage_two_loss

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.decoders import params_from_numpy
from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths
from feedback_gnn_tpu_torch.parallel.launch import launch
from feedback_gnn_tpu_torch.parallel.workers import run_tasks
from feedback_gnn_tpu_torch.train import trainer as tt

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
GRAD_REL = 1e-3
REORDER_REL = 1e-5
STAGE_TWO = dict(num_iter1=2, num_iter2=8, loss_from=4)  # test_sharding.py's exact-gradient case
STEP = dict(num_iter1=8, num_iter2=8, loss_from=4)  # its whole-step case
LAUNCH = dict(device="cpu", timeout_s=60.0, join_timeout_s=240.0)


class Setup:
    def __init__(self):
        self.jg = JQuantumGraph.from_code(jc.create_generalized_bicycle_codes(*GB48), stage_mode=True)
        self.host = tc.QuantumGraph.from_code(tc.create_generalized_bicycle_codes(*GB48), stage_mode=True)
        self.graph = self.host.to("cpu")
        rng = np.random.default_rng(0)
        # JAX's init with llr_inv_embed's zero kernel perturbed like every
        # other leaf, so that every leaf gets a gradient
        self.init_np = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(3)))
        self.params_np = jax.tree_util.tree_map(
            lambda a: a + 0.3 * rng.standard_normal(np.shape(a)).astype(np.float32), self.init_np)
        n = self.host.n
        # test_sharding.py's stage-2 case: B=16, p=0.06, fixed features
        b = 16
        self.nx, self.nz = ((rng.random((n, b)) < 0.06).astype(np.float32) for _ in range(2))
        mx, mz = self.host.gx.num_cn, self.host.gz.num_cn
        self.h_vn = (rng.standard_normal((3, n, b)) * 2).astype(np.float32)
        self.lhx = rng.standard_normal((mx, b)).astype(np.float32)
        self.lhz = rng.standard_normal((mz, b)).astype(np.float32)
        # its whole-step case: B=32 (two data ranks of 16)
        self.sx, self.sz = ((rng.random((n, 32)) < 0.06).astype(np.float32) for _ in range(2))
        with torch.no_grad():
            self.features = [f.numpy() for f in tt.stage_one_features(
                self.graph, tt.TrainConfig(**STEP), torch.as_tensor(self.sx), torch.as_tensor(self.sz))]

    def tparams(self, params_np=None):
        params = params_from_numpy(self.params_np if params_np is None else params_np)
        for leaf in flatten_with_paths(params).values():
            leaf.requires_grad_(True)
        return params

    def step_reference(self, features=None):
        """The single-process step on the whole batch: (loss, flagged_bler,
        bler) and {path: gradient}, parameters left as they are."""
        params, opt = self.tparams(), tt.ClipAdam(0.0, 1e30)
        state = opt.init(params)
        cfg = tt.TrainConfig(**STEP)
        nx, nz = torch.as_tensor(self.sx), torch.as_tensor(self.sz)
        if features is None:
            _, _, loss, fb, bl = tt.make_train_step(self.graph, cfg, opt)(params, state, nx, nz)
        else:
            loss, (s_hat, ls_hat) = tt.stage_two_loss(params, self.graph, cfg, nx, nz,
                                                      *(torch.as_tensor(f) for f in features))
            loss.backward()
            fb = (s_hat != 0).any(dim=0).float().mean()
            bl = (ls_hat != 0).any(dim=0).float().mean()
        grads = {k: v.grad.numpy() for k, v in flatten_with_paths(params).items()}
        return (float(loss), float(fb), float(bl)), grads


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    return Setup()


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """{world: per-rank results} of one launch of 2 and one of 4 ranks."""
    stage_two = dict(graph=setup.host, cfg=tt.TrainConfig(**STAGE_TWO), noise_x=setup.nx,
                     noise_z=setup.nz, h_vn=setup.h_vn, logit_hx=setup.lhx, logit_hz=setup.lhz)
    step = dict(graph=setup.host, params=setup.params_np, cfg=tt.TrainConfig(**STEP), noise_x=setup.sx,
                noise_z=setup.sz)
    tasks = {
        2: [("stage_two_grads", dict(stage_two, edge=2, params=setup.params_np)),
            ("dp_stage_two_grads", dict(step, data=2, features=setup.features)),
            ("train_step", dict(step, mesh_shape=(2, 1))),
            ("train_step", dict(step, mesh_shape=(2, 1), learning_rate=2e-4, grad_clip=10.0, steps=2)),
            ("stage_two_grads", dict(stage_two, edge=2, params=setup.init_np))],
        4: [("train_step", dict(step, mesh_shape=(2, 2))),
            ("stage_two_grads", dict(stage_two, edge=4, params=setup.params_np)),
            ("stage_two_grads", dict(stage_two, edge=4, params=setup.init_np))],
    }
    out = {}
    for world, ts in tasks.items():
        t0 = time.perf_counter()
        out[world] = launch(run_tasks, world, args=(ts, "cpu"),
                            store_dir=str(tmp_path_factory.mktemp("store")), **LAUNCH)
        out[world, "seconds"] = time.perf_counter() - t0
    return out


def _rel_l2(out, ref):
    return max(np.linalg.norm(out[k] - ref[k]) / np.linalg.norm(ref[k]) for k in ref)


def _cosine(out, ref):
    a = np.concatenate([out[k].ravel() for k in ref])
    b = np.concatenate([ref[k].ravel() for k in ref])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _stage_two_reference(setup, params_np):
    """The port's unsharded stage-2 loss and gradients on the fixed features."""
    params = setup.tparams(params_np)
    loss, _ = tt.stage_two_loss(params, setup.graph, tt.TrainConfig(**STAGE_TWO),
                                *(torch.as_tensor(a) for a in (setup.nx, setup.nz, setup.h_vn,
                                                               setup.lhx, setup.lhz)))
    loss.backward()
    return loss.item(), {k: v.grad.numpy() for k, v in flatten_with_paths(params).items()}


def _stage_two_results(ranks, world, init):
    """Every rank's (loss, grads) of the stage-2 task at the JAX init or
    the perturbed parameters."""
    index = {(2, False): 0, (2, True): 4, (4, False): 1, (4, True): 2}[world, init]
    return [r[index] for r in ranks[world]]


@pytest.mark.parametrize("edge", [2, 4])
def test_stage_two_grad_edge_sharded_exact(setup, ranks, edge):
    """test_sharding.py's case: with fixed stage-1 features the edge-sharded
    stage-2 gradient equals the unsharded one to float32 exactness."""
    ref_loss, ref = _stage_two_reference(setup, setup.init_np)
    for loss, grads in _stage_two_results(ranks, edge, init=True):
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        for k, g in ref.items():
            np.testing.assert_allclose(grads[k], g, atol=1e-8, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("edge", [2, 4])
def test_stage_two_grad_edge_sharded_every_leaf(setup, ranks, edge):
    """Every leaf with a gradient: the edge-sharded gradient is the
    unsharded one up to the float32 noise of the reordered sums."""
    ref_loss, ref = _stage_two_reference(setup, setup.params_np)
    for loss, grads in _stage_two_results(ranks, edge, init=False):
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        for k, g in ref.items():
            assert np.abs(g).max() > 0, k
            assert np.linalg.norm(grads[k] - g) / np.linalg.norm(g) <= REORDER_REL, k


def test_stage_two_grad_edge_sharded_matches_jax(setup, ranks):
    """The edge-sharded stage-2 gradient against JAX's unsharded jax.grad."""
    jcfg = JTrainConfig(**STAGE_TWO)
    args = [jnp.asarray(a) for a in (setup.nx, setup.nz, setup.h_vn, setup.lhx, setup.lhz)]
    grads = jax.jit(jax.grad(lambda p: j_stage_two_loss(p, setup.jg, jcfg, *args)[0]))(
        jax.tree_util.tree_map(jnp.asarray, setup.params_np))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    ref = {"/".join(str(p).strip("[].'") for p in path): np.asarray(g) for path, g in flat}
    for _, out in _stage_two_results(ranks, 2, init=False):
        assert _rel_l2(out, ref) <= GRAD_REL


def test_dp_stage_two_on_shared_features(setup, ranks):
    """Data-parallel stage 2 on the single process's stage-1 features: the
    averaged loss and gradients are the full batch's."""
    (loss, fb, bl), ref = setup.step_reference(setup.features)
    for r in (r[1] for r in ranks[2]):
        (l2, fb2, bl2), = r["rates"]
        np.testing.assert_allclose(l2, loss, rtol=1e-4)
        assert (fb2, bl2) == (fb, bl)
        assert _rel_l2(r["grads"], ref) <= GRAD_REL


@pytest.mark.parametrize("layout", ["data2", "data2_edge2"])
def test_sharded_train_step_matches_unsharded(setup, ranks, layout):
    """The whole step on (data 2, edge 1) and (data 2, edge 2) against the
    single-process step, as test_sharding.py holds JAX's."""
    (loss, fb, _), ref = setup.step_reference()
    results = [r[2] for r in ranks[2]] if layout == "data2" else [r[0] for r in ranks[4]]
    for r in results:
        (l2, fb2, _), = r["rates"]
        np.testing.assert_allclose(l2, loss, rtol=1e-5)
        np.testing.assert_allclose(fb2, fb, rtol=1e-6)
        assert _cosine(r["grads"], ref) > 0.75
    # every rank holds the same averaged gradient
    for r in results[1:]:
        for k, g in results[0]["grads"].items():
            np.testing.assert_array_equal(r["grads"][k], g)


def test_sharded_adam_keeps_ranks_identical(setup, ranks):
    """Two clipped Adam steps: the parameters move and stay the same on
    every rank."""
    a, b = (r[3] for r in ranks[2])
    assert len(a["rates"]) == 2 and a["rates"] == b["rates"]
    start = {k: v.detach().numpy() for k, v in flatten_with_paths(setup.tparams()).items()}
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
        assert not np.array_equal(a["params"][k], start[k]), k
