"""The port's multi-device paths (feedback_gnn_tpu_torch/parallel) on the
CPU: ranks are spawned processes joined by Gloo, each on one torch thread,
meeting in a FileStore under the test's temporary directory.

The cases are the port's counterparts of tests/test_sharding.py, at its
sizes (GB-48, 8/4 iterations, 2 rounds):

* ``shard_quantum_graph`` equals JAX's array for array;
* data-parallel evaluation on 2 and 4 ranks (gather and QC decoders, with
  compaction, overflow and the rescue) counts exactly the sum of the same
  per-rank batches run unsharded;
* edge-sharded ``bp4_decode`` against JAX's unsharded one, at
  test_sharding.py's tolerance; edge-sharded BP2, cascade and GNN_BP4
  against the port's unsharded ones;
* the refusals, and cli/bench_scaling.py at a tiny size.

The evaluate CLI and the launcher's safety are in tests/test_torch_parallel_cli.py,
sharded training in tests/test_torch_parallel_train.py.

Each launch runs many layouts on one process group (parallel/workers.py's
``run_tasks``), so the file spawns few processes.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.decoders import bp4_decode as j_bp4_decode
from feedback_gnn_tpu.decoders import init_feedback_gnn as j_init
from feedback_gnn_tpu.ops import mod2_matmul as j_mod2_matmul
from feedback_gnn_tpu.parallel import shard_quantum_graph as j_shard_quantum_graph
from feedback_gnn_tpu.parallel.shard import shard_bounds as j_shard_bounds

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.decoders import CascadeConfig, params_from_numpy
from feedback_gnn_tpu_torch.decoders import gnn_full as tg
from feedback_gnn_tpu_torch.decoders.bp2 import bp2_decode
from feedback_gnn_tpu_torch.decoders.cascade import data_seed, prior_llr, sandwich_decode, sandwich_eval_step
from feedback_gnn_tpu_torch.ops import mod2_matmul
from feedback_gnn_tpu_torch.parallel import Mesh, shard_bounds, shard_quantum_graph, unstack_shard
from feedback_gnn_tpu_torch.parallel.api import make_sharded_eval_step
from feedback_gnn_tpu_torch.parallel.launch import launch
from feedback_gnn_tpu_torch.parallel.workers import run_tasks

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
CFG = CascadeConfig(num_iter1=8, num_iter2=4, num_rounds=2, p0=0.05)
SEEDS = [11, 12]
# data-parallel variants: (cascade overrides, QC decoder, local batch, p)
VARIANTS = {
    "gather": ({}, False, 32, 0.08),
    "qc": ({}, True, 32, 0.08),
    "compact": (dict(compact_fraction=0.5, stage1_prepass=4, round_fraction=0.25), False, 64, 0.08),
    "qc_compact": (dict(compact_fraction=0.5, stage1_prepass=4, qc_batch_tile=16), True, 64, 0.08),
    "rescue": (dict(rescue_phi="accurate", rescue_fraction=1.0), False, 64, 0.12),
    "qc_rescue": (dict(rescue_phi="tf,accurate", rescue_fraction=0.25, qc_batch_tile=16), True, 64,
                  0.12),
    "overflow_tight": (dict(compact_fraction=0.02), False, 64, 0.12),
    "overflow_none": (dict(compact_fraction=1.0), False, 64, 0.12),
}
TRACKED = ("compact", "qc_compact", "rescue", "qc_rescue", "overflow_tight", "overflow_none")
LAUNCH = dict(device="cpu", timeout_s=60.0, join_timeout_s=240.0)
GNN_REDUCE = ["mean", "max"]


class Setup:
    def __init__(self):
        self.jcode = jc.create_generalized_bicycle_codes(*GB48)
        self.jg = JQuantumGraph.from_code(self.jcode, stage_mode=True)
        code = tc.create_generalized_bicycle_codes(*GB48)
        self.host = tc.QuantumGraph.from_code(code, stage_mode=True)
        self.graph = self.host.to("cpu")
        self.qc = tc.qc_pair_from_code(code)
        self.params_np = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(3)))
        self.params = params_from_numpy(self.params_np)
        rng = np.random.default_rng(7)
        n, self.b = self.host.n, 16
        self.noise_x = (rng.random((n, self.b)) < 0.05).astype(np.int32)
        self.noise_z = (rng.random((n, self.b)) < 0.05).astype(np.int32)
        pad = ((0, self.host.n_pad - n), (0, 0))
        self.sx = np.asarray(j_mod2_matmul(self.jg.hx, np.pad(self.noise_z, pad)), np.float32)
        self.sz = np.asarray(j_mod2_matmul(self.jg.hz, np.pad(self.noise_x, pad)), np.float32)
        self.llr0 = np.pad(np.full((3, n, self.b), 3.85, np.float32), ((0, 0),) + pad)
        self.gnn_cfg = tg.GNNBP4Config(num_embed_dims=8, num_msg_dims=8, num_hidden_units=16, num_iter=3)
        gnn = tg.init_gnn_bp4(torch.Generator().manual_seed(1), self.gnn_cfg, self.graph)
        self.gnn_params = {k: [{n_: v.numpy() for n_, v in layer.items()} for layer in v]
                           if isinstance(v, list) else {n_: t.numpy() for n_, t in v.items()}
                           for k, v in gnn.items()}

    def variant(self, name, world):
        over, use_qc, batch, p = VARIANTS[name]
        return dict(mesh_shape=(world, 1), graph=self.host, params=self.params_np,
                    cfg=dataclasses.replace(CFG, **over), local_batch=batch, seeds=SEEDS, p=p,
                    qc=self.qc if use_qc else None, return_overflow=name in TRACKED)

    def unsharded(self, kw, data):
        """Per batch seed: the sums over the data ranks of the unsharded
        step's counts on each rank's own generator."""
        out = []
        for s in kw["seeds"]:
            tot = 0
            for d in range(data):
                gen = torch.Generator().manual_seed(data_seed(s, d))
                c = sandwich_eval_step(self.graph, [self.params], kw["cfg"], gen, kw["p"],
                                       kw["local_batch"], qc=kw["qc"],
                                       return_overflow=kw["return_overflow"])
                tot = tot + np.array([int(x) for x in c])
            out.append(tuple(int(x) for x in tot))
        return out


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    return Setup()


def _tasks(setup, world):
    tasks = [("eval_counts", setup.variant(name, world)) for name in VARIANTS]
    half = dict(graph=setup.host, llr0=setup.llr0, syndrome_x=setup.sx, syndrome_z=setup.sz,
                num_iter=6)
    tasks.append(("bp4", dict(edge=world, **half)))
    if world == 4:  # JAX's (data 2, edge 2) layout
        kw = setup.variant("gather", 2)
        tasks.append(("eval_counts", dict(kw, mesh_shape=(2, 2))))
    else:
        tasks += [
            ("eval_counts", dict(setup.variant("gather", 1), mesh_shape=(1, 2))),
            ("bp2", dict(edge=2, graph=setup.host, llr=np.full((setup.host.n, setup.b), -3.0, np.float32),
                         syndrome=setup.sx, num_iter=3, cn_type="boxplus-phi")),
            ("decode", dict(edge=2, graph=setup.host, params=setup.params_np, cfg=CFG,
                            noise_x=setup.noise_x, noise_z=setup.noise_z)),
        ] + [("gnn_bp4", dict(edge=2, graph=setup.host, params=setup.gnn_params,
                              cfg=setup.gnn_cfg._replace(reduce_op=op), syndrome_x=setup.sx,
                              syndrome_z=setup.sz)) for op in GNN_REDUCE]
    return tasks


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """{world: (tasks, per-rank results)} of one launch of 2 and one of 4
    ranks, and each launch's seconds."""
    out = {}
    for world in (2, 4):
        tasks = _tasks(setup, world)
        t0 = time.perf_counter()
        res = launch(run_tasks, world, args=(tasks, "cpu"), store_dir=str(tmp_path_factory.mktemp("store")),
                     **LAUNCH)
        out[world] = (tasks, res, time.perf_counter() - t0)
    return out


def _result(ranks, world, name, mesh_shape=None):
    """Every rank's result of the named task (and grid)."""
    tasks, res, _ = ranks[world]
    for i, (task, kw) in enumerate(tasks):
        if task == name and (mesh_shape is None or kw.get("mesh_shape") == mesh_shape):
            return kw, [r[i] for r in res]
    raise KeyError(name)


# ---- the graph partition ---------------------------------------------------------


@pytest.mark.parametrize("rows,shards", [(24, 1), (24, 5), (7, 4), (441, 2), (441, 4), (3, 3)])
def test_shard_bounds_match_jax(rows, shards):
    assert shard_bounds(rows, shards) == j_shard_bounds(rows, shards)


@pytest.fixture(scope="module")
def graphs(setup):
    n882_j = JQuantumGraph.from_code(jc.ghp_882_24(), stage_mode=True)
    n882_t = tc.QuantumGraph.from_code(tc.ghp_882_24(), stage_mode=True)
    return {"gb48": (setup.jg, setup.host), "n882": (n882_j, n882_t)}


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("code", ["gb48", "n882"])
def test_shard_quantum_graph_matches_jax(graphs, code, shards):
    jg, hg = graphs[code]
    ref = j_shard_quantum_graph(jg, shards)
    out = shard_quantum_graph(hg, shards)
    for name in tc.QuantumGraph.DENSE:
        np.testing.assert_array_equal(getattr(out, name), np.asarray(getattr(ref, name)))
    for sub, cls in (("gx", tc.TannerGraph), ("gz", tc.TannerGraph), ("logit_rows_x", tc.RowSet),
                     ("logit_rows_z", tc.RowSet)):
        o, r = getattr(out, sub), getattr(ref, sub)
        for f in dataclasses.fields(cls):
            a, b = getattr(o, f.name), getattr(r, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == np.asarray(b).dtype, (sub, f.name)
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{sub}.{f.name}")
            else:
                assert a == b, (sub, f.name, a, b)
    for f in ("n", "k", "hx_perp_rows", "hz_perp_rows", "lx_rows", "lz_rows", "name", "is_shard"):
        assert getattr(out, f) == getattr(ref, f), f
    one = unstack_shard(out, shards - 1)
    assert one.hx.shape == out.hx.shape[1:] and one.gx.vn_mask.shape == out.gx.vn_mask.shape[1:]
    # every real edge sits on exactly one shard
    assert int(out.gx.cn_mask.sum()) == hg.gx.num_edges


# ---- data-parallel evaluation ------------------------------------------------------


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("world", [2, 4])
def test_dp_eval_counts_equal_unsharded_sum(setup, ranks, world, name):
    kw, results = _variant_result(ranks, world, name)
    ref = setup.unsharded(kw, world)
    for rank, r in enumerate(results):
        assert r["counts"] == ref, (rank, r["counts"], ref)
        assert r["backend"] == "gloo" and r["data_index"] == rank
    if name == "overflow_tight":
        assert all(c[2] > 0 and c[0] >= c[2] for c in ref)
    if name in ("overflow_none", "rescue"):
        assert all(c[2] == 0 for c in ref)


def _variant_result(ranks, world, name):
    tasks, res, _ = ranks[world]
    i = list(VARIANTS).index(name)
    assert tasks[i][0] == "eval_counts"
    return tasks[i][1], [r[i] for r in res]


def test_data_and_edge_sharded_eval(setup, ranks):
    """(data 2, edge 2), JAX's layout of test_eval_step_data_and_edge_sharded,
    and (data 1, edge 2): the counts of the unsharded per-data-rank runs."""
    for world, shape in ((4, (2, 2)), (2, (1, 2))):
        kw, results = _result(ranks, world, "eval_counts", shape)
        ref = setup.unsharded(kw, shape[0])
        assert [r["counts"] for r in results] == [ref] * world


# ---- edge-sharded decoders -----------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_bp4_edge_sharded_matches_jax(setup, ranks, world):
    """Edge-partitioned BP4 == JAX's unsharded BP4, at test_sharding.py's
    tolerance (the sum over shards changes the float32 order)."""
    ref = j_bp4_decode(setup.jg, jnp.asarray(setup.llr0), jnp.asarray(setup.sx), jnp.asarray(setup.sz),
                       num_iter=6)
    _, results = _result(ranks, world, "bp4")
    for llrx, x_hat, z_hat in results:
        np.testing.assert_allclose(llrx, np.asarray(ref.llrx), rtol=2e-2, atol=1e-4)
        assert np.mean(x_hat == np.asarray(ref.x_hat)) > 0.999
        assert np.mean(z_hat == np.asarray(ref.z_hat)) > 0.999
    # the replicated marginals are the same on every rank
    for other in results[1:]:
        np.testing.assert_array_equal(other[0], results[0][0])


def test_bp2_edge_sharded_matches_unsharded(setup, ranks):
    kw, results = _result(ranks, 2, "bp2")
    ref = bp2_decode(setup.graph.gx, torch.as_tensor(kw["llr"]), torch.as_tensor(setup.sx), 3)
    for logits, hard in results:
        np.testing.assert_allclose(logits, ref.logits.numpy(), rtol=2e-2, atol=1e-4)
        np.testing.assert_array_equal(hard, ref.hard.numpy())


def test_cascade_edge_sharded_decisions(setup, ranks):
    """The gather cascade on an edge-sharded graph decides every sample as
    the unsharded one on the same noise."""
    _, results = _result(ranks, 2, "decode")
    n, pad = setup.host.n, ((0, setup.host.n_pad - setup.host.n), (0, 0))
    nx, nz = (torch.as_tensor(np.pad(a, pad)) for a in (setup.noise_x, setup.noise_z))
    sx, sz = mod2_matmul(setup.graph.hx, nz), mod2_matmul(setup.graph.hz, nx)
    llr0 = prior_llr(CFG.p0, n, setup.b, n_pad=setup.host.n_pad)
    x_ref, z_ref = sandwich_decode(setup.graph, [setup.params], CFG, llr0, sx, sz, sz, sx)
    for r in results:
        np.testing.assert_array_equal(r["x_hat"], x_ref[:n].numpy())
        np.testing.assert_array_equal(r["z_hat"], z_ref[:n].numpy())


@pytest.mark.parametrize("reduce_op", GNN_REDUCE)
def test_gnn_bp4_edge_sharded_forward(setup, ranks, reduce_op):
    """GNN_BP4 on an edge-sharded graph decides as the unsharded decoder
    (the VN mean summed over the shards; the max taken over them)."""
    tasks, res, _ = ranks[2]
    i = next(i for i, (t, kw) in enumerate(tasks) if t == "gnn_bp4" and kw["cfg"].reduce_op == reduce_op)
    results = [r[i] for r in res]
    rows = tg.make_logit_rowsets(setup.host, "cpu")
    x_ref, z_ref, _ = tg.gnn_bp4_apply(params_from_numpy(setup.gnn_params), setup.graph, rows,
                                       torch.as_tensor(setup.sx), torch.as_tensor(setup.sz),
                                       setup.gnn_cfg._replace(reduce_op=reduce_op))
    for x_hat, z_hat in results:
        np.testing.assert_array_equal(x_hat, x_ref.numpy())
        np.testing.assert_array_equal(z_hat, z_ref.numpy())


# ---- refusals ----------------------------------------------------------------------------


def _fake_mesh(edge):
    """A grid whose groups are never reached: the refusals raise first."""
    return Mesh(data=1, edge=edge, rank=0, data_index=0, edge_index=0, data_group=None,
                edge_group=object(), device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("refused", ["qc", "compact", "rescue"])
def test_edge_sharding_refusals(setup, refused):
    """JAX's refusals: the QC kernel, compaction and the rescue need edge 1."""
    cfg = {"qc": CFG, "compact": dataclasses.replace(CFG, compact_fraction=0.5),
           "rescue": dataclasses.replace(CFG, rescue_phi="tf")}[refused]
    qc = setup.qc if refused == "qc" else None
    stacked = shard_quantum_graph(setup.host, 2)
    if refused == "qc":
        with pytest.raises(ValueError, match="edge shards > 1"):
            make_sharded_eval_step(_fake_mesh(2), stacked, [setup.params], cfg, 16, qc=qc)
    g = unstack_shard(stacked, 0).to("cpu")
    syn = torch.zeros((g.gx.c_pad, 4))
    with pytest.raises(ValueError, match="edge shards 1"):
        sandwich_decode(g, [setup.params], cfg, prior_llr(0.05, g.n, 4, n_pad=g.n_pad), syn, syn, syn,
                        syn, qc=qc, axis=object())


def test_bench_scaling_cli_cpu(capfd):
    """cli/bench_scaling.py at a tiny size: one JSON line a layout, the
    first layout's efficiency 1 by definition, every rank on Gloo."""
    import json

    from feedback_gnn_tpu_torch.cli import bench_scaling

    rows = bench_scaling.main(["--code", "gb48", "--local-batch", "32", "--shards", "1", "2", "--iters",
                               "1", "--iters1", "8", "--iters2", "4", "-nG", "1", "--qc-kernel",
                               "--device", "cpu"])
    printed = [json.loads(line) for line in capfd.readouterr().out.splitlines() if line.startswith("{")]
    assert [r["data_shards"] for r in printed] == [1, 2] and printed[0]["device"] == "cpu"
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    for row in rows:
        assert row["backend"] == "gloo" and row["qc_kernel"] and row["syndromes_per_s"] > 0
        assert len(row["k1_launches_per_rank"]) == row["data_shards"]
