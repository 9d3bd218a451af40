"""Where the feedback-GNN step runs, checked on the CPU.

``feedback_gnn_apply`` runs CPU tensors on the plain version and counts
nothing.  On a card it launches the fused kernel (csrc/gnn_feedback.cu),
keeps the plain version for an edge shard or a gradient to carry, and
raises for any other call the kernel cannot take; the counter
``gnn.launches`` says which path ran, keyed by path and batch.  The kernel
runs only on a card (tests/test_torch_gnn_fused.py holds it to the plain
version there); here: the plain path on CPU tensors, the card's dispatch
with the card faked (a CPU tensor whose ``is_cuda`` reads True, the
launcher or its library faked), the instance the kernel takes for a call,
the calls it refuses, the arguments the launcher hands the library, and
the instance list of the source.  Imports no CUDA, no triton and no JAX.
"""

import contextlib
import copy
import os
import re
import types

import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import _build, obs
from feedback_gnn_tpu_torch.decoders import gnn_feedback as gf
from feedback_gnn_tpu_torch.decoders.gnn_feedback import feedback_gnn_apply, init_feedback_gnn, load_weights
from feedback_gnn_tpu_torch.entry import WEIGHTS
from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
CSRC = os.path.join(os.path.dirname(gf.__file__), os.pardir, "csrc", "gnn_feedback.cu")


@pytest.fixture(autouse=True)
def fresh_registry():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def graph():
    torch.set_num_threads(1)  # several test workers share the cores
    return tc.QuantumGraph.from_code(tc.create_generalized_bicycle_codes(*GB48), stage_mode=True).to("cpu")


@pytest.fixture(scope="module")
def params():
    return load_weights(WEIGHTS["n882"], "cpu")


def _inputs(graph, b, seed=0, h_rows=None, syn_dtype=torch.int32):
    g = torch.Generator().manual_seed(seed)
    gx, gz = graph.gx, graph.gz
    h_rows = gx.n_pad if h_rows is None else h_rows
    return (torch.randn((3, h_rows, b), generator=g) * 3.0,
            torch.randn((gx.c_pad, b), generator=g) * 2.0,
            torch.randn((gz.c_pad, b), generator=g) * 2.0,
            torch.randint(0, 2, (gx.num_cn, b), generator=g).to(syn_dtype),
            torch.randint(0, 2, (gz.num_cn, b), generator=g).to(syn_dtype))


def _keys():
    return obs.snapshot()["keys"].get("gnn.launches", {})


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a card's: ``feedback_gnn_apply`` takes
    the card's branch for it."""

    is_cuda = True


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.fixture
def fused_calls(monkeypatch):
    """The fused launcher faked: records each call and returns zeros."""
    calls = []

    def launch(params, graph, h_vn, *rest):
        calls.append(h_vn.shape[-1])
        return torch.zeros((3, graph.gx.n_pad, h_vn.shape[-1]))

    monkeypatch.setattr(gf, "_launch_fused", launch)
    return calls


def test_cpu_tensors_take_the_plain_path_and_count_nothing(graph, params):
    args = _inputs(graph, 16)
    out = feedback_gnn_apply(params, graph, *args)
    feedback_gnn_apply(params, graph, *_inputs(graph, 8))
    assert out.shape == (3, graph.gx.n_pad, 16)
    assert torch.equal(out, gf.feedback_gnn_apply_plain(params, graph, *args))
    assert _keys() == {} and obs.counter("gnn.launches") == 0


def test_the_card_fuses_every_call_without_a_shard_or_a_gradient(graph, params, fused_calls):
    h, *rest = _inputs(graph, 16)
    feedback_gnn_apply(params, graph, _card(h), *rest)
    with torch.no_grad():
        feedback_gnn_apply(params, graph, _card(h[..., :8]), *(t[:, :8] for t in rest))
    assert fused_calls == [16, 8]
    assert _keys() == {}  # the real launcher counts "fused" itself (test_the_launcher_hands_the_library_the_call)


@pytest.mark.parametrize("name", ["n882", "n1270"])
def test_the_paper_codes_pick_the_three_slot_instance(name):
    graph = tc.QuantumGraph.from_code(tc.ghp_882_24() if name == "n882" else tc.ghp_1270_28(),
                                      stage_mode=True).to("cpu")
    args = _inputs(graph, 4)
    with torch.no_grad():
        assert gf._fused_instance(load_weights(WEIGHTS[name], "cpu"), graph, *args)[0] == (40, 20, 3)


def test_the_instance_follows_the_widths_and_the_degree(graph, params):
    args = _inputs(graph, 4)
    assert gf._fused_instance(params, graph, *args)[0] == (40, 20, 8)  # GB-48: VN degree 4
    fresh = init_feedback_gnn(torch.Generator().manual_seed(1))
    assert gf._fused_instance(fresh, graph, *args)[0] == (40, 20, 8)
    for widths in [(20, 40), (32, 20)]:  # no instance
        other = init_feedback_gnn(torch.Generator().manual_seed(1), num_msg_dims=widths[1],
                                  num_hidden_units=widths[0])
        with pytest.raises(ValueError, match="widths"):
            gf._fused_instance(other, graph, *args)
    no_bias = copy.deepcopy(params)
    for layer in [no_bias["llr_inv_embed"], *no_bias["msg_mlp_x"], *no_bias["embed_mlp"]]:
        del layer["bias"]
    instance, layers = gf._fused_instance(no_bias, graph, *args)
    assert instance == (40, 20, 8) and [t is None for t in layers].count(True) == 4
    # a pad-free marginal input ([3, n, B]); syndromes int32 (mod2_matmul's) and nothing else
    short = _inputs(graph, 4, h_rows=graph.gx.num_vn)
    assert gf._fused_instance(params, graph, *short)[0] == (40, 20, 8)
    for dtype in (torch.float32, torch.int64, torch.uint8, torch.bool):
        with pytest.raises(ValueError, match="syndromes"):
            gf._fused_instance(params, graph, *_inputs(graph, 4, syn_dtype=dtype))


def test_autograd_keeps_the_plain_path_and_every_parameter_gets_its_gradient(graph, params, fused_calls):
    args = _inputs(graph, 8)
    leaf = copy.deepcopy(params)
    leaves = list(flatten_with_paths(leaf).values())
    for t in leaves:
        t.requires_grad_(True)
    assert gf._carries_gradient(leaf, args)
    with torch.no_grad():  # the same call with nothing to differentiate fuses
        assert not gf._carries_gradient(leaf, args)
    h = args[0].clone().requires_grad_(True)
    assert gf._carries_gradient(params, (h, *args[1:]))
    assert not gf._carries_gradient(params, args)
    out = feedback_gnn_apply(leaf, graph, _card(args[0]), *args[1:])
    out[:, :graph.gx.num_vn].square().sum().backward()
    assert _keys() == {("plain", 8): 1} and fused_calls == []
    for t in leaves:
        assert t.grad is not None and bool((t.grad != 0).any())


def test_an_edge_shard_keeps_the_plain_path(graph, params, monkeypatch, fused_calls):
    """``axis`` set on the card: the plain path, counted; with the
    collectives made the identity (a group of one), the same output as the
    plain version without a shard."""
    axis = object()
    args = _inputs(graph, 8)
    monkeypatch.setattr(gf, "psum", lambda x, group: x)
    monkeypatch.setattr(gf, "pvary", lambda x, group: x)
    monkeypatch.setattr(gf, "pvary_tree", lambda tree, group: tree)
    with torch.no_grad():
        out = feedback_gnn_apply(params, graph, _card(args[0]), *args[1:], axis=axis)
    torch.testing.assert_close(out.as_subclass(torch.Tensor), gf.feedback_gnn_apply_plain(params, graph, *args),
                               rtol=0, atol=0)
    assert _keys() == {("plain", 8): 1} and fused_calls == []


def test_a_three_layer_mlp_runs_plain_on_the_cpu_and_raises_on_the_card(graph):
    deep = init_feedback_gnn(torch.Generator().manual_seed(2), num_mlp_layers=3)
    args = _inputs(graph, 8)
    with pytest.raises(ValueError, match="depths"):
        gf._fused_instance(deep, graph, *args)
    out = feedback_gnn_apply(deep, graph, *args)
    assert out.shape == (3, graph.gx.n_pad, 8)
    with torch.no_grad(), pytest.raises(ValueError, match="depths"):
        feedback_gnn_apply(deep, graph, _card(args[0]), *args[1:])
    assert _keys() == {}


@pytest.mark.parametrize("case", ["float64", "half syndromes", "logit rows", "batch", "empty", "features"])
def test_inputs_the_kernel_does_not_take_raise(graph, params, case):
    """Each raises ValueError on the card, before any launch; nothing
    falls back to the plain version there."""
    h, lx, lz, sx, sz = _inputs(graph, 8)
    if case == "float64":
        h = h.double()
    elif case == "half syndromes":
        sx = sx.half()
    elif case == "logit rows":
        lx = torch.cat([lx, lx[:1]])
    elif case == "batch":
        sz = sz[:, :4]
    elif case == "empty":
        h, lx, lz, sx, sz = (t[..., :0] for t in (h, lx, lz, sx, sz))
    else:
        h = h[:2]
    with pytest.raises(ValueError):
        gf._fused_instance(params, graph, h, lx, lz, sx, sz)
    with torch.no_grad(), pytest.raises(ValueError):
        feedback_gnn_apply(params, graph, _card(h), lx, lz, sx, sz)
    assert _keys() == {}


def test_the_launcher_hands_the_library_the_call(graph, params, monkeypatch):
    """The fused launcher, its library faked: the rows, degrees, graph
    tables, parameter pointers and strides it passes, its output's shape,
    and its count."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    fake = types.SimpleNamespace(fgt_gnn_feedback_launch=launch, fgt_gnn_feedback_packed_floats=lambda *a: 3964)
    monkeypatch.setattr(_build, "load_kernels", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    gf._packed_floats.cache_clear()
    try:
        h, lx, lz, sx, sz = _inputs(graph, 8, h_rows=graph.gx.num_vn)
        out = gf._launch_fused(params, graph, h, lx, lz, sx, sz)
    finally:
        gf._packed_floats.cache_clear()
    assert out.shape == (3, graph.gx.n_pad, 8) and out.dtype == torch.float32
    (args,) = calls
    gx, gz = graph.gx, graph.gz
    assert args[0] == h.data_ptr() and args[1] == gx.num_vn
    side_x, side_z, rest = args[2:10], args[10:18], args[18:]
    for side, g, logit, syn in ((side_x, gx, lx, sx), (side_z, gz, lz, sz)):
        assert side[0] == logit.data_ptr() and side[1] == g.c_pad
        assert side[2] == syn.data_ptr() and side[3] == g.num_cn
        assert side[4:7] == (g.edge_cn_byslot.data_ptr(), g.vn_mask.data_ptr(), g.vn_deg.data_ptr())
        assert side[7] == g.max_vn_deg
    weights, strides, _packed, out_ptr = rest[:4]
    (ex0, ex1), (ez0, ez1), (emb,), fin = (params[k] for k in ("msg_mlp_x", "msg_mlp_z", "embed_mlp",
                                                               "llr_inv_embed"))
    order = [ex0["kernel"], ez0["kernel"], ex0["bias"], ez0["bias"], ex1["kernel"], ez1["kernel"], ex1["bias"],
             ez1["bias"], emb["kernel"], emb["bias"], fin["kernel"], fin["bias"]]
    assert list(weights) == [t.data_ptr() for t in order]  # the parameters themselves, no copies
    kernels = [t for t in order if t.dim() == 2]
    assert list(strides) == [st for t in kernels for st in t.stride()]
    assert not all(t.is_contiguous() for t in kernels)  # the shipped kernels are column-major
    assert out_ptr == out.data_ptr()
    assert rest[4:] == (gx.n_pad, 8, 40, 20, 8, 7)
    assert _keys() == {("fused", 8): 1}


def test_every_instance_the_dispatch_picks_is_in_the_source():
    with open(CSRC) as f:
        src = f.read()
    (table,) = re.findall(r"#define GNN_INSTANCES\(X\) (.*)", src)
    built = {tuple(int(v) for v in m) for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", table)}
    assert built == {(h, m, s) for h, m in gf.FUSED_WIDTHS for s in gf.FUSED_SLOTS}
