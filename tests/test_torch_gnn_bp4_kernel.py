"""Where GNN_BP4's CN and VN updates run, checked on the CPU.

On a card each update is one launch of its kernel (csrc/gnn_bp4.cu) where
``gnn_full.takes_kernel`` says so, and the plain version otherwise; CPU
tensors always take the plain version and count nothing.  The kernels run
only on a card (tests/test_torch_gpu.py holds them to the plain version
there); here: the dispatch rule as a pure function, the card's dispatch with
the card faked (a CPU tensor whose ``is_cuda`` reads True, the launchers or
their library faked) and its counter ``gnn_bp4.launches``, the calls the
kernel path refuses, the packed weights against the parameter tree, the
arguments the launchers hand the library, the kernels' arithmetic walked in
PyTorch from the packed weights against the plain version, the instance
lists of the source, and that ``gnn_bp4_apply`` reaches the updates, the
logits and the syndrome signs through the module's globals (the benchmark
wraps and patches them by name).  Imports no CUDA, no triton and no JAX.
"""

import contextlib
import copy
import dataclasses
import os
import re
import types

import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import _build, obs
from feedback_gnn_tpu_torch.decoders import gnn_full as gfull
from feedback_gnn_tpu_torch.decoders.gnn_full import GNNBP4Config, init_gnn_bp4, takes_kernel

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
CSRC = os.path.join(os.path.dirname(gfull.__file__), os.pardir, "csrc", "gnn_bp4.cu")
CFG = GNNBP4Config()
TOL = 1e-5


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
def params(graph):
    return init_gnn_bp4(torch.Generator().manual_seed(3), CFG, graph)


def _fake_graph(dc, dv):
    side = types.SimpleNamespace(max_cn_deg=dc, max_vn_deg=dv)
    return types.SimpleNamespace(gx=side, gz=side)


def _embeddings(graph, b, seed=0):
    """(h_vn, h_cn_x, h_cn_z, logit_x, logit_z, sign_x, sign_z): every row,
    pad rows included, drawn."""
    g = torch.Generator().manual_seed(seed)
    gx, gz, e = graph.gx, graph.gz, CFG.num_embed_dims
    h_vn = torch.randn((e, gx.n_pad, b), generator=g)
    h_cn_x, h_cn_z = (torch.randn((e, s.c_pad, b), generator=g) for s in (gx, gz))
    logit_x, logit_z = (torch.randn((s.c_pad, b), generator=g) * 3.0 for s in (gx, gz))
    sign_x, sign_z = (1.0 - 2.0 * torch.randint(0, 2, (s.c_pad, b), generator=g).float() for s in (gx, gz))
    return h_vn, h_cn_x, h_cn_z, logit_x, logit_z, sign_x, sign_z


def _keys():
    return obs.snapshot()["keys"].get("gnn_bp4.launches", {})


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a card's: the updates, which look at the
    tensor's device, take the card's branch."""

    is_cuda = True

    @property
    def device(self):
        return torch.device("cuda")


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


# ---- the dispatch rule ------------------------------------------------------------------------------------

RULE = [  # (case, changes to the config, graph slots (dc, dv), on the card, gradient, axis, takes the kernel)
    ("card", {}, (6, 3), True, False, None, True),
    ("cpu", {}, (6, 3), False, False, None, False),
    ("gradient", {}, (6, 3), True, True, None, False),
    ("edge shard", {}, (6, 3), True, False, object(), False),
    ("attributes", {"use_attributes": True, "node_attribute_dims": 2, "msg_attribute_dims": 2}, (6, 3),
     True, False, None, False),
    ("depth 3", {"num_mlp_layers": 3}, (6, 3), True, False, None, False),
    ("depth 1", {"num_mlp_layers": 1}, (6, 3), True, False, None, False),
    ("tanh", {"activation": "tanh"}, (6, 3), True, False, None, False),
    ("bias", {"use_bias": True}, (6, 3), True, False, None, False),
    ("sum", {"reduce_op": "sum"}, (6, 3), True, False, None, True),
    ("max", {"reduce_op": "max"}, (6, 3), True, False, None, False),
    ("min", {"reduce_op": "min"}, (6, 3), True, False, None, False),
    ("embed widths", {"num_embed_dims": 16}, (6, 3), True, False, None, False),
    ("message widths", {"num_msg_dims": 24}, (6, 3), True, False, None, False),
    ("hidden widths", {"num_hidden_units": 64}, (6, 3), True, False, None, False),
    ("GB-48 slots", {}, (8, 4), True, False, None, True),
    ("fewer slots", {}, (5, 2), True, False, None, True),
    ("CN degree 9", {}, (9, 3), True, False, None, False),
    ("VN degree 5", {}, (6, 5), True, False, None, False),
]


@pytest.mark.parametrize("case,change,slots,on_card,grad,axis,expected", RULE, ids=[r[0] for r in RULE])
def test_the_dispatch_rule(case, change, slots, on_card, grad, axis, expected):
    assert takes_kernel(CFG._replace(**change), _fake_graph(*slots), on_card, grad, axis) is expected


@pytest.mark.parametrize("slots,instance", [((6, 3), (6, 3)), ((5, 2), (6, 3)), ((8, 4), (8, 4)),
                                            ((7, 3), (8, 4)), ((6, 4), (8, 4))])
def test_the_fewest_slots_that_hold_the_degrees(slots, instance):
    assert gfull.kernel_instance(CFG, _fake_graph(*slots)) == ((20, 20, 40), instance)


@pytest.mark.parametrize("name,slots", [("n882", (6, 3)), ("n1270", (6, 3)), ("gb48", (8, 4))])
def test_the_codes_instances(name, slots):
    code = {"n882": tc.ghp_882_24, "n1270": tc.ghp_1270_28,
            "gb48": lambda: tc.create_generalized_bicycle_codes(*GB48)}[name]()
    assert gfull.kernel_instance(CFG, tc.QuantumGraph.from_code(code, stage_mode=True)) == ((20, 20, 40), slots)


# ---- the card's dispatch, faked -----------------------------------------------------------------------------


@pytest.fixture
def launched(monkeypatch):
    """Both launchers faked: each records its update and batch and returns zeros."""
    calls = []

    def cn(params, graph, cfg, h_vn, *rest):
        calls.append(("cn", h_vn.shape[-1]))
        return [torch.zeros((cfg.num_embed_dims, g.c_pad, h_vn.shape[-1])) for g in (graph.gx, graph.gz)]

    def vn(params, graph, cfg, h_cn_x, h_cn_z, h_vn, *rest):
        calls.append(("vn", h_vn.shape[-1]))
        return torch.zeros_like(h_vn)

    monkeypatch.setattr(gfull, "_launch_cn", cn)
    monkeypatch.setattr(gfull, "_launch_vn", vn)
    return calls


def test_cpu_tensors_take_the_plain_path_and_count_nothing(graph, params, launched):
    h_vn, hx, hz, lx, lz, sx, sz = _embeddings(graph, 8)
    out = gfull._update_cn(params, graph, CFG, h_vn, hx, hz, lx, lz)
    ref = gfull._update_cn_plain(params, graph, CFG, h_vn, hx, hz, lx, lz)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert torch.equal(gfull._update_vn(params, graph, CFG, hx, hz, h_vn, sx, sz),
                       gfull._update_vn_plain(params, graph, CFG, hx, hz, h_vn, sx, sz))
    assert launched == [] and _keys() == {}


@pytest.mark.parametrize("update", ["cn", "vn"])
def test_the_card_launches_each_update_and_counts_it(graph, params, launched, update):
    h_vn, hx, hz, lx, lz, sx, sz = _embeddings(graph, 8)
    with torch.no_grad():
        if update == "cn":
            gfull._update_cn(params, graph, CFG, _card(h_vn), hx, hz, lx, lz)
        else:
            gfull._update_vn(params, graph, CFG, hx, hz, _card(h_vn), sx, sz)
    assert launched == [(update, 8)] and _keys() == {("kernel", update, 8): 1}


@pytest.mark.parametrize("update", ["cn", "vn"])
def test_a_gradient_keeps_the_plain_path_on_the_card(graph, params, launched, update):
    leaf = copy.deepcopy(params)
    for t in gfull.flatten_with_paths(leaf).values():
        t.requires_grad_(True)
    h_vn, hx, hz, lx, lz, sx, sz = _embeddings(graph, 4)
    if update == "cn":
        out = gfull._update_cn(leaf, graph, CFG, _card(h_vn), hx, hz, lx, lz)[0]
    else:
        out = gfull._update_vn(leaf, graph, CFG, hx, hz, _card(h_vn), sx, sz)
    out.square().sum().backward()
    assert launched == [] and _keys() == {("plain", update, 4): 1}
    assert leaf[f"{update}_msg_mlp_x"][0]["kernel"].grad is not None


def test_an_edge_shard_and_a_max_keep_the_plain_path_on_the_card(graph, params, launched, monkeypatch):
    monkeypatch.setattr(gfull, "pvary", lambda x, group: x)
    monkeypatch.setattr(gfull, "psum", lambda x, group: x)
    h_vn, hx, hz, lx, lz, sx, sz = _embeddings(graph, 4)
    with torch.no_grad():
        out = gfull._update_vn(params, graph, CFG, hx, hz, _card(h_vn), sx, sz, axis=object())
        gfull._update_cn(params, graph, CFG._replace(reduce_op="max"), _card(h_vn), hx, hz, lx, lz)
    torch.testing.assert_close(out.as_subclass(torch.Tensor),
                               gfull._update_vn_plain(params, graph, CFG, hx, hz, h_vn, sx, sz), rtol=0, atol=0)
    assert launched == [] and _keys() == {("plain", "vn", 4): 1, ("plain", "cn", 4): 1}


# ---- what the kernel path refuses ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["float64", "embeddings", "logit rows", "batch", "empty", "bias", "kernel shape",
                                  "one layer", "float64 weights", "id dtype", "devices"])
@pytest.mark.parametrize("update", ["cn", "vn"])
def test_calls_the_kernel_cannot_take_raise(graph, params, case, update, monkeypatch):
    """Each raises ValueError in the launcher, before the library is
    loaded; nothing falls back to the plain version."""
    monkeypatch.setattr(_build, "load_kernels", lambda: pytest.fail("the library was loaded"))
    h_vn, hx, hz, lx, lz, sx, sz = _embeddings(graph, 8)
    p, g = copy.deepcopy(params), graph
    name = f"{update}_msg_mlp_x"
    if case == "float64":
        h_vn = h_vn.double()
    elif case == "embeddings":
        hx = hx[:10]
    elif case == "logit rows":
        lx, sx = lx[:-1], sx[:-1]
    elif case == "batch":
        lz, sz = lz[:, :4], sz[:, :4]
    elif case == "empty":
        h_vn, hx, hz, lx, lz, sx, sz = (t[..., :0] for t in (h_vn, hx, hz, lx, lz, sx, sz))
    elif case == "bias":
        p[name][1]["bias"] = torch.zeros(CFG.num_msg_dims)
    elif case == "kernel shape":
        p[name][0]["kernel"] = p[name][0]["kernel"][:, :20]
    elif case == "one layer":
        p[name] = p[name][:1]
    elif case == "float64 weights":
        p[name][1]["kernel"] = p[name][1]["kernel"].double()
    elif case == "devices":
        hz, sz = hz.to("meta"), sz.to("meta")
    else:
        side = dataclasses.replace(graph.gz, edge_vn_byslot=graph.gz.edge_vn_byslot.to(torch.int32),
                                   edge_cn_byslot=graph.gz.edge_cn_byslot.to(torch.int32))
        g = dataclasses.replace(graph, gz=side)
    with torch.no_grad(), pytest.raises(ValueError):
        if update == "cn":
            gfull._launch_cn(p, g, CFG, h_vn, hx, hz, lx, lz)
        else:
            gfull._launch_vn(p, g, CFG, hx, hz, h_vn, sx, sz)


@pytest.mark.parametrize("update", ["cn", "vn"])
def test_a_card_call_the_kernel_cannot_take_raises_and_counts_nothing(graph, params, update, monkeypatch):
    monkeypatch.setattr(_build, "load_kernels", lambda: pytest.fail("the library was loaded"))
    h_vn, hx, hz, lx, lz, sx, sz = _embeddings(graph, 8)
    with torch.no_grad(), pytest.raises(ValueError):
        if update == "cn":
            gfull._update_cn(params, graph, CFG, _card(h_vn), hx, hz, lx.double(), lz)
        else:
            gfull._update_vn(params, graph, CFG, hx, hz, _card(h_vn), sx.double(), sz)
    assert _keys() == {}


# ---- the packed weights and the launchers' arguments --------------------------------------------------------

CN_ORDER = ["cn_msg_mlp_x", "cn_embed_mlp_x", "cn_msg_mlp_z", "cn_embed_mlp_z"]
VN_ORDER = ["vn_msg_mlp_x", "vn_msg_mlp_z", "vn_embed_mlp"]


@pytest.mark.parametrize("update", ["cn", "vn"])
@pytest.mark.parametrize("weights", ["fresh", "shipped n882", "shipped gb48"])
def test_the_packed_order_follows_the_parameter_tree(graph, params, update, weights):
    """Each kernel in turn, row-major in its [in, out] layout, whatever its
    strides (the shipped n882 kernels are column-major); the Widths of
    csrc/gnn_bp4.cu: 9,680 floats a CN update, 8,000 a VN update."""
    p = params if weights == "fresh" else gfull.load_shipped(weights.split()[1], "cpu")[0]
    e, m, h = 20, 20, 40
    dims = {"msg": (2 * e, h, m), "cn_embed": (m + e + 1, h, e), "vn_embed": (2 * m + e, h, e)}
    names = CN_ORDER if update == "cn" else VN_ORDER
    mlps = [(n, dims["msg"] if "_msg_" in n else dims[f"{update}_embed"]) for n in names]
    packed = gfull._packed(p, mlps, torch.device("cpu"))
    want = [layer["kernel"] for n in names for layer in p[n]]
    assert packed.numel() == (9680 if update == "cn" else 8000) == sum(t.numel() for t in want)
    at = 0
    for t in want:
        assert torch.equal(packed[at:at + t.numel()].view(t.shape), t)
        at += t.numel()


@pytest.fixture
def fake_library(monkeypatch):
    calls = []

    def record(name):
        def launch(*args):
            calls.append((name, args))
            return 0
        return launch

    fake = types.SimpleNamespace(fgt_gnn_bp4_cn_launch=record("cn"), fgt_gnn_bp4_vn_launch=record("vn"))
    monkeypatch.setattr(_build, "load_kernels", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("reduce_op,mean", [("mean", 1), ("sum", 0)])
def test_the_cn_launcher_hands_the_library_the_call(graph, params, fake_library, reduce_op, mean):
    h_vn, hx, hz, lx, lz, _, _ = _embeddings(graph, 8)
    out = gfull._launch_cn(params, graph, CFG._replace(reduce_op=reduce_op), h_vn, hx, hz, lx, lz)
    ((name, args),) = fake_library
    gx, gz = graph.gx, graph.gz
    assert name == "cn" and args[:2] == (h_vn.data_ptr(), gx.n_pad)
    for side, g, hc, lg, o in ((args[2:10], gx, hx, lx, out[0]), (args[10:18], gz, hz, lz, out[1])):
        assert side == (hc.data_ptr(), lg.data_ptr(), o.data_ptr(), g.edge_vn_byslot.data_ptr(),
                        g.cn_mask.data_ptr(), g.cn_deg.data_ptr(), g.c_pad, g.max_cn_deg)
        assert o.shape == (20, g.c_pad, 8) and o.dtype == torch.float32
    assert args[19:] == (8, mean, 20, 20, 40, 8, 4, 7)  # GB-48: 8 CN slots, 4 a pass


def test_the_vn_launcher_hands_the_library_the_call(graph, params, fake_library):
    h_vn, hx, hz, _, _, sx, sz = _embeddings(graph, 8)
    out = gfull._launch_vn(params, graph, CFG, hx, hz, h_vn, sx, sz)
    ((name, args),) = fake_library
    gx, gz = graph.gx, graph.gz
    assert name == "vn" and args[:3] == (h_vn.data_ptr(), gx.n_pad, out.data_ptr())
    for side, g, hc, sg in ((args[3:10], gx, hx, sx), (args[10:17], gz, hz, sz)):
        assert side == (hc.data_ptr(), sg.data_ptr(), g.edge_cn_byslot.data_ptr(), g.vn_mask.data_ptr(),
                        g.vn_deg.data_ptr(), g.c_pad, g.max_vn_deg)
    assert out.shape == h_vn.shape
    assert args[18:] == (8, 1, 20, 20, 40, 4, 4, 7)


# ---- the kernels' arithmetic, walked in PyTorch from the packed weights ------------------------------------


def _relu_dense(x, w):
    return torch.relu(torch.tensordot(w, x, dims=([0], [0])))


def _message_sum(w0, w1, frm, to, scale):
    """sum over the slots of scale_d relu(W0 . [from_d; to]) W1: layer 1 on
    every slot before the sum, as the kernel computes it."""
    acc = 0.0
    for d in range(frm.shape[1]):
        r = _relu_dense(torch.cat([frm[:, d], to]), w0) * scale[d][None]
        acc = acc + torch.tensordot(w1, r, dims=([0], [0]))
    return acc


def _walk_cn(packed, graph, mean, h_vn, h_cn_x, h_cn_z, logit_x, logit_z, e=20, m=20, h=40):
    msg, cn_in = 2 * e * h + h * m, m + e + 1
    side_len = msg + cn_in * h + h * e
    out = []
    for s, (g, h_cn, logit) in enumerate(((graph.gx, h_cn_x, logit_x), (graph.gz, h_cn_z, logit_z))):
        w = packed[s * side_len:(s + 1) * side_len]
        w0, w1 = w[:2 * e * h].view(2 * e, h), w[2 * e * h:msg].view(h, m)
        v0, v1 = w[msg:msg + cn_in * h].view(cn_in, h), w[msg + cn_in * h:].view(h, e)
        scale = g.cn_mask[:, :, None].expand(-1, -1, h_cn.shape[-1])
        red = _message_sum(w0, w1, h_vn[:, g.edge_vn_byslot], h_cn, scale)
        red = red / g.cn_deg.clamp(min=1.0)[None, :, None] if mean else red
        hid = _relu_dense(torch.cat([red, h_cn, logit[None]]), v0)
        out.append(torch.tensordot(v1, hid, dims=([0], [0])))
    return out


def _walk_vn(packed, graph, mean, h_cn_x, h_cn_z, h_vn, sign_x, sign_z, e=20, m=20, h=40):
    msg = 2 * e * h + h * m
    red = []
    for s, (g, h_cn, sign) in enumerate(((graph.gx, h_cn_x, sign_x), (graph.gz, h_cn_z, sign_z))):
        w = packed[s * msg:(s + 1) * msg]
        w0, w1 = w[:2 * e * h].view(2 * e, h), w[2 * e * h:].view(h, m)
        scale = g.vn_mask[:, :, None] * sign[g.edge_cn_byslot]
        r = _message_sum(w0, w1, h_cn[:, g.edge_cn_byslot], h_vn, scale)
        red.append(r / g.vn_deg.clamp(min=1.0)[None, :, None] if mean else r)
    v = packed[2 * msg:]
    v0, v1 = v[:(2 * m + e) * h].view(2 * m + e, h), v[(2 * m + e) * h:].view(h, e)
    return torch.tensordot(v1, _relu_dense(torch.cat([red[0], red[1], h_vn]), v0), dims=([0], [0]))


def _gap(out, ref):
    return float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())


@pytest.mark.parametrize("reduce_op", ["mean", "sum"])
@pytest.mark.parametrize("code", ["gb48", "n882"])
def test_the_kernels_arithmetic_matches_the_plain_version(graph, reduce_op, code):
    """Every row, pad rows included, within 1e-5 of the plain version: the
    packed layout, layer 1 before the slot sum, the signs and masks folded
    into it, the mean's division; the zero logits of iteration 0 too."""
    if code == "n882":
        g = tc.QuantumGraph.from_code(tc.ghp_882_24(), stage_mode=True).to("cpu")
        p = gfull.load_shipped("n882", "cpu")[0]
    else:
        g, p = graph, gfull.load_shipped("gb48", "cpu")[0]
    cfg = CFG._replace(reduce_op=reduce_op)
    e, m, h = 20, 20, 40
    h_vn, hx, hz, lx, lz, sx, sz = _embeddings(g, 3, seed=5)
    mean = reduce_op == "mean"
    cn_mlps = [(n, (2 * e, h, m) if "_msg_" in n else (m + e + 1, h, e)) for n in CN_ORDER]
    vn_mlps = [(n, (2 * e, h, m) if "_msg_" in n else (2 * m + e, h, e)) for n in VN_ORDER]
    with torch.no_grad():
        cn_packed, vn_packed = (gfull._packed(p, mlps, torch.device("cpu")) for mlps in (cn_mlps, vn_mlps))
        for logits in ((lx, lz), (torch.zeros_like(lx), torch.zeros_like(lz))):
            walked = _walk_cn(cn_packed, g, mean, h_vn, hx, hz, *logits)
            plain = gfull._update_cn_plain(p, g, cfg, h_vn, hx, hz, *logits)
            assert max(_gap(a, b) for a, b in zip(walked, plain)) <= TOL
        walked = _walk_vn(vn_packed, g, mean, hx, hz, h_vn, sx, sz)
        assert _gap(walked, gfull._update_vn_plain(p, g, cfg, hx, hz, h_vn, sx, sz)) <= TOL


# ---- the source's instances and the decode's globals -------------------------------------------------------


def test_every_instance_the_dispatch_picks_is_in_the_source():
    with open(CSRC) as f:
        src = f.read()
    built = {}
    for update in ("CN", "VN"):
        (table,) = re.findall(rf"#define BP4_{update}_INSTANCES\(X\) (.*)", src)
        built[update] = {tuple(int(v) for v in t) for t in re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)",
                                                                         table)}
    want_cn = {(*w, dc, sp[0]) for w in gfull.KERNEL_WIDTHS for (dc, _), sp in gfull.KERNEL_SLOTS.items()}
    want_vn = {(*w, dv, sp[1]) for w in gfull.KERNEL_WIDTHS for (_, dv), sp in gfull.KERNEL_SLOTS.items()}
    assert built == {"CN": want_cn, "VN": want_vn}


def test_the_decode_reaches_its_parts_through_the_module(graph, params, monkeypatch):
    """gnn_bp4_apply calls _update_cn, _update_vn, _cal_logit and
    _syndrome_pm by their module names, so the benchmark's wrappers and
    faults, which patch them there, see every call: 8 iterations make 8 CN
    updates (the first with zero logits), 8 VN updates, 8 logits and 2 sign
    tables."""
    calls = {name: 0 for name in ("_update_cn", "_update_vn", "_cal_logit", "_syndrome_pm")}
    for name in calls:
        orig = getattr(gfull, name)

        def counted(*args, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*args, **kw)

        monkeypatch.setattr(gfull, name, counted)
    rs = gfull.make_logit_rowsets(tc.QuantumGraph.from_code(tc.create_generalized_bicycle_codes(*GB48),
                                                            stage_mode=True), "cpu")
    g = torch.Generator().manual_seed(1)
    sx = torch.randint(0, 2, (graph.gx.num_cn, 4), generator=g, dtype=torch.int32)
    sz = torch.randint(0, 2, (graph.gz.num_cn, 4), generator=g, dtype=torch.int32)
    with torch.no_grad():
        gfull.gnn_bp4_apply(params, graph, rs, sx, sz, CFG._replace(num_iter=8))
    assert calls == {"_update_cn": 8, "_update_vn": 8, "_cal_logit": 8, "_syndrome_pm": 2}
