"""The fused feedback-GNN kernel (csrc/gnn_feedback.cu) against the plain
version, on a card.

These tests carry the ``gpu`` mark and skip where no CUDA card is found.
They import no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gnn_fused.py

On the graphs of both paper codes (the 3-slot instance) and GB-48 (VN
degree 4: the 8-slot instance), at the cascade's sub-batches and a few
others, with both shipped weight files and a fresh ``init_feedback_gnn``,
every output row, pad rows included, is held to the plain version within
|fused - plain| / max(|plain|, 1) <= 1e-5: both are float32 with accurate
tanh, summed in other orders (the plain float32 version against a float64
one: ~3e-7 at these inputs, measured on the CPU).  Two calls give the same
bits, and each call counts one ``fused`` launch.  Autograd keeps the plain
version on the card; a call the kernel cannot take raises.
"""

import copy

import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import obs
from feedback_gnn_tpu_torch.decoders import gnn_feedback as gf
from feedback_gnn_tpu_torch.entry import WEIGHTS
from feedback_gnn_tpu_torch.io.checkpoint import flatten_with_paths

TOL = 1e-5
CODES = {
    "n882": tc.ghp_882_24,
    "n1270": tc.ghp_1270_28,
    "gb48": lambda: tc.create_generalized_bicycle_codes(24, [0, 2, 8, 15], [0, 2, 12, 17]),
}
BATCHES = [1, 1000, 1024, 1664, 8192]
_GRAPHS = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in float32
    return torch.device("cuda")


def _graph(code, dev):
    if code not in _GRAPHS:
        _GRAPHS[code] = tc.QuantumGraph.from_code(CODES[code](), stage_mode=True).to(dev)
    return _GRAPHS[code]


def _params(weights, dev):
    if weights == "fresh":
        return gf.init_feedback_gnn(torch.Generator(device=dev).manual_seed(5))
    return gf.load_weights(WEIGHTS[weights], dev)


def _inputs(graph, b, dev, seed=0):
    """The cascade's layout: marginals [3, n_pad, B], check logits on every
    padded row, syndromes [m, B] int32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gx, gz = graph.gx, graph.gz
    return (torch.randn((3, gx.n_pad, b), generator=g, device=dev) * 3.0,
            torch.randn((gx.c_pad, b), generator=g, device=dev) * 2.0,
            torch.randn((gz.c_pad, b), generator=g, device=dev) * 2.0,
            torch.randint(0, 2, (gx.num_cn, b), generator=g, device=dev, dtype=torch.int32),
            torch.randint(0, 2, (gz.num_cn, b), generator=g, device=dev, dtype=torch.int32))


def _gap(out, ref):
    return float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("weights", ["n882", "n1270", "fresh"])
@pytest.mark.parametrize("b", BATCHES)
def test_fused_matches_plain(card, code, weights, b):
    graph, params = _graph(code, card), _params(weights, card)
    args = _inputs(graph, b, card, seed=b)
    obs.reset()
    with torch.no_grad():
        out = gf.feedback_gnn_apply(params, graph, *args)
        again = gf.feedback_gnn_apply(params, graph, *args)
        ref = gf.feedback_gnn_apply_plain(params, graph, *args)
    torch.cuda.synchronize()
    assert obs.snapshot()["keys"]["gnn.launches"] == {("fused", b): 2}
    assert out.shape == ref.shape == (3, graph.gx.n_pad, b)
    assert torch.equal(out, again)
    assert _gap(out, ref) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("code", sorted(CODES))
def test_fused_takes_the_cascade_inputs_as_they_come(card, code):
    """[3, n, B] marginals, check logits and syndromes on the true rows
    only, no biases in the edge MLPs, an output kernel at the glorot
    scale: still within TOL of the plain version.  Float syndromes raise
    (the kernel reads mod2_matmul's int32)."""
    graph = _graph(code, card)
    params = copy.deepcopy(_params("fresh", card))
    params["llr_inv_embed"]["kernel"] = torch.rand((40, 3), generator=torch.Generator(device=card).manual_seed(6),
                                                   device=card) - 0.5
    for layer in params["msg_mlp_x"] + params["msg_mlp_z"]:
        del layer["bias"]
    h, lx, lz, sx, sz = _inputs(graph, 512, card, seed=1)
    args = (h[:, :graph.gx.num_vn], lx[:graph.gx.num_cn], lz[:graph.gz.num_cn], sx, sz)
    with torch.no_grad():
        out = gf.feedback_gnn_apply(params, graph, *args)
        ref = gf.feedback_gnn_apply_plain(params, graph, *args)
        with pytest.raises(ValueError, match="syndromes"):
            gf.feedback_gnn_apply(params, graph, *args[:3], sx.float(), sz)
    assert _gap(out, ref) <= TOL


@pytest.mark.gpu
def test_autograd_on_the_card_keeps_the_plain_path(card):
    graph, params = _graph("n882", card), _params("n882", card)
    leaf = copy.deepcopy(params)
    for t in flatten_with_paths(leaf).values():
        t.requires_grad_(True)
    obs.reset()
    out = gf.feedback_gnn_apply(leaf, graph, *_inputs(graph, 64, card))
    out.sum().backward()
    assert obs.snapshot()["keys"]["gnn.launches"] == {("plain", 64): 1}
    assert all(t.grad is not None for t in flatten_with_paths(leaf).values())


@pytest.mark.gpu
def test_the_card_raises_for_a_call_the_kernel_cannot_take(card):
    """A 3-layer MLP and float64 marginals raise on the card, with nothing
    counted: no call falls back there to the plain version."""
    graph = _graph("n882", card)
    deep = gf.init_feedback_gnn(torch.Generator(device=card).manual_seed(2), num_mlp_layers=3)
    h, *rest = _inputs(graph, 64, card)
    obs.reset()
    with torch.no_grad():
        with pytest.raises(ValueError, match="depths"):
            gf.feedback_gnn_apply(deep, graph, h, *rest)
        with pytest.raises(ValueError, match="float32"):
            gf.feedback_gnn_apply(_params("n882", card), graph, h.double(), *rest)
    assert "gnn.launches" not in obs.snapshot()["keys"]
