"""The GF(2) product (ops/gf2mat.py), checked on the CPU.

``mod2_matmul`` runs CPU tensors on ``mod2_matmul_plain`` and loads no
library.  On a card it launches the kernel (csrc/gf2mat.cu), which runs
only there (tests/test_torch_gpu.py holds it to the plain version on the
card).  Here: the row lists against the dense matrices of both paper codes,
the CPU product against the plain version and the JAX package's on rows
whose sums exceed 256, the kernel's algorithm walked in PyTorch (ballot
packing, the row lists' XOR, the bits out) against the plain version, the
card's dispatch with the card and library faked (the arguments handed to
the library, the counter, the checks that raise before any launch) and the
row lists' cache.
"""

import contextlib
import gc
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu.ops.gf2mat import mod2_matmul as jax_mod2_matmul
from feedback_gnn_tpu_torch import _build, obs
from feedback_gnn_tpu_torch.codes import QuantumGraph
from feedback_gnn_tpu_torch.ops import gf2mat
from feedback_gnn_tpu_torch.ops.gf2mat import mod2_matmul, mod2_matmul_plain, row_lists

CODES = {"n882": tc.ghp_882_24, "n1270": tc.ghp_1270_28}
MATRICES = [(code, mat) for code in CODES for mat in QuantumGraph.DENSE]
_GRAPHS = {}


@pytest.fixture(autouse=True)
def fresh_registry():
    torch.set_num_threads(1)  # several test workers share the cores
    obs.reset()
    yield
    obs.reset()


def _graph(code):
    if code not in _GRAPHS:
        _GRAPHS[code] = QuantumGraph.from_code(CODES[code](), stage_mode=True).to("cpu")
    return _GRAPHS[code]


def _batch(n, b, seed, p=0.3):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, b), generator=g) < p).to(torch.int32)


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a card's: ``mod2_matmul`` takes the
    card's branch for it."""

    is_cuda = True


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.fixture
def fake_library(monkeypatch):
    """The kernels' library faked: records each launch and returns the
    code in ``result`` (0 = ok)."""
    calls, result = [], [0]

    def launch(*args):
        calls.append(args)
        return result[0]

    fake = types.SimpleNamespace(fgt_gf2_matmul_launch=launch, fgt_cuda_error_string=lambda err: b"refused")
    monkeypatch.setattr(_build, "load_kernels", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    gf2mat._ROWS.clear()
    yield calls, result
    gf2mat._ROWS.clear()


def _keys():
    return obs.snapshot()["keys"].get("gf2.launches", {})


@pytest.mark.parametrize("code,mat", MATRICES)
def test_row_lists_rebuild_the_dense_matrix(code, mat):
    """Every row's columns, ascending, padded with the zero word's index n
    to its slice's heaviest row, and nothing else: pad rows empty, the
    346-weight rows of [[1270,28]]'s hx_perp whole."""
    h = getattr(_graph(code), mat)
    slices, cols = row_lists(h)
    m, n = h.shape
    count = -(-m // 32)
    assert slices.dtype == torch.int32 and cols.dtype == torch.int16 and slices.shape == (count + 1,)
    assert int(slices[0]) == 0 and int(slices[-1]) == cols.shape[0]
    cols = cols.to(torch.int32) & 0xFFFF  # the kernel's uint16
    weights = (h != 0).sum(dim=1)
    dense = torch.zeros((m, n + 1), dtype=torch.bool)
    for t in range(count):
        table = cols[slices[t]:slices[t + 1]].view(-1, 32)  # [width, 32]: column k of lane's row
        assert table.shape[0] == int(weights[32 * t:32 * t + 32].max())
        for lane in range(min(32, m - 32 * t)):
            row = table[:, lane]
            real = row[row != n]
            assert torch.equal(row[:real.shape[0]], real) and torch.all(real[1:] > real[:-1])
            dense[32 * t + lane, real.long()] = True
        assert torch.all(table[:, min(32, m - 32 * t):] == n)
    assert torch.equal(dense[:, :n], h != 0)
    assert int((weights == 0).sum()) > 0  # the graph's pad rows
    if (code, mat) == ("n1270", "hx_perp"):
        assert int(weights.max()) == 346


@pytest.mark.parametrize("code,mat", [(c, m) for c in CODES for m in ("hx_perp", "hz_perp", "lx", "lz")])
def test_cpu_product_equals_plain_and_jax_past_256(code, mat):
    """On the CPU mod2_matmul is the plain version, equal to the JAX
    package's product, on samples whose row sums exceed 256 (an all-ones
    sample sums each row's weight; 346 and 338 on [[1270,28]]'s hx_perp
    and lz)."""
    h = getattr(_graph(code), mat)
    v = _batch(h.shape[1], 40, 3)
    v[:, 0] = 1
    v[:, 1] = 0
    out = mod2_matmul(h, v)
    assert out.dtype == torch.int32 and out.shape == (h.shape[0], 40)
    assert torch.equal(out, mod2_matmul_plain(h, v))
    assert np.array_equal(out.numpy(), np.asarray(jax_mod2_matmul(jnp.asarray(h.numpy()), jnp.asarray(v.numpy()))))
    weights = (h != 0).sum(dim=1).to(torch.int32)
    assert torch.equal(out[:, 0], weights & 1) and not out[:, 1].any()
    if (code, mat) in (("n1270", "hx_perp"), ("n1270", "lz")):
        assert int(weights.max()) > 256


def test_a_cpu_call_loads_no_library(monkeypatch):
    def refuse():
        raise AssertionError("a CPU call loaded the kernels' library")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    h = _graph("n882").hx
    for v in (_batch(h.shape[1], 9, 0), _batch(h.shape[1], 9, 1).bool(), _batch(h.shape[1], 0, 2)):
        assert torch.equal(mod2_matmul(h, v), mod2_matmul_plain(h, v))
    assert _keys() == {} and obs.counter("gf2.launches") == 0


def _walk(h, v):
    """csrc/gf2mat.cu's algorithm in PyTorch: a tile of 32 samples; row c
    of v packed by a ballot of the values' low bits into word c, word n
    zero; a lane a row of a slice of 32, whose word is the XOR of the words
    its column table names; bit j of it sample j's int32, written only
    inside the batch."""
    slices, cols = row_lists(h)
    m, n = h.shape
    b = v.shape[1]
    tiles = -(-b // 32)
    bits = torch.zeros((n + 1, tiles * 32), dtype=torch.int64)
    bits[:n, :b] = v.to(torch.int64) & 1
    ballots = (bits.view(n + 1, tiles, 32) << torch.arange(32)).sum(dim=-1)  # [n + 1, tiles], bit j = lane j
    cols = cols.to(torch.int64) & 0xFFFF
    out = torch.full((m, tiles * 32), -1, dtype=torch.int32)
    lane = torch.arange(32)
    for t in range(-(-m // 32)):
        table = cols[slices[t]:slices[t + 1]].view(-1, 32)  # [width, 32 lanes]
        words = torch.zeros((32, tiles), dtype=torch.int64)
        for k in range(table.shape[0]):
            words ^= ballots[table[k]]
        rows = min(32, m - 32 * t)
        out[32 * t:32 * t + rows] = ((words[:rows, :, None] >> lane) & 1).reshape(rows, -1).to(torch.int32)
    assert torch.all(out[:, :b] >= 0)
    return out[:, :b]


@pytest.mark.parametrize("code,mat", MATRICES)
def test_the_kernels_algorithm_equals_plain(code, mat):
    """The walk on a ragged batch with an all-ones sample (row sums to 346)
    and on a single sample equals the plain version."""
    h = getattr(_graph(code), mat)
    v = _batch(h.shape[1], 77, 5)
    v[:, 40] = 1
    assert torch.equal(_walk(h, v), mod2_matmul_plain(h, v))
    assert torch.equal(_walk(h, v[:, 40:41]), mod2_matmul_plain(h, v[:, 40:41]))


@pytest.mark.parametrize("case", ["int32", "uint8", "bool", "int64", "column slice", "transposed"])
def test_the_launcher_hands_the_library_the_call(fake_library, case):
    """The card's branch with the library faked: v's pointer, row stride
    and element size (bool and uint8 as bytes; other dtypes converted to
    int32; a column slice read through its stride, a transposed batch made
    contiguous), the row lists, the shapes, the plan and the stream; its
    output and its count."""
    calls, _ = fake_library
    h = _graph("n882").hx
    m, n = h.shape
    full = _batch(n, 100, 7)
    v = {"int32": full, "uint8": full.to(torch.uint8), "bool": full.bool(), "int64": full.long(),
         "column slice": full[:, 10:60], "transposed": full.T.contiguous().T}[case]
    bsz = v.shape[1]
    out = mod2_matmul(_card(h), _card(v))
    (args,) = calls
    v_ptr, ld, elem, slices_ptr, cols_ptr, out_ptr, am, an, ab, stream = args
    size = {"uint8": 1, "bool": 1}.get(case, 4)
    assert elem == size and (am, an, ab, stream) == (m, n, bsz, 7)
    assert (v_ptr == v.data_ptr()) == (case in ("int32", "uint8", "bool", "column slice"))
    assert ld == (100 if case == "column slice" else bsz)
    assert slices_ptr != 0 and cols_ptr != 0
    assert out_ptr == out.data_ptr() and out.shape == (m, bsz) and out.dtype == torch.int32
    assert _keys() == {("kernel", m, n, bsz): 1}


def test_a_refused_launch_raises_and_counts_nothing(fake_library):
    calls, result = fake_library
    result[0] = -4
    h = _graph("n882").hz
    with pytest.raises(RuntimeError, match="refused"):
        mod2_matmul(_card(h), _card(_batch(h.shape[1], 8, 0)))
    assert len(calls) == 1 and _keys() == {}


@pytest.mark.parametrize("case", ["columns", "three axes", "one axis", "devices", "not 0/1", "too wide"])
def test_calls_the_kernel_cannot_take_raise_before_any_launch(fake_library, case):
    calls, _ = fake_library
    h, v = _graph("n882").hx, _batch(888, 8, 0)
    if case == "columns":
        h, v = _card(h), _card(v[1:])
    elif case == "three axes":
        h, v = _card(h), _card(v[None])
    elif case == "one axis":
        h, v = _card(h), _card(v[:, 0])
    elif case == "devices":
        h, v = h.to("meta"), _card(v)
    elif case == "not 0/1":
        h, v = _card(2 * h), _card(v)
    else:
        n = gf2mat.MAX_COLUMNS + 1
        h, v = _card(torch.zeros((1, n))), _card(torch.zeros((n, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        mod2_matmul(h, v)
    assert calls == [] and _keys() == {}


@pytest.mark.parametrize("m,n,b", [(448, 888, 0), (0, 888, 5), (3, 0, 5)])
def test_empty_products_launch_nothing(fake_library, m, n, b):
    calls, _ = fake_library
    out = mod2_matmul(_card(torch.ones((m, n))), _card(torch.ones((n, b), dtype=torch.int32)))
    assert out.shape == (m, b) and out.dtype == torch.int32 and not out.any()
    assert calls == [] and _keys() == {}


def test_the_row_lists_are_built_once_a_matrix_and_die_with_it(fake_library, monkeypatch):
    """A matrix's row lists are built at its first call, reused while it
    lives, rebuilt after an in-place write, kept apart for two views of
    one base, and dropped with the matrix."""
    built = []
    monkeypatch.setattr(gf2mat, "row_lists", lambda h: built.append(tuple(h.shape)) or row_lists(h))
    h = _card(_graph("n882").lz.clone())
    v = _card(_batch(h.shape[1], 8, 0))
    for _ in range(3):
        mod2_matmul(h, v)
    assert built == [(32, 888)]
    h[0, 0] = 1 - h[0, 0]  # in place: the version moves
    mod2_matmul(h, v)
    top = h[:8]
    mod2_matmul(top, v)
    mod2_matmul(top, v)
    assert built == [(32, 888)] * 2 + [(8, 888)] and len(gf2mat._ROWS) == 2
    del h, top
    gc.collect()
    assert gf2mat._ROWS == {}
