"""Where OSD-0 runs, checked on the CPU.

``osd0_decode`` runs CPU tensors on the plain version and counts nothing.
On a card it launches the kernel (csrc/osd0.cu) or raises for a shape the
kernel cannot take, and counts ``osd.launches`` keyed by path and batch.
The kernel runs only on a card (tests/test_torch_gpu.py holds it to the
plain version there); here: the plain path on CPU tensors, the card's
dispatch with the card faked (a CPU tensor whose ``is_cuda`` reads True,
the library faked), the arguments the launcher hands the library, the
shape check, the basis's column bit-vectors against NumPy's packbits, and
the kernel's algorithm walked in NumPy (its sort keys, its table built from
the column bit-vectors, forward elimination and back-substitution on
32-bit words) against the plain version bit for bit.  Imports no CUDA, no
triton and no JAX.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch import _build, obs
from feedback_gnn_tpu_torch.decoders import osd as osd_mod
from feedback_gnn_tpu_torch.decoders.osd import osd0_decode, osd0_decode_plain, pack_columns, shared_bytes

GB48 = (24, [0, 2, 8, 15], [0, 2, 12, 17])
CODES = {"gb48": lambda: tc.create_generalized_bicycle_codes(*GB48), "n882": tc.ghp_882_24,
         "n1270": tc.ghp_1270_28}
_BUILT = {}


@pytest.fixture(autouse=True)
def fresh_registry():
    torch.set_num_threads(1)  # several test workers share the cores
    obs.reset()
    yield
    obs.reset()


def _code(name):
    if name not in _BUILT:
        _BUILT[name] = CODES[name]()
    return _BUILT[name]


def _keys():
    return obs.snapshot()["keys"].get("osd.launches", {})


def _inputs(basis, b, seed, levels=(-0.0, 0.0, 1.5, -2.0)):
    """LLRs drawn from a few levels (±0.0 among them: mostly tied), or
    continuous for ``levels`` None, and the syndromes of random errors."""
    rank, n = basis.shape
    rng = np.random.default_rng(seed)
    if levels is None:
        llr = rng.normal(size=(b, n)).astype(np.float32)
    else:
        llr = np.asarray(levels, np.float32)[rng.integers(0, len(levels), (b, n))]
    syn = basis @ rng.integers(0, 2, (n, b)) % 2
    return torch.as_tensor(llr), torch.as_tensor(syn.astype(np.int32))


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a card's: ``osd0_decode`` takes the
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

    fake = types.SimpleNamespace(fgt_osd0_launch=launch, fgt_cuda_error_string=lambda err: b"refused")
    monkeypatch.setattr(_build, "load_kernels", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return calls, result


def test_cpu_tensors_take_the_plain_version_and_count_nothing(monkeypatch):
    basis = np.asarray(_code("gb48").hx_basis)
    llr, syn = _inputs(basis, 16, 0)
    out = osd0_decode(llr, basis, syn)
    plain = []
    monkeypatch.setattr(osd_mod, "osd0_decode_plain", lambda *a: plain.append(a) or osd0_decode_plain(*a))
    assert torch.equal(osd0_decode(llr, basis, syn), out) and len(plain) == 1
    assert out.dtype == torch.int32 and np.array_equal(basis @ out.numpy().T % 2, syn.numpy())
    assert _keys() == {} and obs.counter("osd.launches") == 0


@pytest.mark.parametrize("case", ["contiguous", "transposed", "int64 syndromes", "tensor basis", "refused"])
def test_the_launcher_hands_the_library_the_call(fake_library, case):
    """The card's branch with the library faked: the pointers, the basis's
    column words, the shapes and the stream it passes, its output, its
    count; a non-zero return raises, and counts nothing."""
    calls, result = fake_library
    basis = np.asarray(_code("gb48").hx_basis)
    rank, n = basis.shape
    llr, syn = _inputs(basis, 8, 1)
    if case == "transposed":  # models.py hands OSD the transpose of its [n, B] reliabilities
        llr = llr.T.contiguous().T
        assert not llr.is_contiguous()
    if case == "int64 syndromes":
        syn = syn.long()
    pcm = torch.as_tensor(basis) if case == "tensor basis" else basis
    if case == "refused":
        result[0] = 2
        with pytest.raises(RuntimeError, match="refused"):
            osd0_decode(_card(llr), pcm, syn)
        assert len(calls) == 1 and _keys() == {}
        return
    out = osd0_decode(_card(llr), pcm, syn)
    (args,) = calls
    llr_ptr, cols_ptr, groups, syn_ptr, out_ptr, batch, cols_n, cols_rank, stream = args
    assert (llr_ptr == llr.data_ptr()) == llr.is_contiguous()  # a copy only where it is not contiguous
    assert (syn_ptr == syn.data_ptr()) == (syn.dtype == torch.int32)
    assert groups == -(-rank // 32) and (batch, cols_n, cols_rank, stream) == (8, n, rank, 7)
    assert out_ptr == out.data_ptr() and out.shape == (8, n) and out.dtype == torch.int32
    assert cols_ptr != 0
    assert _keys() == {("kernel", 8): 1}


@pytest.mark.parametrize("name,rank,n,words,stride,blocks", [
    ("n882", 429, 882, 28, 29, 4),  # 429 x 29 words: 53 KB a block, 4 a 228-KB SM
    ("n1270", 621, 1270, 40, 41, 2),  # 621 x 41: 106 KB, 2 an SM
])
def test_the_shape_check_takes_the_paper_codes(name, rank, n, words, stride, blocks):
    basis = _code(name).hx_basis
    assert basis.shape == (rank, n) and (n + 32) // 32 == words and words | 1 == stride
    need = shared_bytes(rank, n)
    assert 4 * rank * stride < need <= osd_mod.SHARED_LIMIT
    assert need + 1024 <= 233472 // blocks  # the SM's 228 KB, 1 KB of it reserved a block
    osd_mod._check_shape(rank, n)


@pytest.mark.parametrize("rank,n,match", [
    (1400, 1270, "shared memory"),  # 1400 x 41 words: above 227 KB
    (600, 2048, "64 words"),  # 2049 columns with the syndrome's: 65 words
])
def test_the_shape_check_refuses_what_does_not_fit(fake_library, rank, n, match):
    calls, _ = fake_library
    with pytest.raises(ValueError, match=match):
        osd_mod._check_shape(rank, n)
    basis = np.zeros((rank, n), np.int32)  # refused before its content matters
    with pytest.raises(ValueError, match=match):
        osd0_decode(_card(torch.zeros((2, n))), basis, torch.zeros((rank, 2), dtype=torch.int32))
    assert calls == [] and _keys() == {}


@pytest.mark.parametrize("case", ["float64", "basis columns", "syndrome rows"])
def test_inputs_the_kernel_does_not_take_raise(fake_library, case):
    calls, _ = fake_library
    basis = np.asarray(_code("gb48").hx_basis)
    llr, syn = _inputs(basis, 4, 2)
    if case == "float64":
        llr = llr.double()
    elif case == "basis columns":
        basis = basis[:, 1:]
    else:
        syn = syn[1:]
    with pytest.raises(ValueError):
        osd0_decode(_card(llr), basis, syn)
    assert calls == [] and _keys() == {}


@pytest.mark.parametrize("name", ["n882", "n1270"])
@pytest.mark.parametrize("side", ["hx_basis", "hz_basis"])
def test_pack_columns_is_numpys_packbits(name, side):
    basis = np.asarray(getattr(_code(name), side))
    rank, n = basis.shape
    groups = -(-rank // 32)
    cols = np.zeros((n, 32 * groups), np.uint8)
    cols[:, :rank] = basis.T
    want = np.packbits(cols, axis=1, bitorder="little").view("<i4")
    got = pack_columns(torch.as_tensor(basis)).numpy()
    assert got.shape == (n, groups) and got.dtype == np.int32
    assert np.array_equal(got, want)


# ---- the kernel's algorithm, walked in NumPy ----------------------------------


def _sort_keys(llr):
    """csrc/osd0.cu's 64-bit keys of one sample: the float ordered as an
    unsigned integer (-0.0 as +0.0, NaN last) over the column."""
    u = llr.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    k = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    k = np.where((u & 0x7FFFFFFF) > 0x7F800000, 0xFFFFFFFF, k)
    return (k << np.uint64(32)) | np.arange(llr.size, dtype=np.uint64)


def _walk(llr, cols, syn, rank):
    """One sample through the kernel's phases: order, table from the
    column words, forward elimination, back-substitution, scatter."""
    n = llr.size
    words = (n + 32) // 32
    order = np.argsort(_sort_keys(llr))  # distinct keys: any sort gives the bitonic sort's order
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    rows = np.arange(rank)
    bits = np.zeros((rank, 32 * words), np.uint8)
    bits[:, :n] = (cols.view(np.uint32)[order][:, rows // 32] >> (rows % 32)).T & 1
    bits[:, n] = syn
    tab = np.packbits(bits, axis=1, bitorder="little").view("<u4").copy()  # [rank, words]
    piv = np.zeros(rank, np.int64)
    for r in range(rank):
        nz = np.flatnonzero(tab[r])
        wi = int(nz[0]) if nz.size else 0
        word = int(tab[r, wi])
        bit = (word & -word).bit_length() - 1 if word else 0
        piv[r] = 32 * wi + bit
        below = np.arange(r + 1, rank)
        hits = below[((tab[below, wi] >> np.uint32(bit)) & 1) == 1]
        tab[hits, wi:] ^= tab[r, wi:]
    x = np.zeros(words, np.uint32)
    x[n // 32] = 1 << (n % 32)
    for r in range(rank - 1, -1, -1):
        if int(np.bitwise_count(tab[r] & x).sum()) & 1:
            x[piv[r] // 32] |= np.uint32(1 << (piv[r] % 32))
    return ((x[inv // 32] >> (inv % 32).astype(np.uint32)) & 1).astype(np.int32)


def test_the_sort_keys_give_the_stable_order():
    v = np.asarray([0.0, -0.0, 1.0, np.nan, -np.inf, -0.0, np.inf, -1.0, np.nan, 1.0, 0.0, -1e-30], np.float32)
    want = torch.argsort(torch.as_tensor(v), stable=True).numpy()
    assert np.array_equal(np.argsort(_sort_keys(v)), want)


@pytest.mark.parametrize("name,b", [("gb48", 24), ("n882", 3)])
@pytest.mark.parametrize("side", ["hx_basis", "hz_basis"])
@pytest.mark.parametrize("levels", [(-0.0, 0.0, 1.5, -2.0), None], ids=["tied", "continuous"])
def test_the_kernels_algorithm_equals_the_plain_version(name, b, side, levels):
    basis = np.asarray(getattr(_code(name), side))
    rank, n = basis.shape
    llr, syn = _inputs(basis, b, 3, levels)
    want = osd0_decode_plain(llr, basis, syn).numpy()
    cols = pack_columns(torch.as_tensor(basis)).numpy()
    got = np.stack([_walk(llr[i].numpy(), cols, syn[:, i].numpy(), rank) for i in range(b)])
    assert np.array_equal(got, want)
