"""The port's bit-packed C++ GF(2) core (feedback_gnn_tpu_torch/native)
against the port's NumPy path and the JAX package's NumPy path
(``feedback_gnn_tpu.codes.gf2.row_echelon(use_native=False)``): echelon
form, rank, transform and pivots equal bit for bit.  Also the dispatch of
``codes.gf2.row_echelon`` at 64 x 64 entries, code construction with the
core on and off, four processes building into one empty directory at once,
and the refusal without a compiler.  Each builds in seconds with g++.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from feedback_gnn_tpu.codes import gf2 as jgf2

from feedback_gnn_tpu_torch import native
from feedback_gnn_tpu_torch import codes as tc
from feedback_gnn_tpu_torch.codes import css, gf2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_echelon(a, b):
    ech_a, rk_a, tf_a, piv_a = a
    ech_b, rk_b, tf_b, piv_b = b
    assert rk_a == rk_b
    assert list(piv_a) == list(piv_b)
    np.testing.assert_array_equal(ech_a, ech_b)
    np.testing.assert_array_equal(tf_a, tf_b)


def _three_ways(mat, reduced):
    """The core, the port's NumPy path and JAX's NumPy path agree, and the
    transform meets its contract."""
    out = native.row_echelon_native(mat, reduced)
    _same_echelon(out, gf2.row_echelon(mat, reduced, use_native=False))
    _same_echelon(out, jgf2.row_echelon(mat, reduced, use_native=False))
    np.testing.assert_array_equal(out[2] @ mat % 2, out[0])
    return out


@pytest.mark.parametrize("shape", [(8, 8), (40, 70), (70, 40), (129, 200)])
@pytest.mark.parametrize("reduced", [False, True])
def test_row_echelon_matches_both_numpy_paths(shape, reduced):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + int(reduced))
    _three_ways(rng.integers(0, 2, shape), reduced)


@pytest.mark.parametrize("reduced", [False, True])
def test_row_echelon_rank_deficient(reduced):
    """Zero rows, repeated rows and a column that only the swap reaches."""
    mat = np.zeros((6, 9), int)
    mat[0, 2] = mat[1, 2] = 1
    mat[3] = 1
    mat[5] = mat[3]
    mat[4, 0] = 1
    out = _three_ways(mat, reduced)
    assert out[1] == 3


@pytest.mark.parametrize("transpose", ["hx.T", "hz.T"])
@pytest.mark.parametrize("make", ["ghp_882_24", "ghp_1270_28"])
def test_row_echelon_on_paper_codes(make, transpose):
    """The paper codes' check matrices, transposed as kernel() takes them."""
    code = getattr(tc, make)()
    h = np.asarray(code.hx if transpose == "hx.T" else code.hz)
    _three_ways(h.T, reduced=False)


def test_gf2_matmul_native():
    rng = np.random.default_rng(7)
    for m, n, b in [(37, 130, 23), (1, 64, 1), (5, 200, 65)]:
        h, v = rng.integers(0, 2, (m, n)), rng.integers(0, 2, (n, b))
        out = native.gf2_matmul_native(h, v)
        assert out.shape == (m, b)
        np.testing.assert_array_equal(out, h @ v % 2)
    with pytest.raises(ValueError):
        native.gf2_matmul_native(np.ones((2, 3), int), np.ones((4, 1), int))


def test_construction_with_the_core_on_and_off(monkeypatch):
    """ghp_882_24() built through the core and through NumPy alone: equal
    matrices and logicals."""
    on = tc.ghp_882_24()
    numpy_path = gf2.row_echelon

    def numpy_only(mat, reduced=False, use_native=True):
        return numpy_path(mat, reduced, use_native=False)

    calls = []
    monkeypatch.setattr(native, "row_echelon_native", lambda *a, **k: calls.append(1))
    monkeypatch.setattr(gf2, "row_echelon", numpy_only)
    monkeypatch.setattr(css, "row_echelon", numpy_only)
    off = tc.ghp_882_24()
    assert not calls
    for name in ("hx", "hz", "lx", "lz"):
        np.testing.assert_array_equal(np.asarray(getattr(on, name)), np.asarray(getattr(off, name)), name)
    assert (on.N, on.K) == (off.N, off.K) == (882, 24)


def test_dispatch_at_64_by_64(monkeypatch):
    """row_echelon hands a 64 x 64 matrix to the core and keeps a 63 x 64
    one, and any size with use_native=False, on the NumPy path."""
    calls = []
    core = native.row_echelon_native

    def counting(mat, reduced=False):
        calls.append(mat.shape)
        return core(mat, reduced)

    monkeypatch.setattr(native, "row_echelon_native", counting)
    rng = np.random.default_rng(3)
    for shape in [(64, 64), (63, 64), (32, 128), (128, 128)]:
        mat = rng.integers(0, 2, shape)
        _same_echelon(gf2.row_echelon(mat), jgf2.row_echelon(mat, use_native=False))
        gf2.row_echelon(mat, use_native=False)
    assert calls == [(64, 64), (32, 128), (128, 128)]


def test_concurrent_builds_agree(tmp_path):
    """Four processes build into one empty directory at once; each loads
    the library and gets the same echelon form."""
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        sys.path.insert(0, {REPO!r})
        from feedback_gnn_tpu_torch import native
        lib = native.load({str(tmp_path)!r})
        mat = np.random.default_rng(5).integers(0, 2, (96, 160))
        ech, rank, tf, piv = native.row_echelon_native(mat, True, lib=lib)
        print(rank, int(ech.sum()), int(tf.sum()), sum(piv))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out for out, _ in outs}) == 1
    ref = gf2.row_echelon(np.random.default_rng(5).integers(0, 2, (96, 160)), True, use_native=False)
    assert outs[0][0].split() == [str(v) for v in (ref[1], ref[0].sum(), ref[2].sum(), sum(ref[3]))]
    assert os.listdir(tmp_path) == [os.path.basename(native.library_path(str(tmp_path)))]


def test_no_compiler_raises(tmp_path, monkeypatch):
    """No compiler: RuntimeError, nothing quietly falls back; a compiler
    that fails: RuntimeError with its output."""
    monkeypatch.setattr(native, "CXX", "no-such-compiler-gf2")
    with pytest.raises(RuntimeError, match="no-such-compiler-gf2"):
        native.build(str(tmp_path / "a"))
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O3", "-shared", "-fPIC", "-no-such-flag-gf2"))
    with pytest.raises(RuntimeError, match="no-such-flag-gf2"):
        native.build(str(tmp_path / "b"))
    assert not os.listdir(tmp_path / "b")
